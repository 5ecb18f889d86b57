"""4-wide BVH traversal: the node and triangle tables, the CUDA kernels in
csrc/bvh4.cu and their plain PyTorch version.

On the main path these replace the TPU kernels of grail/kernels/bvh_stream.py
`_make_kernel(False)` (ordered closest hit, every binned closest-hit wave),
`_make_skip_kernel(False)` (skip-link closest hit, the tile-ordered camera
wave) and `_make_skip_kernel(True)` (skip-link any hit, every shadow wave);
the note in the CUDA source says what bounds them on the H100 and what the
design does about it. Given a root per ray (`roots`), the same walk is the
instanced BLAS walk (kernels/instanced.py): the Hopper form of those
kernels' per-stream start records (`starts_ref`, bvh_stream.py:270, :424),
a root per 128-ray stream there, a root per ray into one table that holds
every object's BLAS here (build_bvh4_blas).

Tables, built on the host from the binary SAH tree (native.collapse_bvh4):
  nodes (N4, 32) float32, 128 B a node, SoA over 4 slots: lo.x lo.y lo.z
        hi.x hi.y hi.z of each slot, then child[4] and count[4] as int32
        bits (a node: its index and count 0; a leaf: ~its first triangle
        and its triangle count; an empty slot: lo = hi = +inf, child -1,
        count 0);
  tris  (T, 12) float32 in leaf order: v0, prim id, e1, 0, e2, more, with
        the prim id as int32 bits (not limited to the 2^24 of a float word)
        and more = 1 (int32 bits) where the next triangle is in the same
        leaf;
  stack the most entries a walk's stack holds (STACK_MAX at most).

The walk, per ray, from node 0 or the ray's root: the item in hand is a
node (ref >= 0) or a leaf whose first triangle is ~ref. A node's hit
children are taken near first, sorted on (entry distance, slot), so ties go
in slot order; the nearest is the next item and the others are pushed
farthest first. A leaf's triangles are tested
in order up to the one without `more`. An exhausted item pops the stack; an
empty stack ends the walk, and so does any hit's first hit. `bvh4_traverse`
takes the plain version only for tensors that lie on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import telemetry
from ..native import collapse_bvh4
from . import build

WIDTH = 4
NODE_WORDS = 32
TRI_WORDS = 12
STACK_MAX = 64      # csrc kStackMax: 64 ints x 128 threads = 32 KB a block
BIG_T = 3.0e37
# the sorting network on (entry distance, slot) pairs, as in the kernel
_NETWORK = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))

KERNELS = ("bvh4_closest", "bvh4_any_hit")
# the same kernels given a root per ray (the instanced BLAS walk), counted
# apart so that a render's counts show the two walks apart
ROOT_KERNELS = ("bvh4_closest_roots", "bvh4_any_hit_roots")

# Launches of each CUDA kernel in this process (plain-version calls excluded).
LAUNCHES = dict.fromkeys(KERNELS + ROOT_KERNELS, 0)


def _tri_rows(bvh, verts, tri_idx):
    """The (T, 12) triangle table of a binary BVH in leaf order; its prim ids
    are the tree's prim_ids, rows of tri_idx."""
    verts = np.asarray(verts, np.float32)
    prim = np.asarray(bvh["prim_ids"], np.int64)
    idx = np.asarray(tri_idx, np.int64)[prim]
    v0 = verts[idx[:, 0]]
    nprims = np.asarray(bvh["nprims"], np.int64)
    last = (np.asarray(bvh["prim_off"], np.int64) + nprims - 1)[nprims > 0]
    more = np.ones(prim.shape[0], np.int32)
    more[last] = 0
    tris = np.zeros((prim.shape[0], TRI_WORDS), np.float32)
    tris[:, 0:3] = v0
    tris[:, 3] = prim.astype(np.int32).view(np.float32)
    tris[:, 4:7] = verts[idx[:, 1]] - v0
    tris[:, 8:11] = verts[idx[:, 2]] - v0
    tris[:, 11] = more.view(np.float32)
    return tris


def build_bvh4_tables(bvh, verts, tri_idx):
    """(nodes (N4, 32), tris (T, 12), stack) numpy tables from a binary BVH
    (the native builder's layout, or the reference's) and its geometry."""
    nodes, stack = collapse_bvh4(bvh)
    return nodes, _tri_rows(bvh, verts, tri_idx), stack


def build_bvh4_blas(trees, verts, tri_idx):
    """One node table and one triangle table that hold the 4-wide BLAS of
    every object, each collapsed from its own binary tree (whose prim_ids are
    rows of the global tri_idx, so the triangle rows carry global prim ids).

    Returns (nodes, tris, roots, stack): roots[k] is object k's first item
    for the walk's `roots` argument: its root node, or the leaf ref ~first
    where its tree is a single leaf (no node is stored for it); stack is the
    largest stack bound of the objects. Child refs are rebased by the
    object's node offset, leaf refs by its triangle offset."""
    all_nodes, all_tris, roots = [], [], []
    n_nodes = n_tris = stack = 0
    for tree in trees:
        nodes, tris, st = build_bvh4_tables(tree, verts, tri_idx)
        child = nodes[:, 24:28].view(np.int32)
        count = nodes[:, 28:32].view(np.int32)
        leaf = count > 0
        child[:] = np.where(leaf, child - n_tris,
                            np.where(child >= 0, child + n_nodes, child))
        if len(nodes) == 1 and leaf[0].sum() == 1:
            roots.append(int(child[0, 0]))       # a single leaf: ~first
        else:
            roots.append(n_nodes)
            all_nodes.append(nodes)
            n_nodes += len(nodes)
        all_tris.append(tris)
        n_tris += len(tris)
        stack = max(stack, st)
    nodes = (np.concatenate(all_nodes) if all_nodes
             else np.zeros((0, NODE_WORDS), np.float32))
    return nodes, np.concatenate(all_tris), np.asarray(roots, np.int32), stack


# --------------------------------------------------------------------------
# plain version
# --------------------------------------------------------------------------

def _inv_dir(d):
    """1/d with |d| clamped at 1e-20 (the reference's slab-test inverse)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-20,
                             torch.where(d < 0, -1e-20, 1e-20), d)


def bvh4_traverse_plain(nodes, tris, o, d, tmin, tmax, any_hit=False, *, stack,
                        roots=None):
    """The kernel's per-ray walk, vectorized over the rays still walking:
    each step takes one item per live ray (one node, or one triangle of a
    leaf) with the kernel's arithmetic, conditions and visit order, and
    drops rays that finish. Raises if a walk needs more than `stack`
    entries. roots: optional (N,) int32, each ray's first item (a node
    index, or ~first triangle of a leaf) in place of node 0.

    Returns (t, prim, b1, b2, n_node, n_box_test, n_tri): t = tmax,
    prim = -1, b1 = b2 = 0 on a miss; an any-hit ray stops at its first hit
    with t = -3e37 and that hit's prim, b1, b2. n_node, n_box_test, n_tri
    (int64) count the node fetches, slab tests and triangle tests of each
    ray."""
    dev = o.device
    n = o.shape[0]
    node_int = nodes.view(torch.int32)
    tri_int = tris.view(torch.int32)
    t_out = tmax.clone()
    prim_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    b1_out = torch.zeros(n, dtype=torch.float32, device=dev)
    b2_out = torch.zeros_like(b1_out)
    node_out = torch.zeros(n, dtype=torch.int64, device=dev)
    tri_out = torch.zeros_like(node_out)
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    first = zero if roots is None else roots.to(torch.int64)
    st = {"lane": torch.arange(n, device=dev), "ref": first, "sp": zero,
          "stack": torch.zeros((n, max(stack, 1)), dtype=torch.int64, device=dev),
          "o": o, "d": d, "inv": _inv_dir(d), "tmin": tmin, "t": tmax.clone(),
          "prim": prim_out.clone(), "b1": b1_out.clone(), "b2": b2_out.clone(),
          "n_node": zero, "n_tri": zero}
    slots = torch.arange(WIDTH, device=dev)

    while st["lane"].numel():
        m = st["lane"].numel()
        rows = torch.arange(m, device=dev)
        ref, sp = st["ref"], st["sp"]
        is_node = ref >= 0
        t_min, t_best = st["tmin"], st["t"]
        ox, oy, oz = st["o"].unbind(-1)
        dx, dy, dz = st["d"].unbind(-1)

        # node view: 4 slab tests, hit children sorted on (near, slot)
        nid = torch.where(is_node, ref, 0)
        box = nodes[nid, :6 * WIDTH].reshape(m, 6, WIDTH)
        oo = st["o"][:, :, None]
        inv = st["inv"][:, :, None]
        t0 = (box[:, 0:3] - oo) * inv
        t1 = (box[:, 3:6] - oo) * inv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2]) * 1.0000004
        hit = (near <= far) & (far > t_min[:, None]) & (near < t_best[:, None])
        hits = hit.sum(1)
        key = list(torch.where(hit, near, torch.inf).unbind(1))
        slot = list(slots.expand(m, WIDTH).unbind(1))
        for a, b in _NETWORK:
            swap = (key[b] < key[a]) | ((key[b] == key[a]) & (slot[b] < slot[a]))
            key[a], key[b] = torch.where(swap, key[b], key[a]), torch.where(swap, key[a], key[b])
            slot[a], slot[b] = (torch.where(swap, slot[b], slot[a]),
                                torch.where(swap, slot[a], slot[b]))
        child = node_int[nid, 6 * WIDTH:7 * WIDTH].to(torch.int64)
        push = is_node & (hits > 1)
        top = sp + torch.where(push, hits - 1, 0)
        if bool((top > stack).any()):
            raise ValueError(f"a walk needs {int(top.max())} stack entries, "
                             f"more than the {stack} given")
        for j in (3, 2, 1):          # farthest first: the second nearest on top
            on = push & (hits > j)
            r = rows[on]
            st["stack"][r, sp[r]] = child[r, slot[j][r]]
            sp = sp + on.to(torch.int64)

        # triangle view: Möller-Trumbore on the leaf's next triangle
        tid = torch.where(is_node, 0, ~ref)
        v = tris[tid].unbind(-1)
        s1x = dy * v[10] - dz * v[9]
        s1y = dz * v[8] - dx * v[10]
        s1z = dx * v[9] - dy * v[8]
        divisor = s1x * v[4] + s1y * v[5] + s1z * v[6]
        dinv = 1.0 / torch.where(divisor == 0.0, 1.0, divisor)
        sx = ox - v[0]
        sy = oy - v[1]
        sz = oz - v[2]
        b1 = (sx * s1x + sy * s1y + sz * s1z) * dinv
        s2x = sy * v[6] - sz * v[5]
        s2y = sz * v[4] - sx * v[6]
        s2z = sx * v[5] - sy * v[4]
        b2 = (dx * s2x + dy * s2y + dz * s2z) * dinv
        t = (v[8] * s2x + v[9] * s2y + v[10] * s2z) * dinv
        upd = ((divisor != 0.0) & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0)
               & (b1 + b2 <= 1.0) & (t > t_min) & (t < t_best) & ~is_node)
        st["t"] = torch.where(upd, -BIG_T if any_hit else t, t_best)
        st["prim"] = torch.where(upd, tri_int[tid, 3], st["prim"])
        st["b1"] = torch.where(upd, b1, st["b1"])
        st["b2"] = torch.where(upd, b2, st["b2"])
        st["n_node"] = st["n_node"] + is_node.to(torch.int64)
        st["n_tri"] = st["n_tri"] + (~is_node).to(torch.int64)

        # next item: the nearest hit child, the leaf's next triangle, or a pop
        descend = is_node & (hits > 0)
        more = ~is_node & ((tri_int[tid, 11] & 1) > 0)
        pop = ~descend & ~more
        popped = torch.gather(st["stack"], 1, (sp - 1).clamp_min(0)[:, None])[:, 0]
        nearest = torch.gather(child, 1, slot[0][:, None])[:, 0]
        st["ref"] = torch.where(descend, nearest, torch.where(more, ref - 1, popped))
        live = ~(pop & (sp == 0))
        if any_hit:
            live &= ~upd
        st["sp"] = torch.where(pop, (sp - 1).clamp_min(0), sp)

        if bool(live.all()):
            continue
        done = st["lane"][~live]
        for out, name in ((t_out, "t"), (prim_out, "prim"), (b1_out, "b1"),
                          (b2_out, "b2"), (node_out, "n_node"), (tri_out, "n_tri")):
            out[done] = st[name][~live]
        st = {k: a[live] for k, a in st.items()}
    return t_out, prim_out, b1_out, b2_out, node_out, WIDTH * node_out, tri_out


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

def _library():
    """The built library with its C signatures declared (pointers and the
    stream as c_void_p, so none is cut to 32 bits)."""
    lib = build.load("bvh4")
    lib.grail_bvh4.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                               + [ctypes.c_void_p, ctypes.c_void_p])
    lib.grail_bvh4.restype = ctypes.c_int
    lib.grail_bvh4_fill_blocks.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_int)]
    lib.grail_bvh4_fill_blocks.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def fill_blocks(device_index, any_hit, stack):
    """Blocks that fill the card at once: SMs x resident blocks of the
    kernel with this stack depth."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _library().grail_bvh4_fill_blocks(int(any_hit), max(stack, 1),
                                                ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"bvh4 occupancy query failed (CUDA error {err})")
    return blocks.value


def _check(nodes, tris, o, d, tmin, tmax, roots):
    n = o.shape[0]
    build.check_operands({"nodes": (nodes, (nodes.shape[0], NODE_WORDS)),
                          "tris": (tris, (tris.shape[0], TRI_WORDS)),
                          "o": (o, (n, 3)), "d": (d, (n, 3)), "tmin": (tmin, (n,)),
                          "tmax": (tmax, (n,))}, o.device)
    if roots is not None and (roots.device != o.device or roots.dtype != torch.int32
                              or tuple(roots.shape) != (n,) or not roots.is_contiguous()):
        raise ValueError(f"roots must be a contiguous int32 ({n},) tensor on "
                         f"{o.device}, got {roots.dtype} {tuple(roots.shape)} on "
                         f"{roots.device}")
    if nodes.data_ptr() % 128 or tris.data_ptr() % 16:
        raise ValueError("nodes must be 128-byte and tris 16-byte aligned "
                         "(the kernel reads one 128-byte line a node, in float4)")
    if n >= 2**30:
        raise ValueError("ray batch too large for one launch")


@telemetry.spanned("launch/bvh4")
def bvh4_traverse(nodes, tris, o, d, tmin, tmax, any_hit=False, *, stack,
                  roots=None):
    """Closest hit (or any hit) of each ray through the 4-wide tables.
    stack: the tables' stack bound (build_bvh4_tables), at most STACK_MAX.
    roots: optional (N,) int32 first item of each ray (build_bvh4_blas),
    node 0 without. Returns (t, prim, b1, b2) as bvh4_traverse_plain. On the
    card, one launch of fill_blocks blocks of persistent warps."""
    if not 0 <= stack <= STACK_MAX:
        raise ValueError(f"the tree's stack bound {stack} does not fit the "
                         f"kernel's {STACK_MAX}-entry stack")
    if o.device.type == "cpu":
        return bvh4_traverse_plain(nodes, tris, o, d, tmin, tmax, any_hit,
                                   stack=stack, roots=roots)[:4]
    if o.device.type != "cuda":
        raise ValueError(f"bvh4_traverse runs on cuda or cpu, not {o.device}")
    _check(nodes, tris, o, d, tmin, tmax, roots)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    b1 = torch.empty_like(t)
    b2 = torch.empty_like(t)
    if n == 0:
        return t, prim, b1, b2
    blocks = fill_blocks(o.device.index, any_hit, stack)
    counter = torch.zeros(1, dtype=torch.int32, device=o.device)
    lib = _library()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grail_bvh4(nodes.data_ptr(), tris.data_ptr(), o.data_ptr(),
                             d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(),
                             None if roots is None else roots.data_ptr(),
                             t.data_ptr(), prim.data_ptr(), b1.data_ptr(),
                             b2.data_ptr(), n, int(any_hit), max(stack, 1), blocks,
                             counter.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bvh4 kernel launch failed (CUDA error {err})")
    LAUNCHES[(KERNELS if roots is None else ROOT_KERNELS)[int(any_hit)]] += 1
    return t, prim, b1, b2
