"""BVH stream traversal: the record table, the CUDA kernels in
csrc/bvh_stream.cu and their plain PyTorch versions.

Replaces the TPU kernels of grail/kernels/bvh_stream.py: `_make_kernel`
(ordered, near-child-first with a right-child stack) and `_make_skip_kernel`
(stackless, through skip links), each in a closest-hit and an any-hit form.
The TPU kernels stream one record per 128-ray sub-packet; here each ray is
one CUDA thread that walks the same record table on its own (see the note in
the CUDA source for what bounds it and what the design does about it).

Record table (the reference's layout, so one table feeds both packages):
16 f32 fields per record (64 B), 8 records per (128,) row, 11 fields used:
  box: f0..2 bmin, f3..5 bmax, f9 = right_child_record*8 + split_axis
  tri: f0..8 v0|e1|e2,          f9 = prim_id*8 + 4 + (run continues)
  both: f10 = skip link, the first record after this record's subtree
        (-1 past the end): the preorder successor on a miss.
Records are in DFS preorder: a box's left child starts at id+1. Interior
nodes emit box records; leaves emit only their triangle records.

`stream_traverse` takes the plain version only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

FIELDS = 16
RECS_PER_ROW = 8
STACK = 64            # right-child stack of the ordered kernel (csrc kStack)
BIG_T = 3.0e37
META_LIMIT = 1 << 24  # meta words are exact in f32 below this

KERNELS = ("skip_closest", "skip_any_hit", "ordered_closest", "ordered_any_hit")

# Launches of each CUDA kernel in this process (plain-version calls excluded).
LAUNCHES = dict.fromkeys(KERNELS, 0)


def kernel_name(kind, any_hit):
    return f"{kind}_{'any_hit' if any_hit else 'closest'}"


# --------------------------------------------------------------------------
# host-side packer: flattened binary BVH -> preorder record stream
# --------------------------------------------------------------------------

def _concat_arange(counts):
    """[a,b,c] -> [0..a-1, 0..b-1, 0..c-1]."""
    total = int(counts.sum())
    starts = np.repeat(np.cumsum(counts) - counts, counts)
    return np.arange(total, dtype=np.int64) - starts


def build_stream_records(bvh, tris9_ordered):
    """(R,11) float32 records from a flattened BVH (the layout of grail_torch/native).
    tris9_ordered: (T,9) [v0|e1|e2] in leaf order (re-ordered by
    bvh["prim_ids"]). R = #interior nodes + T."""
    right = np.asarray(bvh["right"], np.int64)
    nprims = np.asarray(bvh["nprims"], np.int64)
    prim_off = np.asarray(bvh["prim_off"], np.int64)
    prim_ids = np.asarray(bvh["prim_ids"], np.int64)
    axis = np.asarray(bvh["axis"], np.int64)
    n = right.shape[0]
    T = prim_ids.shape[0]
    leaf = nprims > 0

    # record id of node i = (#interior before i) + (#tris before i)
    interior = (~leaf).astype(np.int64)
    start = (np.cumsum(interior) - interior) + (np.cumsum(nprims) - nprims)
    total = int(interior.sum()) + T

    # skip link per node: DFS carrying "next after my subtree" down (left
    # child's = right child's start, right child's = parent's)
    skip = np.full(n, -1, np.int64)
    stack = [(0, -1)]
    while stack:
        i, s = stack.pop()
        skip[i] = s
        if not leaf[i]:
            r = right[i]
            stack.append((int(r), s))
            stack.append((i + 1, int(start[r])))

    ii = np.where(~leaf)[0]
    box_meta = start[right[ii]] * 8 + axis[ii]
    li = np.where(leaf)[0]
    cnt = nprims[li]
    k = _concat_arange(cnt)
    pos = np.repeat(start[li], cnt) + k
    src = np.repeat(prim_off[li], cnt) + k
    more = (k < np.repeat(cnt - 1, cnt)).astype(np.int64)
    tri_meta = prim_ids[src] * 8 + 4 + more
    top = max(int(box_meta.max(initial=0)), int(tri_meta.max(initial=0)), total)
    if top >= META_LIMIT:
        raise ValueError(f"record meta {top} is not exact in float32 "
                         f"(limit {META_LIMIT})")

    recs = np.zeros((total, 11), np.float32)
    recs[start[ii], 0:3] = np.asarray(bvh["bounds_min"], np.float32)[ii]
    recs[start[ii], 3:6] = np.asarray(bvh["bounds_max"], np.float32)[ii]
    recs[start[ii], 9] = box_meta.astype(np.float32)
    recs[start[ii], 10] = skip[ii].astype(np.float32)
    recs[pos, 0:9] = np.asarray(tris9_ordered, np.float32)[src]
    recs[pos, 9] = tri_meta.astype(np.float32)
    recs[pos, 10] = np.repeat(skip[li], cnt).astype(np.float32)
    return recs


def pack_record_rows(recs):
    """(R,11) -> (ceil(R/8), 128) row-packed table (records padded to 16)."""
    R = recs.shape[0]
    recs = np.pad(np.asarray(recs, np.float32),
                  ((0, -R % RECS_PER_ROW), (0, FIELDS - recs.shape[1])))
    return recs.reshape(-1, RECS_PER_ROW * FIELDS)


def build_stream_table(bvh_np, verts_np, tri_idx_np):
    """numpy BVH + geometry -> packed (rows, 128) float32 table."""
    verts = np.asarray(verts_np, np.float32)
    idx = np.asarray(tri_idx_np, np.int64)
    v0 = verts[idx[:, 0]]
    tris9 = np.concatenate([v0, verts[idx[:, 1]] - v0, verts[idx[:, 2]] - v0],
                           axis=1)
    ordered = tris9[np.asarray(bvh_np["prim_ids"], np.int64)]
    return pack_record_rows(build_stream_records(bvh_np, ordered))


def tree_depth(bvh):
    """Most interior nodes on any root-to-leaf path: the most entries the
    ordered traversal's right-child stack ever holds."""
    right = np.asarray(bvh["right"]).tolist()
    leaf = (np.asarray(bvh["nprims"]) > 0).tolist()
    depth = [0] * len(right)        # interior nodes strictly above node i
    best = 0
    for i in range(len(right)):     # preorder: parents come before children
        if not leaf[i]:
            depth[i + 1] = depth[right[i]] = depth[i] + 1
            best = max(best, depth[i] + 1)
    return best


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _inv_dir(d):
    """1/d with |d| clamped at 1e-20 (the reference's slab-test inverse)."""
    return 1.0 / torch.where(torch.abs(d) < 1e-20,
                             torch.where(d < 0, -1e-20, 1e-20), d)


def stream_traverse_plain(table, o, d, tmin, tmax, any_hit=False, kind="skip"):
    """The kernels' per-ray walk, vectorized over the rays still walking:
    each step reads one record per live ray with the kernel's arithmetic and
    conditions, in the same per-ray visit order, and drops rays that finish.

    Returns (t, prim, b1, b2, n_box, n_tri): t = tmax, prim = -1, b1 = b2 = 0
    on a miss; an any-hit ray stops at its first hit with t = -3e37 and that
    hit's prim, b1, b2. n_box, n_tri (int64) count the box and triangle
    records each ray visited."""
    if kind not in ("skip", "ordered"):
        raise ValueError(f"unknown traversal kind {kind!r}")
    recs = table.reshape(-1, FIELDS)
    dev = o.device
    n = o.shape[0]
    t_out = tmax.clone()
    prim_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    b1_out = torch.zeros(n, dtype=torch.float32, device=dev)
    b2_out = torch.zeros_like(b1_out)
    nbox_out = torch.zeros(n, dtype=torch.int64, device=dev)
    ntri_out = torch.zeros_like(nbox_out)

    ordered = kind == "ordered"
    st = {"lane": torch.arange(n, device=dev),
          "id": torch.zeros(n, dtype=torch.int64, device=dev),
          "o": o, "d": d, "inv": _inv_dir(d), "tmin": tmin, "t": tmax.clone(),
          "prim": prim_out.clone(), "b1": b1_out.clone(), "b2": b2_out.clone(),
          "nbox": nbox_out.clone(), "ntri": ntri_out.clone()}
    if ordered:
        st["sp"] = torch.zeros(n, dtype=torch.int64, device=dev)
        st["stack"] = torch.zeros((n, STACK), dtype=torch.int64, device=dev)

    while st["lane"].numel():
        idx = st["id"]
        v = recs[idx].unbind(-1)
        ox, oy, oz = st["o"].unbind(-1)
        dx, dy, dz = st["d"].unbind(-1)
        ix, iy, iz = st["inv"].unbind(-1)
        t_min, t_best = st["tmin"], st["t"]

        # box view: slab test
        tx0 = (v[0] - ox) * ix
        tx1 = (v[3] - ox) * ix
        ty0 = (v[1] - oy) * iy
        ty1 = (v[4] - oy) * iy
        tz0 = (v[2] - oz) * iz
        tz1 = (v[5] - oz) * iz
        near = torch.maximum(torch.maximum(torch.minimum(tx0, tx1),
                                           torch.minimum(ty0, ty1)),
                             torch.minimum(tz0, tz1))
        far = torch.minimum(torch.minimum(torch.maximum(tx0, tx1),
                                          torch.maximum(ty0, ty1)),
                             torch.maximum(tz0, tz1)) * 1.0000004
        box_hit = (near <= far) & (far > t_min) & (near < t_best)

        # triangle view: Möller-Trumbore
        s1x = dy * v[8] - dz * v[7]
        s1y = dz * v[6] - dx * v[8]
        s1z = dx * v[7] - dy * v[6]
        divisor = s1x * v[3] + s1y * v[4] + s1z * v[5]
        dinv = 1.0 / torch.where(divisor == 0.0, 1.0, divisor)
        sx = ox - v[0]
        sy = oy - v[1]
        sz = oz - v[2]
        b1 = (sx * s1x + sy * s1y + sz * s1z) * dinv
        s2x = sy * v[5] - sz * v[4]
        s2y = sz * v[3] - sx * v[5]
        s2z = sx * v[4] - sy * v[3]
        b2 = (dx * s2x + dy * s2y + dz * s2z) * dinv
        t = (v[6] * s2x + v[7] * s2y + v[8] * s2z) * dinv
        tri_hit = ((divisor != 0.0) & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0)
                   & (b1 + b2 <= 1.0) & (t > t_min) & (t < t_best))

        m = v[9].to(torch.int64)
        is_tri = (m & 4) > 0
        upd = tri_hit & is_tri
        st["t"] = torch.where(upd, -BIG_T if any_hit else t, t_best)
        st["prim"] = torch.where(upd, (m >> 3).to(torch.int32), st["prim"])
        st["b1"] = torch.where(upd, b1, st["b1"])
        st["b2"] = torch.where(upd, b2, st["b2"])
        st["nbox"] = st["nbox"] + (~is_tri).to(torch.int64)
        st["ntri"] = st["ntri"] + is_tri.to(torch.int64)

        more = is_tri & ((m & 1) > 0)
        if ordered:
            descend = ~is_tri & box_hit
            ax = (m & 3).clamp_max(2)
            near_right = torch.gather(st["d"], 1, ax[:, None])[:, 0] < 0
            right = m >> 3
            sp, stack = st["sp"], st["stack"]
            pop = ~descend & ~more
            popped = torch.gather(stack, 1, (sp - 1).clamp_min(0)[:, None])[:, 0]
            rows = torch.nonzero(descend)[:, 0]
            stack[rows, sp[rows]] = torch.where(near_right, idx + 1, right)[rows]
            nxt = torch.where(descend, torch.where(near_right, right, idx + 1),
                              torch.where(more, idx + 1,
                                          torch.where(sp > 0, popped, -1)))
            st["sp"] = torch.where(descend, sp + 1,
                                   torch.where(pop, (sp - 1).clamp_min(0), sp))
        else:
            nxt = torch.where(more | (~is_tri & box_hit), idx + 1,
                              v[10].to(torch.int64))
        if any_hit:
            nxt = torch.where(upd, -1, nxt)
        st["id"] = nxt

        live = nxt >= 0
        if bool(live.all()):
            continue
        done = st["lane"][~live]
        for out, key in ((t_out, "t"), (prim_out, "prim"), (b1_out, "b1"),
                         (b2_out, "b2"), (nbox_out, "nbox"), (ntri_out, "ntri")):
            out[done] = st[key][~live]
        st = {k: a[live] for k, a in st.items()}
    return t_out, prim_out, b1_out, b2_out, nbox_out, ntri_out


# --------------------------------------------------------------------------
# CUDA kernels
# --------------------------------------------------------------------------

def _launcher():
    """The C entry point of the built library, with its signature declared
    (pointers and the stream as c_void_p, so none is cut to 32 bits)."""
    fn = build.load("bvh_stream").grail_bvh_stream
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(table, o, d, tmin, tmax):
    n = o.shape[0]
    build.check_operands({"table": (table, (table.shape[0], RECS_PER_ROW * FIELDS)),
                          "o": (o, (n, 3)), "d": (d, (n, 3)), "tmin": (tmin, (n,)),
                          "tmax": (tmax, (n,))}, o.device)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned (the kernel reads float4)")
    if table.shape[0] * RECS_PER_ROW >= META_LIMIT or n >= 2**31:
        raise ValueError("table or ray batch too large for one launch")


def stream_traverse(table, o, d, tmin, tmax, any_hit=False, kind="skip",
                    depth=None):
    """Closest hit (or any hit) of each ray through the record table with
    the `kind` traversal ("skip" or "ordered"). depth: the tree depth
    (tree_depth), required by the ordered kernel, whose stack holds STACK
    entries. Returns (t, prim, b1, b2) as stream_traverse_plain."""
    if kind not in ("skip", "ordered"):
        raise ValueError(f"unknown traversal kind {kind!r}")
    if kind == "ordered" and (depth is None or depth > STACK):
        raise ValueError(f"tree depth {depth} does not fit the ordered "
                         f"traversal's {STACK}-entry stack")
    if o.device.type == "cpu":
        return stream_traverse_plain(table, o, d, tmin, tmax, any_hit, kind)[:4]
    if o.device.type != "cuda":
        raise ValueError(f"stream_traverse runs on cuda or cpu, not {o.device}")
    _check(table, o, d, tmin, tmax)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    b1 = torch.empty_like(t)
    b2 = torch.empty_like(t)
    if n == 0:
        return t, prim, b1, b2
    fn = _launcher()
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(table.data_ptr(), table.shape[0] * RECS_PER_ROW, o.data_ptr(),
                 d.data_ptr(), tmin.data_ptr(), tmax.data_ptr(), t.data_ptr(),
                 prim.data_ptr(), b1.data_ptr(), b2.data_ptr(), n, int(any_hit),
                 int(kind == "ordered"), stream)
    if err != 0:
        raise RuntimeError(f"bvh_stream kernel launch failed (CUDA error {err})")
    LAUNCHES[kernel_name(kind, any_hit)] += 1
    return t, prim, b1, b2
