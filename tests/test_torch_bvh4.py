"""The port's 4-wide BVH route against grail's, on the terrain scene
(mesh_scene at grid=24: 1,058 terrain and 2,208 sphere triangles) and ~1,100
rays, as tests/test_torch_bvh.py.

Collapse: every triangle once in the leaves, every child box its binary
node's box bit for bit, at most 4 children a node, the stack bound. Walk:
bvh4_traverse_plain against grail's Pallas kernels in interpret mode (ordered
closest hit, skip any hit and skip closest hit, the kernels it replaces on
the main path) and against the port's all-pairs oracle
(kernels/intersect.py intersect_brute, intersect_p_brute) on three
geometries. The closest hit is unique except where two triangles tie on t
exactly, which the walks may resolve by another visit order: prims must
agree on >= 99.9% of hits. Where they do, t, b1, b2 are bitwise equal to the
oracle's (the same Moller-Trumbore, term for term) and within rtol 1e-4,
atol 1e-4 of grail's, as in tests/test_torch_bvh.py: XLA's CPU backend
contracts the Pallas kernel's multiply-adds into FMAs, which moves t by a
few ulps. An any hit reports the first hit in its own visit order (near
first here, preorder there), so only the occlusion is compared and each
reported triangle is checked to be a hit. The tie rule: children with equal
entry distance are visited in slot order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.kernels.bvh_stream import _run
from grail.scene.presets import mesh_scene
from grail_torch.kernels import bvh4 as b4
from grail_torch.kernels import intersect as tisect
from grail_torch.native import build_bvh_native
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.scene.buffers import SceneBuilder, binary_bvh
from grail_torch.scene.presets import cornell_box, mesh_scene as torch_mesh_scene
from grail_torch.scene.shapes import sphere

torch.set_num_threads(2)

N_RAYS = 1024 + 76
RAYS = ("o", "d", "tmin", "tmax")


@pytest.fixture(scope="module")
def terrain():
    scene, meta, _ = mesh_scene(16, 16, 1, grid=24)
    scene_np = jax.tree_util.tree_map(np.asarray, scene)
    ts, _ = scene_from_numpy(scene_np, meta, device="cpu")
    rs = np.random.RandomState(11)
    n = N_RAYS
    o = (rs.rand(n, 3) * [8.6, 3.0, 8.6] + [-4.3, -0.5, -4.3]).astype(np.float32)
    o[:200] = [0.0, 3.2, 7.5]                        # the camera position
    d = rs.randn(n, 3).astype(np.float32)
    d[:200, 1] = -np.abs(d[:200, 1])                 # camera-like, downward
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1.0e7, np.float32)
    tmax[200:500] = rs.rand(300).astype(np.float32) * 3.0   # shadow segments
    tmax[500:600] = 0.0                                       # dead lanes
    tmin[600:650] = 0.25
    return {"scene_np": scene_np, "meta": meta, "bvh": ts["bvh"],
            "verts": ts["verts"], "tri_idx": ts["tri_idx"],
            "o": o, "d": d, "tmin": tmin, "tmax": tmax}


def _plain(s, any_hit):
    bvh = s["bvh"]
    return [a.numpy() for a in b4.bvh4_traverse_plain(
        bvh["bvh4_nodes"], bvh["bvh4_tris"], *(torch.tensor(s[k]) for k in RAYS),
        any_hit=any_hit, stack=bvh["bvh4_stack"])]


def _ranges(first, end, children):
    """Triangle range [first, end) of every node of a tree whose children
    (lists of node ids) are numbered after their parent, from each node's
    own leaf triangles [first, end) (empty: first > end)."""
    first, end = [int(x) for x in first], [int(x) for x in end]
    for i in range(len(children) - 1, -1, -1):
        first[i] = min([first[i]] + [first[c] for c in children[i]])
        end[i] = max([end[i]] + [end[c] for c in children[i]])
    return list(zip(first, end))


def test_collapse_invariants(terrain):
    s = terrain["scene_np"]
    b = build_bvh_native(s["verts"], s["tri_idx"], max_prims=4, force_leaf=4)
    nodes, tris, stack = b4.build_bvh4_tables(b, s["verts"], s["tri_idx"])
    assert nodes.shape[1] == b4.NODE_WORDS and tris.shape == (len(b["prim_ids"]), 12)
    box = nodes[:, :24].reshape(-1, 6, 4).transpose(0, 2, 1)     # (N4, slot, 6)
    child, count = nodes[:, 24:28].view(np.int32), nodes[:, 28:32].view(np.int32)
    leaf = count > 0
    used = leaf | (child >= 0)
    child = np.where(leaf, ~child, child)            # a leaf's first triangle
    # 1..4 children, filled from slot 0; 4 children or only leaves
    assert (used.sum(1) >= 1).all() and (used[:, :-1] >= used[:, 1:]).all()
    assert ((used.sum(1) == 4) | ((count > 0) == used).all(1)).all()
    assert np.isposinf(box[~used]).all() and (count[~used] == 0).all()
    # every triangle exactly once in the leaves, in leaf order
    covered = np.concatenate([np.arange(f, f + c) for f, c in zip(child[leaf], count[leaf])])
    np.testing.assert_array_equal(np.sort(covered), np.arange(len(b["prim_ids"])))
    np.testing.assert_array_equal(tris[:, 3].view(np.int32), b["prim_ids"])
    more = np.ones(len(covered), np.int32)
    more[child[leaf] + count[leaf] - 1] = 0          # a leaf's last triangle
    np.testing.assert_array_equal(tris[:, 11].view(np.int32), more)
    # every child box is its binary node's box bit for bit: a binary node is
    # identified by the triangle range of its subtree
    is_leaf = b["nprims"] > 0
    right = b["right"]
    big = np.iinfo(np.int32).max
    bin_ranges = _ranges(np.where(is_leaf, b["prim_off"], big),
                         np.where(is_leaf, b["prim_off"] + b["nprims"], -1),
                         [[] if is_leaf[i] else [i + 1, right[i]]
                          for i in range(len(right))])
    bin_of = {r: i for i, r in enumerate(bin_ranges)}
    kids = [[c for c, n in zip(child[i], count[i]) if c >= 0 and n == 0]
            for i in range(len(nodes))]
    leaf_first = np.where(leaf, child, big).min(1)
    leaf_end = np.where(leaf, child + count, -1).max(1)
    ranges4 = _ranges(leaf_first, leaf_end, kids)
    bin_box = np.concatenate([b["bounds_min"], b["bounds_max"]], 1)
    for i, j in zip(*np.nonzero(used)):
        r = ((int(child[i, j]), int(child[i, j] + count[i, j])) if leaf[i, j]
             else ranges4[child[i, j]])
        np.testing.assert_array_equal(box[i, j].view(np.uint32),
                                      bin_box[bin_of[r]].view(np.uint32))
    # the root node's children partition the whole range
    assert ranges4[0] == (0, len(b["prim_ids"]))
    # the stack bound: a node's child count - 1 plus its deepest node child's
    bound = [0] * len(nodes)
    for i in range(len(nodes) - 1, -1, -1):
        bound[i] = used[i].sum() - 1 + max((bound[c] for c in kids[i]), default=0)
    assert stack == bound[0] and 1 < stack <= b4.STACK_MAX
    # a walk holds at most `stack` entries: the plain version raises beyond
    s = terrain
    _plain(s, any_hit=False)
    args = [torch.tensor(nodes), torch.tensor(tris)] + [torch.tensor(s[k]) for k in RAYS]
    with pytest.raises(ValueError, match="stack"):
        b4.bvh4_traverse_plain(*args, stack=1)
    with pytest.raises(ValueError, match="stack"):
        b4.bvh4_traverse(*args, stack=b4.STACK_MAX + 1)


@pytest.mark.parametrize("any_hit, kind", [(False, "ordered"), (True, "skip"),
                                           (False, "skip"), (True, "ordered")],
                         ids=["closest", "any_hit", "closest_vs_skip",
                              "any_hit_vs_ordered"])
def test_plain_matches_pallas_interpret(terrain, any_hit, kind):
    """Against each grail kernel the 4-wide walk replaces: ordered closest
    hit (binned waves), skip any hit (shadow waves) and skip closest hit (the
    tile-ordered camera wave) on the main path, and ordered any hit (reached
    only by a kind override), whose redesign the 4-wide any hit is."""
    s = terrain
    table = s["scene_np"]["bvh"]["stream"]
    ref = [np.asarray(a) for a in _run(
        jnp.asarray(table), *(jnp.asarray(s[k]) for k in RAYS), any_hit=any_hit,
        interpret=True, kind=kind)]
    before = dict(b4.LAUNCHES)
    t, prim, b1, b2, n_node, n_test, n_tri = _plain(s, any_hit)
    hit, hit_ref = prim >= 0, ref[1] >= 0
    np.testing.assert_array_equal(hit, hit_ref)
    assert 0.2 < hit.mean() < 0.9 and not hit[500:600].any()
    if any_hit:
        assert (t[hit] == np.float32(-3.0e37)).all()
        tri = torch.tensor(s["scene_np"]["verts"])[
            torch.tensor(s["scene_np"]["tri_idx"]).long()[torch.tensor(prim[hit]).long()]]
        real, _, _, _ = tisect.moller_trumbore(
            torch.tensor(s["o"][hit]), torch.tensor(s["d"][hit]), tri[:, 0],
            tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
            torch.tensor(s["tmin"][hit]), torch.tensor(s["tmax"][hit]))
        assert real.float().mean() >= 0.999
    else:
        same = prim == ref[1]
        assert same.mean() >= 0.999
        for a, r in zip((t, b1, b2), ref[0:1] + ref[2:]):
            np.testing.assert_allclose(a[same], r[same], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(t[~hit], s["tmax"][~hit])
    # every ray reads the root, 4 slab tests a node; leaves only behind nodes
    assert (n_node >= 1).all() and (n_test == 4 * n_node).all()
    # the wrapper takes the plain version on the CPU and launches nothing
    bvh = s["bvh"]
    _, prim_w, _, _ = b4.bvh4_traverse(bvh["bvh4_nodes"], bvh["bvh4_tris"],
                                       *(torch.tensor(s[k]) for k in RAYS),
                                       any_hit=any_hit, stack=bvh["bvh4_stack"])
    np.testing.assert_array_equal(prim_w.numpy(), prim)
    assert b4.LAUNCHES == before


def _inside_sphere():
    """Rays from inside a closed sphere of 576 triangles (nu=24, nv=12):
    every live ray hits and walks several leaves; 16 dead lanes."""
    verts, idx, _, _ = sphere(nu=24, nv=12)
    nodes, tris, stack = b4.build_bvh4_tables(binary_bvh(verts, idx), verts, idx)
    rs = np.random.RandomState(5)
    n = 512
    o = ((rs.rand(n, 3) - 0.5) * 0.8).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1.0e7, np.float32)
    tmax[:16] = 0.0                                   # dead lanes
    return {"bvh": {"bvh4_nodes": torch.tensor(nodes), "bvh4_tris": torch.tensor(tris),
                    "bvh4_stack": stack},
            "verts": torch.tensor(verts), "tri_idx": torch.tensor(idx),
            "o": o, "d": d, "tmin": tmin, "tmax": tmax}


def _random65():
    """The smallest BVH scene, 65 random triangles in the unit cube, built by
    SceneBuilder; rays through the cube with dead lanes and tmin > 0."""
    b = SceneBuilder()
    b.add_mesh(np.random.RandomState(0).rand(65 * 3, 3),
               np.arange(65 * 3).reshape(65, 3), b.matte())
    b.camera = cornell_box(16, 16, 1, device="cpu")[2].camera
    scene, _ = b.finalize(device="cpu")
    rs = np.random.RandomState(3)
    n = 1024
    o = (rs.rand(n, 3) * 2.0 - 0.5).astype(np.float32)
    d = (rs.rand(n, 3) - o).astype(np.float32)        # toward the cube
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1.0e7, np.float32)
    tmax[:64] = 0.0                                   # dead lanes
    tmin[64:320] = rs.rand(256).astype(np.float32)    # tmin > 0
    return {"bvh": scene["bvh"], "verts": scene["verts"], "tri_idx": scene["tri_idx"],
            "o": o, "d": d, "tmin": tmin, "tmax": tmax}


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
@pytest.mark.parametrize("geometry", ["terrain", "sphere", "random65"])
def test_walk_matches_brute_oracle(request, geometry, any_hit):
    """Against the all-pairs oracle: the same hits, prims agreeing on
    >= 99.9% of them and t, b1, b2 bitwise where they do; the same
    occlusion."""
    s = (request.getfixturevalue("terrain") if geometry == "terrain"
         else _inside_sphere() if geometry == "sphere" else _random65())
    o, d, tmin, tmax = (torch.tensor(s[k]) for k in RAYS)
    geo = {"verts": s["verts"], "tri_idx": s["tri_idx"]}
    chunks = [slice(i, i + 256) for i in range(0, len(o), 256)]
    t, prim, b1, b2, n_node, _, n_tri = _plain(s, any_hit)
    hit, live = prim >= 0, s["tmax"] > s["tmin"]
    assert not hit[~live].any() and 0 < hit.mean()
    if geometry == "sphere":
        # a leaf holds at most 4 triangles: a closest hit tests several
        assert hit[live].all() and (n_node[live] > 1).all()
        assert any_hit or n_tri[live].mean() > 4
    else:
        assert hit[live].mean() < 1
    if any_hit:
        occ = torch.cat([tisect.intersect_p_brute(geo, o[c], d[c], tmax[c], tmin[c])
                         for c in chunks]).numpy()
        np.testing.assert_array_equal(hit, occ)
        assert (t[hit] == np.float32(-3.0e37)).all()
        return
    ref = [torch.cat(a).numpy() for a in zip(*(
        (r["t"], r["prim"], r["b1"], r["b2"])
        for r in (tisect.intersect_brute(geo, o[c], d[c], tmax[c], tmin[c]) for c in chunks)))]
    np.testing.assert_array_equal(hit, ref[1] >= 0)
    same = hit & (prim == ref[1])
    assert same.sum() >= 0.999 * hit.sum()
    for a, r in zip((t, b1, b2), ref[0:1] + ref[2:]):
        np.testing.assert_array_equal(a[same].view(np.uint32), r[same].view(np.uint32))
    np.testing.assert_array_equal(t[~hit], s["tmax"][~hit])


def _tie_tables(lo_z):
    """One node whose 4 leaf slots hold one triangle each, the same square
    at z = 0.5 (so every hit has t = 1.5); slot k's box spans
    [0, 1]^2 x [lo_z[k], 1]."""
    nodes = np.zeros((1, 32), np.float32)
    box = np.array([[0, 0, z, 1, 1, 1] for z in lo_z], np.float32)   # (slot, 6)
    nodes[0, :24] = box.T.reshape(-1)
    nodes[0, 24:28] = (~np.arange(4, dtype=np.int32)).view(np.float32)
    nodes[0, 28:32] = np.ones(4, np.int32).view(np.float32)
    tris = np.zeros((4, 12), np.float32)
    tris[:, 0:3] = [-1.0, -1.0, 0.5]
    tris[:, 4:7] = [4.0, 0.0, 0.0]
    tris[:, 8:11] = [0.0, 4.0, 0.0]
    tris[:, 3] = np.array([7, 5, 9, 3], np.int32).view(np.float32)
    return torch.tensor(nodes), torch.tensor(tris)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_tie_rule_slot_order(any_hit):
    """Children with equal entry distance are visited in slot order; a
    nearer child first. Every triangle is hit at the same t, so the
    reported prim is the first triangle visited."""
    o = torch.tensor([[0.25, 0.25, -1.0]] * 4)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    tmin, tmax = torch.zeros(4), torch.full((4,), 10.0)
    cases = {(0.0, 0.0, 0.0, 0.0): 7,       # all tie: slot 0
             (0.2, 0.0, 0.0, 0.0): 5,       # slot 0 farther: slot 1
             (0.2, 0.2, 0.0, 0.0): 9,
             (0.0, 0.0, -0.5, 0.0): 9,      # slot 2 nearer
             (0.2, 0.0, 0.0, -0.5): 3}
    for lo_z, want in cases.items():
        nodes, tris = _tie_tables(lo_z)
        t, prim, _, _, n_node, _, n_tri = b4.bvh4_traverse_plain(
            nodes, tris, o, d, tmin, tmax, any_hit=any_hit, stack=3)
        assert (prim == want).all(), (lo_z, prim)
        assert (n_node == 1).all() and (n_tri == (1 if any_hit else 4)).all()
        assert (t == (-3.0e37 if any_hit else 1.5)).all()


def test_bridged_and_built_tables_equal(terrain):
    """A scene built by the port and the reference's scene carried across
    take the same route: the same 4-wide tables bit for bit."""
    built, _, _ = torch_mesh_scene(16, 16, 1, grid=24, device="cpu")
    bridged = terrain["bvh"]
    assert built["bvh"]["bvh4_stack"] == bridged["bvh4_stack"]
    for k in ("bvh4_nodes", "bvh4_tris"):
        assert torch.equal(built["bvh"][k].view(torch.int32), bridged[k].view(torch.int32))

