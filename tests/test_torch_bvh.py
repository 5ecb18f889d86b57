"""The port's BVH builder, record-table packer, ray binning and the plain
versions of the four stream traversals against grail's, on the terrain scene
(mesh_scene at grid=24: 1,058 terrain and 2,208 sphere triangles).

Builder and packer: array for array and bit for bit. Traversals: each plain
traversal against grail's Pallas kernel of the same kind and hit mode, run
in interpret mode, on ~1,100 rays (the reference pads them to 2,048): random
rays, finite shadow segments and dead lanes. Hit masks and occlusion masks
must be equal; where both hit, t matches to rtol 1e-4, atol 1e-4 and prim
agrees on >= 99.9% of rays. The closest hit is unique except for rays whose
t ties exactly between two triangles, which the two packages may resolve by
a different visit order (per-ray near child here, per-packet there). An
ordered any hit is the first hit in that visit order, so there only the
occlusion is compared, and each reported triangle is checked to be a hit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.kernels import binning as jbin
from grail.kernels.bvh_stream import _run, build_stream_table as jbuild_table
from grail.scene.bvh import build_bvh as jbuild_bvh
from grail.scene.presets import mesh_scene
from grail_torch.kernels import binning as tbin
from grail_torch.kernels import bvh_stream as tbs
from grail_torch.kernels import intersect as tisect
from grail_torch.native import build_bvh_native
from grail_torch.scene.bridge import scene_from_numpy

torch.set_num_threads(2)

N_RAYS = 1024 + 76


@pytest.fixture(scope="module")
def terrain():
    scene, meta, _ = mesh_scene(16, 16, 1, grid=24)
    scene_np = jax.tree_util.tree_map(np.asarray, scene)
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
    return {"scene": scene, "scene_np": scene_np, "meta": meta,
            "o": o, "d": d, "tmin": tmin, "tmax": tmax}


def test_builders_and_table_match_reference(terrain):
    s = terrain["scene_np"]
    verts, tris = s["verts"], s["tri_idx"]
    ref = jbuild_bvh(verts, tris, max_prims=4, force_leaf=4)
    got = build_bvh_native(verts, tris, max_prims=4, force_leaf=4)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    table = tbs.build_stream_table(ref, verts, tris)
    assert table.dtype == np.float32 and table.shape[1] == 128
    np.testing.assert_array_equal(table.view(np.uint32),
                                  np.asarray(jbuild_table(ref, verts, tris)).view(np.uint32))
    # the reference scene's own table (built by its native builder)
    np.testing.assert_array_equal(table.view(np.uint32),
                                  s["bvh"]["stream"].view(np.uint32))
    # depth: the longest run of interior nodes, checked by walking the tree
    right, leaf = ref["right"], ref["nprims"] > 0

    def longest(i):
        return 0 if leaf[i] else 1 + max(longest(i + 1), longest(right[i]))
    assert tbs.tree_depth(ref) == longest(0) > 5
    # the ordered kernel refuses a tree deeper than its stack
    args = [torch.tensor(table)] + [torch.zeros(1, 3)] * 2 + [torch.zeros(1)] * 2
    with pytest.raises(ValueError, match="stack"):
        tbs.stream_traverse(*args, kind="ordered", depth=tbs.STACK + 1)


@pytest.mark.parametrize("kind", ["skip", "ordered"])
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "any_hit"])
def test_plain_traversal_matches_pallas_interpret(terrain, kind, any_hit):
    s = terrain
    table = s["scene_np"]["bvh"]["stream"]
    ref = [np.asarray(a) for a in _run(
        jnp.asarray(table), *(jnp.asarray(s[k]) for k in ("o", "d", "tmin", "tmax")),
        any_hit=any_hit, interpret=True, kind=kind)]
    before = dict(tbs.LAUNCHES)
    t, prim, b1, b2, n_box, n_tri = (a.numpy() for a in tbs.stream_traverse_plain(
        torch.tensor(table), *(torch.tensor(s[k]) for k in ("o", "d", "tmin", "tmax")),
        any_hit=any_hit, kind=kind))
    hit, hit_ref = prim >= 0, ref[1] >= 0
    np.testing.assert_array_equal(hit, hit_ref)
    assert 0.2 < hit.mean() < 0.9
    assert not hit[500:600].any()                    # dead lanes
    both = hit & hit_ref
    if any_hit:
        assert (t[hit] == np.float32(-3.0e37)).all()
        # any hit reports the first hit in visit order: the skip traversal's
        # preorder is the reference's, the ordered one picks its near child
        # per ray where the reference picks it per 128-ray packet, so there
        # only the occlusion is comparable; every reported prim is a real
        # hit of its ray within (tmin, tmax)
        if kind == "skip":
            assert (prim[both] == ref[1][both]).mean() >= 0.999
        tri = torch.tensor(s["scene_np"]["verts"])[
            torch.tensor(s["scene_np"]["tri_idx"]).long()[torch.tensor(prim[hit]).long()]]
        real, _, _, _ = tisect.moller_trumbore(
            torch.tensor(s["o"][hit]), torch.tensor(s["d"][hit]), tri[:, 0],
            tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0],
            torch.tensor(s["tmin"][hit]), torch.tensor(s["tmax"][hit]))
        assert real.float().mean() >= 0.999
    else:
        assert (prim[both] == ref[1][both]).mean() >= 0.999
        np.testing.assert_allclose(t[both], ref[0][both], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(t[~hit], s["tmax"][~hit])
        same = both & (prim == ref[1])
        np.testing.assert_allclose(b1[same], ref[2][same], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(b2[same], ref[3][same], rtol=1e-4, atol=1e-4)
    # every ray reads the root; a triangle is visited only behind a box
    assert (n_box + n_tri >= 1).all() and (n_box[n_tri > 0] >= 1).all()
    # the wrapper takes the plain version on the CPU and launches nothing
    t_w, prim_w, _, _ = tbs.stream_traverse(
        torch.tensor(table), *(torch.tensor(s[k]) for k in ("o", "d", "tmin", "tmax")),
        any_hit=any_hit, kind=kind, depth=tbs.tree_depth(s["scene_np"]["bvh"]))
    np.testing.assert_array_equal(prim_w.numpy(), prim)
    assert tbs.LAUNCHES == before


def test_binning_matches_reference(terrain):
    s = terrain
    o, d = s["o"], s["d"]
    bmin, bmax = s["scene_np"]["verts"].min(0), s["scene_np"]["verts"].max(0)
    key_ref = np.asarray(jbin.bin_rays_key(jnp.asarray(o), jnp.asarray(d),
                                           jnp.asarray(bmin), jnp.asarray(bmax)))
    key = tbin.bin_rays_key(torch.tensor(o), torch.tensor(d), torch.tensor(bmin),
                            torch.tensor(bmax))
    np.testing.assert_array_equal(key.numpy(), key_ref)
    dead = s["tmax"] <= s["tmin"]
    key_ref = np.where(dead, jbin.N_RAY_BUCKETS, key_ref)
    key = torch.where(torch.tensor(dead), tbin.N_RAY_BUCKETS, key)
    rank_ref = np.asarray(jbin.bucket_rank(jnp.asarray(key_ref, jnp.int32),
                                           jbin.N_RAY_BUCKETS + 1))
    rank = tbin.bucket_rank(key, tbin.N_RAY_BUCKETS + 1)
    np.testing.assert_array_equal(rank.numpy(), rank_ref)
    sorted_ref = jbin.sort_by_rank(jnp.asarray(rank_ref), jnp.asarray(o),
                                   jnp.asarray(s["tmax"]))
    sorted_t = tbin.sort_by_rank(rank, torch.tensor(o), torch.tensor(s["tmax"]))
    for a, b in zip(sorted_t, sorted_ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = tbin.unsort(rank, *sorted_t)
    np.testing.assert_array_equal(back[0].numpy(), o)
    np.testing.assert_array_equal(
        back[1].numpy(), np.asarray(jbin.unsort(jnp.asarray(rank_ref), sorted_ref[1])[0]))


def test_stream_dispatch_sorted_and_unsorted(terrain, monkeypatch):
    """The dispatch's binned and unbinned routes both take the 4-wide walk
    (bvh4_traverse; the unbinned one, the camera wave, took the skip kernel
    on the record stream before) and give the reference skip kernel's hits,
    with dead lanes inert and misses at BIG_T; its any hit (4-wide) gives
    the reference's occlusion. Each closest-hit wave is counted under its
    route in CLOSEST_WAVES, and no any-hit wave is."""
    s = terrain
    routes = []
    traverse = tisect.bvh4_traverse

    def recording(*a, **kw):
        routes.append(("bvh4_traverse", kw.get("any_hit", False)))
        return traverse(*a, **kw)
    monkeypatch.setattr(tisect, "bvh4_traverse", recording)
    ts, _ = scene_from_numpy(s["scene_np"], s["meta"], device="cpu")
    args = [torch.tensor(s[k]) for k in ("o", "d", "tmax", "tmin")]
    ref = np.asarray(_run(jnp.asarray(s["scene_np"]["bvh"]["stream"]),
                          *(jnp.asarray(s[k]) for k in ("o", "d", "tmin", "tmax")),
                          interpret=True, kind="skip")[1])
    occ_ref = np.asarray(_run(jnp.asarray(s["scene_np"]["bvh"]["stream"]),
                              *(jnp.asarray(s[k]) for k in ("o", "d", "tmin", "tmax")),
                              any_hit=True, interpret=True)[1]) >= 0
    for sort in (False, True):
        routes.clear()
        waves = dict(tisect.CLOSEST_WAVES)
        hit = tisect.intersect(ts, *args, device="cpu", sort=sort)
        assert routes == [("bvh4_traverse", False)]
        waves[("unbinned", "binned")[sort]] += 1
        assert tisect.CLOSEST_WAVES == waves
        prim = hit["prim"].numpy()
        np.testing.assert_array_equal(prim >= 0, ref >= 0)
        assert (prim == ref).mean() >= 0.999
        assert (hit["t"].numpy()[prim < 0] == np.float32(tisect.BIG_T)).all()
    routes.clear()
    waves = dict(tisect.CLOSEST_WAVES)
    occ = tisect.intersect_p(ts, *args, device="cpu").numpy()
    np.testing.assert_array_equal(occ, occ_ref)
    assert routes == [("bvh4_traverse", True)]
    assert tisect.CLOSEST_WAVES == waves
