"""The port's BVH builders and ray binning against grail's, and the
dispatch's BVH routes against grail's skip kernel, on the terrain scene
(mesh_scene at grid=24: 1,058 terrain and 2,208 sphere triangles).

Builders: array for array and bit for bit. The scene's builder dispatch
(scene/buffers.py binary_bvh: numpy below 2,048 triangles, C++ from there,
as the reference's build_bvh_auto) on twelve spheres of 32 to 4,096
triangles, two of which the C++ builder alone splits otherwise. Dispatch:
intersect and intersect_p against grail's Pallas kernels, run in interpret
mode, on ~1,100 rays (the reference pads them to 2,048): random rays, finite
shadow segments and dead lanes. Hit masks and occlusion masks must be
equal, and prim agrees on >= 99.9% of rays. The closest hit is unique
except for rays whose t ties exactly between two triangles, which the two
packages may resolve by a different visit order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.kernels import binning as jbin
from grail.kernels.bvh_stream import _run
from grail.scene.bvh import build_bvh as jbuild_bvh, build_bvh_auto as jbuild_auto
from grail.scene.presets import mesh_scene
from grail_torch.kernels import binning as tbin
from grail_torch.kernels import intersect as tisect
from grail_torch.native import build_bvh_native
from grail_torch.scene import bvh as tbvh
from grail_torch.scene.buffers import binary_bvh
from grail_torch.scene.shapes import sphere
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


def test_builders_match_reference(terrain):
    s = terrain["scene_np"]
    verts, tris = s["verts"], s["tri_idx"]
    ref = jbuild_bvh(verts, tris, max_prims=4, force_leaf=4)
    got = build_bvh_native(verts, tris, max_prims=4, force_leaf=4)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# (nu, nv) of sphere meshes of 2·nu·nv triangles: (6, 4) and (10, 5) are
# where the C++ builder's tree differs from the numpy builder's (33 nodes
# against 35, 59 against 65); the reference builds both with numpy
SPHERES = ((6, 4), (10, 5), (4, 4), (8, 4), (8, 6), (8, 8), (12, 6), (16, 8),
           (20, 10), (24, 12), (32, 16), (64, 32))


@pytest.mark.parametrize("nu,nv", SPHERES, ids=[f"{2 * u * v}tris_{u}x{v}" for u, v in SPHERES])
def test_scene_builder_dispatch_matches_reference(nu, nv):
    verts, idx, _, _ = sphere(nu=nu, nv=nv)
    ref = jbuild_auto(verts, idx, max_prims=4, force_leaf=4)
    got = binary_bvh(verts, idx)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    small = idx.shape[0] < tbvh.NATIVE_THRESHOLD
    np.testing.assert_array_equal(
        tbvh.build_bvh(verts, idx, 4, 4)["right"] if small
        else build_bvh_native(verts, idx, 4, 4)["right"], ref["right"])
    if (nu, nv) in ((6, 4), (10, 5)):       # the C++ builder alone differs here
        assert len(build_bvh_native(verts, idx, 4, 4)["right"]) != len(ref["right"])


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
