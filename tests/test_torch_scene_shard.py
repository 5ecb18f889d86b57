"""The port's scene sharding (grail_torch/dist/scene_shard.py and
sharding.render_scene_sharded) against grail's, on the CPU.

- partition_scene equals the reference's leaf for leaf (8 shards, in this
  process); with stream=True each shard's 4-wide table holds exactly its
  local slots.
- ring_intersect over 4 gloo CPU ranks (tests/torch_dist_ranks.py), closest
  and any hit, on the 512 random rays of tests/test_scene_shard.py: the
  port's replicated brute force bitwise (prim, and t, b1, b2 on hits), the
  reference's intersect_brute bitwise in prim and occlusion, and in t, b1,
  b2 to tests/test_torch_intersect.py's rtol 1e-5, atol 1e-6 (XLA rounds
  the hit test's products in its own way).
- render_scene_sharded, path, depth 3, compact=False, over 2 ranks, with no
  mesh leaf in any rank's scene: with the brute-force local step bitwise
  the port's replicated render (which is the reference's within
  tests/test_sharding.py's atol 2e-5, not bitwise: XLA rounds its own
  way); with stream=True (the 4-wide walk a shard) within atol 1e-5, rtol
  1e-4 of both, as the reference's test. A ring scene with instances,
  media or alpha cutouts raises.
- the bridge carries a reference partition across equal to the port's own.
"""
import numpy as np
import pytest
import torch

import jax

from grail.dist.scene_shard import partition_scene as jax_partition
from grail.engine.integrator import IntegratorConfig as JaxConfig
from grail.engine.render import render as jax_render
from grail.kernels.intersect import intersect_brute as jax_brute
from grail.scene.presets import cornell_box as jax_cornell
from grail_torch.dist.launch import run_ranks
from grail_torch.dist.scene_shard import PAD_GID, TRI_FIELDS, TRI_IFIELDS, partition_scene
from grail_torch.dist.sharding import Mesh, render_scene_sharded
from grail_torch.engine.render import render
from grail_torch.kernels.brute_intersect import brute_intersect
from grail_torch.kernels.intersect import pack_tris
from grail_torch.kernels.bvh4 import TRI_WORDS
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.scene.presets import cornell_box

import torch_dist_ranks as R

TIMEOUT_S = 110
FIELDS = TRI_FIELDS + TRI_IFIELDS + ("gid",)


def _rays():
    """tests/test_scene_shard.py's rays."""
    rng = np.random.RandomState(3)
    n = 512
    o = (rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
         + np.array([0, 1, 0], np.float32))
    d = rng.randn(n, 3).astype(np.float32)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o, d, np.full((n,), 1e7, np.float32)


@pytest.fixture(scope="module")
def ranks():
    return {4: run_ranks(R.run_jobs, 4, "cpu", TIMEOUT_S, ([("ring_rays", _rays())],)),
            2: run_ranks(R.run_jobs, 2, "cpu", TIMEOUT_S, ([("ring_render", ())],))}


@pytest.fixture(scope="module")
def jax_scene():
    return jax_cornell(xres=R.RES, yres=R.RES, spp=R.SPP)


def test_partition_matches_reference(jax_scene):
    js, _, _ = jax_scene
    ref = jax_partition(js, 8)
    got = partition_scene(cornell_box(R.RES, R.RES, R.SPP, device="cpu")[0], 8)
    assert set(got) == set(FIELDS)
    for k in FIELDS:
        assert got[k].dtype == torch.tensor(np.asarray(ref[k])).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_stream_tables_cover_the_shard():
    scene, meta, _ = cornell_box(R.RES, R.RES, R.SPP, device="cpu")
    ring = partition_scene(scene, 4, stream=True)
    assert len(ring["bvh4"]) == 4
    for k, tab in enumerate(ring["bvh4"]):
        real = int((ring["gid"][k] < PAD_GID).sum())
        tris = tab["tris"].numpy()
        assert tris.shape == (real, TRI_WORDS) and tab["stack"] >= 0
        slots = np.sort(tris[:, 3].view(np.int32))
        np.testing.assert_array_equal(slots, np.arange(real))
        # each row is the shard's own triangle at that slot
        for j, slot in enumerate(tris[:, 3].view(np.int32)):
            for f, cols in (("v0", slice(0, 3)), ("e1", slice(4, 7)), ("e2", slice(8, 11))):
                np.testing.assert_array_equal(tris[j, cols], ring[f][k][slot].numpy())


@pytest.mark.parametrize("any_hit", (False, True), ids=("closest", "any_hit"))
def test_ring_intersect_matches_brute(ranks, jax_scene, any_hit):
    js, _, _ = jax_scene
    o, d, tmax = _rays()
    ref = jax.tree_util.tree_map(np.asarray, jax_brute(js, o, d, tmax))
    out = {k: np.concatenate([r[k] for r in ranks[4]])
           for k in ("t", "prim", "b1", "b2", "occluded")}
    scene = cornell_box(R.RES, R.RES, 1, device="cpu")[0]
    port = dict(zip(("t", "prim", "b1", "b2"), (a.numpy() for a in brute_intersect(
        pack_tris(scene), *(torch.tensor(a) for a in (o, d, np.zeros_like(tmax), tmax))))))
    hit = ref["prim"] >= 0
    assert 0 < hit.sum() < hit.size
    if any_hit:
        np.testing.assert_array_equal(out["occluded"], hit)
        return
    np.testing.assert_array_equal(out["prim"], ref["prim"])
    np.testing.assert_array_equal(out["prim"], port["prim"])
    for k in ("t", "b1", "b2"):
        np.testing.assert_array_equal(out[k][hit], port[k][hit], err_msg=k)
        np.testing.assert_allclose(out[k][hit], ref[k][hit], rtol=1e-5, atol=1e-6, err_msg=k)
    assert (out["t"][~hit] == 3.0e37).all() and not out["b1"][~hit].any()


@pytest.fixture(scope="module")
def replicated(jax_scene):
    js, jm, _ = jax_scene
    scene, meta, _ = cornell_box(R.RES, R.RES, R.SPP, device="cpu")
    cfg = JaxConfig(kind="path", max_depth=3, compact=False)
    return (render(scene, meta, R.RING_PATH, spp=R.SPP, device="cpu")[0].numpy(),
            np.asarray(jax_render(js, jm, cfg, spp=R.SPP)[0]))


def test_ring_render_brute_is_bitwise_replicated(ranks, replicated):
    port, ref = replicated
    assert port.mean() > 1e-3
    np.testing.assert_allclose(port, ref, atol=2e-5)
    for out in ranks[2]:
        np.testing.assert_array_equal(out["ring_brute"], port)


def test_ring_render_stream_matches_replicated(ranks, replicated):
    port, ref = replicated
    for out in ranks[2]:
        np.testing.assert_allclose(out["ring_stream"], port, atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(out["ring_stream"], ref, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("feature", ("instances", "media", "alpha"))
def test_ring_refuses_unsupported_scenes(feature):
    scene, meta, _ = cornell_box(8, 8, 1, device="cpu")
    if feature == "alpha":
        import dataclasses
        meta = dataclasses.replace(meta, alpha_rows=(0,))
    else:
        scene = dict(scene, **{"inst" if feature == "instances" else "media": {}})
    with pytest.raises(NotImplementedError, match="plain triangle scenes"):
        render_scene_sharded(scene, meta, R.RING_PATH, 1, Mesh(1, 0, torch.device("cpu")))


@pytest.mark.parametrize("stream", (False, True), ids=("brute", "stream"))
def test_bridge_carries_the_partition(jax_scene, stream):
    js, jm, _ = jax_scene
    js = dict(js, ring=jax_partition(js, 4, stream=stream))
    got = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), jm, device="cpu")[0]["ring"]
    own = partition_scene(cornell_box(R.RES, R.RES, R.SPP, device="cpu")[0], 4, stream=stream)
    assert set(got) == set(own)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy(), own[k].numpy(), err_msg=k)
    for a, b in zip(got.get("bvh4", ()), own.get("bvh4", ())):
        assert a["stack"] == b["stack"]
        np.testing.assert_array_equal(a["nodes"].numpy(), b["nodes"].numpy())
        np.testing.assert_array_equal(a["tris"].numpy(), b["tris"].numpy())
