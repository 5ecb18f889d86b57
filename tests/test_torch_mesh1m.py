"""The port's 1M-triangle scene (mesh_scene_1m) against grail's, cut to
grid=24 (3,266 triangles) at 16x16, 2 spp, depth 3.

- The preset: the finalized geometry, materials, textures, lights, camera
  pack and 4-wide tables equal the reference's, carried across by
  scene_from_numpy, bit for bit (both packages build them with the same
  numpy calls), the environment's Distribution2D (jnp in the reference) to
  rtol 1e-6.
- The thin-lens camera: generate_rays with depth of field, with motion
  blur, and with both, on 4,096 rays, to rtol 1e-5, atol 1e-6 (float32
  transcendental functions round the last bits differently).
- The slice against the reference's clustered route: the reference scene is
  built with its VMEM budget cut so that its triangles split into clustered
  record tables (its route for scenes above the TPU's VMEM wall, run in
  Pallas interpret mode), carried across (one 4-wide table), and li agrees
  per lane (>= 99% of lanes within rtol 1e-4, atol 1e-6, as in
  tests/test_torch_render.py), the rendered image to relative MAE < 1e-3.
"""
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import grail.kernels.bvh_stream as jbs
import grail.kernels.intersect as jisect
from grail.core import rng as jrng
from grail.engine import camera as jcam, film as jfilm
from grail.engine import integrator as jint
from grail.engine.render import render as jax_render
from grail.scene.presets import mesh_scene_1m as jax_mesh_scene_1m
from grail_torch.engine import camera as tcam
from grail_torch.engine import integrator as tint
from grail_torch.engine.render import render
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.scene.buffers import to_torch
from grail_torch.scene.presets import mesh_scene_1m

torch.set_num_threads(2)

RES, SPP, DEPTH, GRID = 16, 2, 3, 24


def relative_mae(a, b):
    return float(np.mean(np.abs(a - b)) / (np.mean(np.abs(b)) + 1e-6))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        elif isinstance(v, tuple):
            for i, x in enumerate(v):
                yield from _leaves(x if isinstance(x, dict) else {"": x},
                                   f"{prefix}{k}/{i}/")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def clustered():
    """The reference's mesh_scene_1m with clustered record tables (>= 3
    clusters), its clustered route switched on for the CPU (Pallas in
    interpret mode), and the same scene carried across."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbs, "VMEM_TABLE_BUDGET", 4096)
        mp.setattr(jbs, "CLUSTER_TARGET_TRIS", 700)
        scene, meta, _ = jax_mesh_scene_1m(RES, RES, SPP, grid=GRID)
    assert "cstream" in scene["bvh"] and scene["bvh"]["cstream"].shape[0] >= 3
    ts, tm = scene_from_numpy(jax.tree_util.tree_map(np.asarray, scene), meta,
                              device="cpu")
    return scene, meta, ts, tm


@pytest.fixture
def reference_clustered_route(monkeypatch):
    """The reference's dispatch takes its Pallas stream route (here the
    clustered tables) in interpret mode on the CPU."""
    monkeypatch.setattr(jisect, "_pallas_ok", lambda: True)
    monkeypatch.setitem(os.environ, "GRAIL_PALLAS_INTERPRET", "1")


def test_preset_matches_reference(clustered):
    _, _, bridged, bridged_meta = clustered
    ts, tm, _ = mesh_scene_1m(RES, RES, SPP, grid=GRID, device="cpu")
    assert tm == bridged_meta and tm.n_tris == 2 * (GRID - 1) ** 2 + 2208
    ported, carried = dict(_leaves(ts)), dict(_leaves(bridged))
    assert ported.keys() == carried.keys()
    assert {"bvh/bvh4_nodes", "bvh/bvh4_tris", "camera/c2w/q", "images/0/",
            "mipmaps/0/flat"} <= ported.keys()
    for name, got in ported.items():
        ref = carried[name]
        if isinstance(got, torch.Tensor):
            got, ref = got.numpy(), ref.numpy()
        if name.startswith("env_dist/"):
            # the reference builds the environment's Distribution2D with jnp
            # (another summation order), the port with numpy
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
    cam = ts["camera"]
    assert bool(cam["c2w"]["animated"]) and float(cam["lens_radius"]) == np.float32(0.04)
    assert float(cam["focal_distance"]) == np.float32(7.6)


@pytest.mark.parametrize("lens, moves", [(0.04, False), (0.0, True), (0.04, True)],
                         ids=["dof", "motion_blur", "both"])
def test_generate_rays_matches_reference(lens, moves):
    from grail.core import transform as jtr
    c2w0 = jtr.look_at([0.0, 3.2, 7.5], [0.0, 0.6, 0.0], [0.0, 1.0, 0.0])
    c2w1 = jtr.look_at([0.12, 3.2, 7.44], [0.0, 0.6, 0.0], [0.0, 1.0, 0.0])
    args = (np.asarray(c2w0), np.asarray(c2w1 if moves else c2w0), 64, 64)
    kw = dict(fov=42.0, lens_radius=lens, focal_distance=7.6)
    ref_cam = jcam.build_camera(jcam.PERSPECTIVE, *args, **kw)
    cam = tcam.build_camera(tcam.PERSPECTIVE, *args, **kw)
    rs = np.random.RandomState(5)
    n = 4096
    px, py = rs.randint(0, 64, (2, n)).astype(np.int32)
    u = rs.rand(5, n).astype(np.float32)
    ref = jcam.generate_rays(ref_cam, jnp.asarray(px), jnp.asarray(py),
                             *map(jnp.asarray, u), jcam.PERSPECTIVE)
    got = tcam.generate_rays(to_torch(cam, "cpu"), torch.tensor(px), torch.tensor(py),
                             *map(torch.tensor, u), tcam.PERSPECTIVE)
    for k in ("o", "d", "time", "weight"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert np.ptp(got["o"].numpy(), axis=0).max() > 0.01    # the lens or the motion


def test_li_matches_reference_per_lane(clustered, reference_clustered_route):
    scene, meta, ts, tm = clustered
    n_pix = RES * RES
    px_t, py_t = jfilm.lane_pixel(jnp.arange(n_pix, dtype=jnp.uint32), RES)
    pix = jnp.tile(py_t.astype(jnp.uint32) * RES + px_t.astype(jnp.uint32), SPP)
    samp = jnp.repeat(jnp.arange(SPP, dtype=jnp.uint32), n_pix)
    ufx, ufy = jrng.sample_2d(meta.sampler, pix, samp, jint.SLOT_FILM)
    ul1, ul2 = jrng.sample_2d(meta.sampler, pix, samp, jint.SLOT_LENS)
    ut = jrng.sample_1d(meta.sampler, pix, samp, jint.SLOT_TIME)
    px, py = (pix % RES).astype(jnp.int32), (pix // RES).astype(jnp.int32)

    def gen(x, y):
        return jcam.generate_rays(scene["camera"], x, y, ufx, ufy, ul1, ul2, ut,
                                  meta.cam_kind)
    rays, rx, ry = gen(px, py), gen(px + 1, py), gen(px, py + 1)
    rays = {k: rays[k] for k in ("o", "d", "weight")}
    rays["camdiff"] = (rx["o"], rx["d"], ry["o"], ry["d"])
    cfg = jint.IntegratorConfig(kind="path", max_depth=DEPTH)
    L_ref = np.asarray(jax.jit(partial(jint.li, scene, meta, cfg))(rays, pix, samp))

    rt = {k: torch.tensor(np.asarray(v)) for k, v in rays.items() if k != "camdiff"}
    rt["camdiff"] = tuple(torch.tensor(np.asarray(v)) for v in rays["camdiff"])
    L = tint.li(ts, tm, tint.IntegratorConfig(kind="path", max_depth=DEPTH), rt,
                torch.tensor(np.asarray(pix).astype(np.int64)),
                torch.tensor(np.asarray(samp).astype(np.int64))).numpy()
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"


def test_render_matches_reference(clustered, reference_clustered_route):
    scene, meta, ts, tm = clustered
    img_ref, _ = jax_render(scene, meta, jint.IntegratorConfig(kind="path",
                                                               max_depth=DEPTH),
                            spp=SPP)
    img, _ = render(ts, tm, tint.IntegratorConfig(kind="path", max_depth=DEPTH),
                    spp=SPP, device="cpu")
    img = img.numpy()
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all() and img.mean() > 0
    assert relative_mae(img, np.asarray(img_ref)) < 1e-3
