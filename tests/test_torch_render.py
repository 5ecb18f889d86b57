"""The port's path integrator and render loop against grail's on the Cornell box.

li: the same camera rays through both, per lane. At least 99% of lanes must
match to rtol 1e-4, atol 1e-6: XLA and PyTorch round some float32 sums
differently (XLA contracts multiply-adds), which can flip a Russian-roulette
or edge-hit decision on a few lanes and send them down another path.
render: the developed image's relative MAE (as tests/test_golden.py) below 1e-3.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.core import rng as jrng
from grail.engine import camera as jcam, film as jfilm
from grail.engine import integrator as jint
from grail.engine.render import render as jax_render
from grail.scene.presets import cornell_box
from grail_torch.engine import integrator as tint
from grail_torch.engine.render import render
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.scene.presets import cornell_box as torch_cornell

torch.set_num_threads(2)

RES, SPP = 32, 4          # 4096 lanes: compaction (cap 1024) runs at bounce 4


def relative_mae(a, b):
    return float(np.mean(np.abs(a - b)) / (np.mean(np.abs(b)) + 1e-6))


@pytest.fixture(scope="module")
def li_case():
    """Camera rays of one 4-spp megawave, made by the reference's raygen."""
    scene, meta, _ = cornell_box(RES, RES, SPP)
    n_pix = RES * RES
    lane = jnp.arange(n_pix, dtype=jnp.uint32)
    px_t, py_t = jfilm.lane_pixel(lane, RES)
    pix = jnp.tile(py_t.astype(jnp.uint32) * RES + px_t.astype(jnp.uint32), SPP)
    samp = jnp.repeat(jnp.arange(SPP, dtype=jnp.uint32), n_pix)
    ufx, ufy = jrng.sample_2d(meta.sampler, pix, samp, jint.SLOT_FILM)
    ul1, ul2 = jrng.sample_2d(meta.sampler, pix, samp, jint.SLOT_LENS)
    ut = jrng.sample_1d(meta.sampler, pix, samp, jint.SLOT_TIME)
    rays = jcam.generate_rays(scene["camera"], (pix % RES).astype(jnp.int32),
                              (pix // RES).astype(jnp.int32), ufx, ufy, ul1, ul2,
                              ut, meta.cam_kind)
    rays = {k: rays[k] for k in ("o", "d", "weight")}
    cfg = jint.IntegratorConfig(kind="path", max_depth=5, compact_min=4096)
    li_jit = jax.jit(partial(jint.li, scene, meta, cfg))
    L_ref = np.asarray(li_jit(rays, pix, samp))

    ts, tm = scene_from_numpy(jax.tree_util.tree_map(np.asarray, scene), meta,
                              device="cpu")
    rays_t = {k: torch.tensor(np.asarray(v)) for k, v in rays.items()}
    pix_t = torch.tensor(np.asarray(pix).astype(np.int64))
    samp_t = torch.tensor(np.asarray(samp).astype(np.int64))
    return L_ref, ts, tm, rays_t, pix_t, samp_t


def test_li_matches_reference_per_lane(li_case, monkeypatch):
    L_ref, ts, tm, rays, pix, samp = li_case
    seen = []
    take = tint._compaction_take

    def recording_take(active, cap):
        out = take(active, cap)
        seen.append((cap, int(out[1])))
        return out

    monkeypatch.setattr(tint, "_compaction_take", recording_take)
    cfg = tint.IntegratorConfig(kind="path", max_depth=5, compact_min=4096)
    L = tint.li(ts, tm, cfg, rays, pix, samp).numpy()
    # the post-RR split at bounce 4 ran, and its survivors fit the capacity
    assert len(seen) == 1 and seen[0][0] == 1024 and 0 < seen[0][1] <= 1024
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"


def test_li_halton_matches_reference_per_lane():
    """Under the HALTON sampler the reference draws bounces >= 1 with a
    traced dimension (inside lax.fori_loop), which takes base 2; bounce 0
    keeps each dimension's prime. The port's lanes must follow both."""
    res, spp = 16, 4
    scene, meta, _ = cornell_box(res, res, spp, sampler_kind=jrng.HALTON)
    n_pix = res * res
    px_t, py_t = jfilm.lane_pixel(jnp.arange(n_pix, dtype=jnp.uint32), res)
    pix = jnp.tile(py_t.astype(jnp.uint32) * res + px_t.astype(jnp.uint32), spp)
    samp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n_pix)
    ufx, ufy = jrng.sample_2d(meta.sampler, pix, samp, jint.SLOT_FILM)
    ul1, ul2 = jrng.sample_2d(meta.sampler, pix, samp, jint.SLOT_LENS)
    ut = jrng.sample_1d(meta.sampler, pix, samp, jint.SLOT_TIME)
    rays = jcam.generate_rays(scene["camera"], (pix % res).astype(jnp.int32),
                              (pix // res).astype(jnp.int32), ufx, ufy, ul1, ul2,
                              ut, meta.cam_kind)
    rays = {k: rays[k] for k in ("o", "d", "weight")}
    cfg = jint.IntegratorConfig(kind="path", max_depth=3)
    L_ref = np.asarray(jax.jit(partial(jint.li, scene, meta, cfg))(rays, pix, samp))
    ts, tm = scene_from_numpy(jax.tree_util.tree_map(np.asarray, scene), meta,
                              device="cpu")
    L = tint.li(ts, tm, tint.IntegratorConfig(kind="path", max_depth=3),
                {k: torch.tensor(np.asarray(v)) for k, v in rays.items()},
                torch.tensor(np.asarray(pix).astype(np.int64)),
                torch.tensor(np.asarray(samp).astype(np.int64))).numpy()
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"


def test_compaction_is_bitwise_exact(li_case):
    _, ts, tm, rays, pix, samp = li_case
    packed = tint.li(ts, tm, tint.IntegratorConfig(compact_min=4096), rays, pix, samp)
    full = tint.li(ts, tm, tint.IntegratorConfig(compact=False), rays, pix, samp)
    assert torch.equal(packed, full)


def test_render_matches_reference():
    scene, meta, _ = cornell_box(16, 16, 4)
    img_ref, _ = jax_render(scene, meta, jint.IntegratorConfig(kind="path", max_depth=3),
                            spp=4)
    ts, tm, _ = torch_cornell(16, 16, 4, device="cpu")
    cfg = tint.IntegratorConfig(kind="path", max_depth=3)
    img, film = render(ts, tm, cfg, spp=4, device="cpu")
    img = img.numpy()
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert relative_mae(img, np.asarray(img_ref)) < 1e-3
    # one sample per megawave gives the same film bit for bit
    _, film_1 = render(ts, tm, cfg, spp=4, spp_chunk=1, device="cpu")
    for k in film:
        assert torch.equal(film[k], film_1[k]), k


def test_entry_points_refuse_cpu_without_request(monkeypatch):
    ts, tm, _ = torch_cornell(16, 16, 1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        render(ts, tm, tint.IntegratorConfig(max_depth=1), spp=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_cornell(16, 16, 1)
