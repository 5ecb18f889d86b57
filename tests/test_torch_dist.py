"""The port's multi-process paths (grail_torch/dist/sharding.py,
photonmap.shoot_photons_sharded, metropolis.render_mlt_sharded, entry.py)
against grail's, on the CPU.

The port's ranks are gloo CPU processes spawned by
grail_torch.dist.launch.run_ranks (tests/torch_dist_ranks.py: no JAX,
inputs from the port's presets); each world size runs once, in a module
fixture, and the tests read its results. The reference runs in this
process on conftest's 8 virtual CPU devices.

- add_samples_band equals the reference's on the same inputs (rtol 1e-4,
  atol 1e-6, as tests/test_torch_render.py), raster and tiled, margin 1
  and 2.
- render_sharded at 2 and 4 ranks, fused and not: the reference's render
  within atol 2e-5 (tests/test_sharding.py) and the port's own render.
- make_train_step: at world size 1 its loss equals the reference's
  make_train_step over an 8-device mesh (rtol 1e-5) and its gradients lie
  within PERF.md's gradient gate of the reference's (rtol 1e-3, atol 2e-3
  of the largest entry); at 2 and 4 ranks loss and gradients equal world
  size 1's (rtol 1e-5): the film's reduce must not scale the gradient.
- the sharded photon shoot at 2 and 4 ranks: its raw photons and grid equal
  the port's replicated shoot bitwise, and its raw photons hold against
  the reference's as tests/test_torch_photon.py holds the replicated ones.
- render_mlt_sharded at 2 ranks against the port's render_mlt (atol 1e-4,
  rtol 1e-3, tests/test_sharding.py); test_torch_mlt.py holds render_mlt
  against the reference.
- entry.dryrun_multichip at 2 CPU ranks; run_ranks fails a call whose rank
  raises or hangs, within its timeout.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.dist.sharding import make_mesh as jax_mesh, make_train_step as jax_train_step
from grail.engine import film as jfilm
from grail.engine import filters as jfilters
from grail.engine import photonmap as jph
from grail.engine.integrator import IntegratorConfig as JaxConfig
from grail.engine.render import render as jax_render
from grail.scene.presets import cornell_box as jax_cornell
from grail_torch.dist.launch import run_ranks
from grail_torch.dist.sharding import make_mesh, make_train_step
from grail_torch.engine import film as flm
from grail_torch.engine import filters as tfilters
from grail_torch.engine import metropolis as mlt
from grail_torch.engine import photonmap
from grail_torch.engine.render import render
from grail_torch.entry import dryrun_multichip
from grail_torch.scene.presets import cornell_box

import torch_dist_ranks as R

TIMEOUT_S = 110
JOBS = {2: [("render", ()), ("train", ()), ("photon", ()), ("mlt", ())],
        4: [("render", ()), ("train", ()), ("photon", ())]}


@pytest.fixture(scope="module")
def ranks():
    """{world size: [each rank's results]} of the port's ranks."""
    return {n: run_ranks(R.run_jobs, n, "cpu", TIMEOUT_S, (jobs,))
            for n, jobs in JOBS.items()}


@pytest.fixture(scope="module")
def single():
    """The port at world size 1, in this process: render, train step,
    replicated photon shoot, render_mlt."""
    torch.set_num_threads(2)
    scene, meta, _ = cornell_box(R.RES, R.RES, R.SPP, device="cpu")
    loss, grads = make_train_step(meta, R.DIRECT, make_mesh(1, "cpu"))(
        scene, torch.zeros((meta.yres, meta.xres, 3)), 0)
    s8, m8, _ = cornell_box(8, 8, 1, device="cpu")
    sm, mm, _ = cornell_box(R.RES, R.RES, R.SPP, with_boxes=False, device="cpu")
    return {"render": render(scene, meta, R.DIRECT, spp=R.SPP, device="cpu")[0].numpy(),
            "loss": float(loss), **{f"grad_{k}": v.numpy() for k, v in grads["tex_data"].items()},
            "raw": {k: v.numpy() for k, v in
                    photonmap._shoot_block(s8, m8, R.PHOTONS, 0, R.PHOTONS.n_paths).items()},
            "grid": {k: v.numpy() for k, v in photonmap.shoot_photons(s8, m8, R.PHOTONS).items()},
            "mlt": mlt.render_mlt(sm, mm, R.MLT_CFG, n_waves=R.MLT_WAVES, device="cpu")[0].numpy()}


@pytest.fixture(scope="module")
def reference():
    """The reference's render, train step (8-device mesh) and raw photons."""
    js, jm, _ = jax_cornell(xres=R.RES, yres=R.RES, spp=R.SPP)
    jcfg = JaxConfig(kind="direct", max_depth=1)
    img = jax_render(js, jm, jcfg, spp=R.SPP)[0]
    loss, grads = jax_train_step(jm, jcfg, jax_mesh(8))(
        js, jnp.zeros((jm.yres, jm.xres, 3), jnp.float32), jnp.uint32(0))
    s8, m8, _ = jax_cornell(xres=8, yres=8, spp=1)
    pcfg = jph.PhotonConfig(n_paths=R.PHOTONS.n_paths, radius=R.PHOTONS.radius)
    raw = jax.jit(lambda: jph._shoot_block(s8, m8, pcfg, jnp.uint32(0), pcfg.n_paths))()
    return {"render": np.asarray(img), "loss": float(loss),
            **{f"grad_{k}": np.asarray(v) for k, v in grads["tex_data"].items()},
            "raw": jax.tree_util.tree_map(np.asarray, raw)}


@pytest.mark.parametrize("tiled", (False, True), ids=("raster", "tiled"))
@pytest.mark.parametrize("margin", (1, 2))
def test_add_samples_band_matches_reference(tiled, margin):
    rows, xres, y0 = 8, 16, 24
    rng = np.random.RandomState(7 + margin)
    lane = np.arange(rows * xres)
    if tiled:
        px, py = (v.numpy() for v in flm.lane_pixel(torch.tensor(lane), xres))
    else:
        px, py = lane % xres, lane // xres
    sx = (px + rng.uniform(0, 1, lane.shape)).astype(np.float32)
    sy = (y0 + py + rng.uniform(0, 1, lane.shape)).astype(np.float32)
    L = rng.uniform(0, 2, (lane.size, 3)).astype(np.float32)
    w = (rng.uniform(0, 1, lane.shape) < 0.8).astype(np.float32)
    film0 = {k: rng.uniform(0, 1, (rows + 2 * margin, xres) + ((3,) if k != "weight" else ()))
             .astype(np.float32) for k in ("rgb", "weight", "splat")}
    width = dict(xwidth=1.5, ywidth=margin + 0.4)
    ref = jfilm.add_samples_band({k: jnp.asarray(v) for k, v in film0.items()},
                                 jfilters.FilterConfig.from_name("gaussian", **width),
                                 jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(L), None,
                                 margin, weight=jnp.asarray(w), tiled=tiled)
    got = flm.add_samples_band({k: torch.tensor(v) for k, v in film0.items()},
                               tfilters.FilterConfig.from_name("gaussian", **width),
                               torch.tensor(sx), torch.tensor(sy), torch.tensor(L), margin,
                               weight=torch.tensor(w), tiled=tiled)
    for k in film0:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert not np.allclose(got["weight"].numpy(), film0["weight"])


@pytest.mark.parametrize("fused", (True, False), ids=("fused", "unfused"))
@pytest.mark.parametrize("world", (2, 4))
def test_render_sharded_matches_reference(ranks, single, reference, world, fused):
    key = "render_fused" if fused else "render_unfused"
    for out in ranks[world]:
        img = out[key]
        assert img.shape == (R.RES, R.RES, 3) and img.mean() > 1e-3
        np.testing.assert_allclose(img, reference["render"], atol=2e-5)
        np.testing.assert_allclose(img, single["render"], atol=2e-5)


def _within_gate(got, ref, rtol=1e-3, atol_frac=2e-3):
    ok = np.isfinite(ref)
    assert ok.mean() > 0.5
    atol = atol_frac * np.abs(ref[ok]).max()
    np.testing.assert_allclose(got[ok], ref[ok], rtol=rtol, atol=atol)


def test_train_step_matches_reference(single, reference):
    assert single["loss"] > 0
    np.testing.assert_allclose(single["loss"], reference["loss"], rtol=1e-5)
    for k in ("const", "w2t"):
        g = single[f"grad_{k}"]
        assert g.shape == reference[f"grad_{k}"].shape and np.isfinite(g).all()
        _within_gate(g, reference[f"grad_{k}"])
    assert np.abs(single["grad_const"]).sum() > 0


@pytest.mark.parametrize("world", (2, 4))
def test_train_step_grads_do_not_scale_with_world_size(ranks, single, world):
    for out in ranks[world]:
        np.testing.assert_allclose(out["loss"], single["loss"], rtol=1e-5)
        for k in ("const", "w2t"):
            a, b = out[f"grad_{k}"], single[f"grad_{k}"]
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("world", (2, 4))
def test_shoot_photons_sharded_bitwise(ranks, single, reference, world):
    for out in ranks[world]:
        for k, v in single["raw"].items():
            np.testing.assert_array_equal(out[f"raw_{k}"], v, err_msg=k)
        for k, v in single["grid"].items():
            np.testing.assert_array_equal(out[f"grid_{k}"], v, err_msg=k)
    # the gathered photons against the reference's, as test_torch_photon.py
    got, ref = ranks[world][0], reference["raw"]
    np.testing.assert_array_equal(got["raw_valid"], ref["valid"])
    np.testing.assert_array_equal(got["raw_caustic"], ref["caustic"])
    ok = ref["valid"]
    assert ok.sum() > 400
    for rtol, share in ((1e-5, 0.99), (1e-3, 1.0)):
        close = np.ones(int(ok.sum()), bool)
        for k in ("p", "alpha", "wi"):
            g, r = got[f"raw_{k}"][ok], ref[k][ok]
            close &= np.all(np.abs(g - r) <= 1e-6 + rtol * np.abs(r), axis=-1)
        assert close.mean() >= share, f"{close.mean():.4%} of photons within {rtol}"


def test_render_mlt_sharded_matches_render_mlt(ranks, single):
    a = single["mlt"]
    assert a.mean() > 0
    for out in ranks[2]:
        b = out["mlt"]
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-3)


def test_render_mlt_sharded_refuses_uneven_chains():
    scene, meta, _ = cornell_box(8, 8, 1, with_boxes=False, device="cpu")
    mesh = make_mesh(1, "cpu")
    odd = mlt.MLTConfig(max_depth=2, n_chains=3, n_bootstrap=3)
    with pytest.raises(ValueError, match="n_chains"):
        mlt.render_mlt_sharded(scene, meta, odd, 1, type(mesh)(2, 0, mesh.device))


def test_dryrun_multichip_on_cpu_ranks():
    loss, gnorm = dryrun_multichip(2, device="cpu", timeout_s=TIMEOUT_S)
    assert np.isfinite(loss) and loss > 0 and np.isfinite(gnorm) and gnorm > 0


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="fails on purpose"):
        run_ranks(R.failing, 2, "cpu", TIMEOUT_S)


def test_run_ranks_times_out_a_hung_rank():
    import time
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        run_ranks(R.hanging, 2, "cpu", 8)
    assert time.monotonic() - t0 < 30
