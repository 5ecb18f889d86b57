"""The port's instant global illumination (grail_torch/engine/igi.py)
against the reference's grail/engine/igi.py.

scenes/cornell.pbrt with its integrator line made SurfaceIntegrator "igi"
at 16x16, parsed by both packages (the integrator's settings equal; the
reference's programs are compiled on threads). Held: generate_vpls for
sets 0 and 3 (64 paths, 3 depths: valid equal, and p, n and alpha, the
reference's contrib, of every valid VPL within rtol 1e-5, atol 1e-6, the
port's tolerance for float stages; the port's contrib is alpha times
rho/pi, pbrt's, with rho one of the scene's diffuse reflectances: ROADMAP
C.13), with its 3 "vpl_path" waves; vpl_radiance at the
reference's camera hits and shading, given the reference's VPLs, with one
"vpl_shadow" wave a VPL (>= 99% of lanes within rtol 1e-4, atol 1e-6, as
tests/test_torch_media_goldens.py), against the reference patched in
process: its visibility rays reach the VPL's own surface (ROADMAP C.12),
so the test shortens them, inside the reference's intersect_p, to the
port's 2 ray_eps short of the VPL (the unpatched reference's VPL term is
held to show the fault: under 5% of the patched one's); li's set choice
(the wave's first sample index modulo igi_n_sets); and
tests/test_render.py's check that the VPL estimate lands near the path
tracer, on the port's Cornell box, and, with C.12 and C.13 repaired,
within 10% of it.
"""
from concurrent.futures import ThreadPoolExecutor
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.engine import igi as jigi
from grail.engine import integrator as jint
from grail.kernels import intersect as jisect
from grail.scene import parser as jparser
from grail_torch.engine import igi as tigi
from grail_torch.engine import integrator as tint
from grail_torch.engine.render import render
from grail_torch.scene import parser as tparser
from grail_torch.scene.bridge import aux_from_numpy
from grail_torch.scene.presets import cornell_box
from tests.test_torch_media import reference_rays
from tests.test_torch_photon import lanes_close, scene_text, tree_np, tree_torch

torch.set_num_threads(2)

SETS = (0, 3)


def igi_text():
    return scene_text("cornell").replace('SurfaceIntegrator "path"', 'SurfaceIntegrator "igi"')


@pytest.fixture(scope="module")
def igi():
    text = igi_text()
    js, jm, japi = jparser.parse_string(text)
    jcfg = japi.integrator_config
    rays, _, _ = reference_rays(js, jm)

    def vpls(set_idx):
        return jigi.generate_vpls(js, jm, jcfg, set_idx)

    def context(rays):
        o, d = rays["o"], rays["d"]
        hit = jisect.intersect(js, o, d, jint.BIG * jnp.ones((o.shape[0],)))
        sg, lobes, wo = jint._shade_context(js, jm, hit, o, d)
        return hit["prim"] >= 0, sg, lobes, wo

    with ThreadPoolExecutor(3) as pool:
        v_job = pool.submit(jax.jit(vpls).lower(jnp.uint32(0)).compile)
        c_job = pool.submit(jax.jit(context).lower(rays).compile)
        sets = {s: v_job.result()(jnp.uint32(s)) for s in SETS}
        ctx = c_job.result()(rays)

        def radiance(ctx, vp):
            active, sg, lobes, wo = ctx
            return jigi.vpl_radiance(js, jm, jcfg, sg, lobes, wo, vp, active)

        def shortened(ctx, vp):
            # the reference's ray ends at 0.999 of the VPL's distance from
            # an origin moved ray_eps toward it: recover the distance and end
            # the ray 2 ray_eps short of the VPL, as the port does
            eps = ctx[1]["ray_eps"]
            intersect_p = jisect.intersect_p

            def patched(scene, o, d, tmax):
                return intersect_p(scene, o, d,
                                   jnp.where(tmax > 0, tmax / (1 - 1e-3) - 2.0 * eps, 0.0))
            with mock.patch.object(jigi.isect, "intersect_p", patched):
                return radiance(ctx, vp)

        L_fault = jax.jit(radiance)(ctx, sets[0])
        L_ref = jax.jit(shortened)(ctx, sets[0])
    yield {"ported": tparser.parse_string(text, device="cpu"), "jcfg": jcfg,
           "sets": {s: tree_np(v) for s, v in sets.items()}, "ctx": ctx,
           "L": np.asarray(L_ref), "L_fault": np.asarray(L_fault)}


def test_config_matches_reference(igi):
    tcfg = igi["ported"][2].integrator_config
    jcfg = igi["jcfg"]
    assert tcfg.kind == "igi"
    for field in ("igi_n_paths", "igi_n_sets", "igi_max_depth", "igi_g_limit", "max_depth"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("set_idx", SETS)
def test_generate_vpls_matches_reference(igi, set_idx):
    ts, tm, tapi = igi["ported"]
    cfg = tapi.integrator_config
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    got = tigi.generate_vpls(ts, tm, cfg, set_idx)
    assert {k: v for k, v in tint.WAVES.items() if v} == {"vpl_path": cfg.igi_max_depth}
    ref = igi["sets"][set_idx]
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    ok = ref["valid"]
    assert got["p"].shape == (cfg.igi_n_paths * cfg.igi_max_depth, 3) and ok.sum() > 32
    for key, ref_key in (("p", "p"), ("n", "n"), ("alpha", "contrib")):
        np.testing.assert_allclose(got[key].numpy()[ok], ref[ref_key][ok], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    alpha, contrib = got["alpha"].numpy()[ok], got["contrib"].numpy()[ok]
    # the walls' Kd, and the default matte's under the light quad
    kd = np.asarray([[0.725, 0.71, 0.68], [0.63, 0.065, 0.05], [0.14, 0.45, 0.091],
                     [0.5, 0.5, 0.5]], np.float32)
    off = np.abs(contrib[:, None, :] - alpha[:, None, :] * kd[None] / np.pi).max(-1)
    bad = off.min(axis=1) > 1e-6 + 1e-5 * np.abs(contrib).max(-1)
    assert not bad.any(), (off.min(axis=1)[bad], contrib[bad], alpha[bad])


def test_vpl_radiance_matches_reference_per_lane(igi):
    ts, tm, tapi = igi["ported"]
    active, sg, lobes, wo = (tree_torch(x) for x in igi["ctx"])
    vpls = aux_from_numpy(igi["sets"][0], device="cpu")
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    L = tigi.vpl_radiance(ts, tm, tapi.integrator_config, sg, lobes, wo, vpls,
                          active).numpy()
    assert {k: v for k, v in tint.WAVES.items() if v} == {"vpl_shadow": vpls["p"].shape[0]}
    assert np.isfinite(L).all() and L.mean() > 0.01
    assert igi["L_fault"].mean() < 0.05 * igi["L"].mean()        # ROADMAP C.12
    close = lanes_close(L, igi["L"])
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"


def test_li_draws_the_set_of_its_first_sample(igi, monkeypatch):
    ts, tm, tapi = igi["ported"]
    cfg = tapi.integrator_config
    drawn = []
    generate = tigi.generate_vpls

    def spy(scene, meta, cfg, set_idx):
        drawn.append(set_idx)
        return generate(scene, meta, cfg, set_idx)

    monkeypatch.setattr(tigi, "generate_vpls", spy)
    # no bounce after the camera's, few paths: only the draw is held here
    render(ts, tm, dataclasses.replace(cfg, max_depth=0, igi_n_paths=2), spp=6,
           spp_chunk=1, device="cpu")
    assert drawn == [s % cfg.igi_n_sets for s in range(6)]


def test_igi_approximates_path():
    """tests/test_render.py's VPL check on the port."""
    scene, meta, _ = cornell_box(16, 16, 4, device="cpu")
    igi_img = render(scene, meta, tint.IntegratorConfig(
        kind="igi", max_depth=2, igi_n_paths=32, igi_n_sets=2, igi_max_depth=3), spp=4,
        device="cpu")[0].numpy()
    path = render(scene, meta, tint.IntegratorConfig(kind="path", max_depth=5), spp=4,
                  device="cpu")[0].numpy()
    assert np.isfinite(igi_img).all()
    assert 0.5 * path.mean() < igi_img.mean() < 1.3 * path.mean()
    assert abs(igi_img.mean() / path.mean() - 1.0) < 0.1
