"""The port's photon map (grail_torch/engine/photonmap.py) against the
reference's grail/engine/photonmap.py on scenes/photon.pbrt at 16x16.

Both packages parse the same text. In a module fixture the reference's
lookups and photon_li are traced in turn and compiled on threads (XLA
takes most of a minute over photon_li's 189 scan loops). Held:
  * the raw photon arrays of the shoot (2,048 paths, 5 depths): valid and
    caustic equal, >= 99% of the valid photons with p, alpha and wi within
    rtol 1e-5, atol 1e-6 (the port's tolerance for float stages) and all
    within rtol 1e-3: an emission direction near the light's plane takes
    the square root of 1 - dx^2 - dy^2 after cancellation, where XLA's
    fused multiply-adds round otherwise, and the ray's grazing hit carries
    that difference on (3 of the 547 photons here, all at their first
    deposit);
  * build_photon_grid on the reference's own photons: every field bitwise,
    the order included (a stable sort of the same cell ids);
  * on the reference's camera hits, shading and map: knn_radius2 for both
    maps, radiance_estimate on the indirect map and gather_photon_dirs, per
    lane within rtol 1e-5, atol 1e-6 (the directions' counts exactly; the
    scene's plastic has no specular lobe, so its caustic map is empty);
  * photon_li given the reference's map (scene/bridge.py aux_from_numpy):
    >= 99% of lanes within rtol 1e-4, atol 1e-6, as
    tests/test_torch_media_goldens.py, and its waves by role;
  * tests/test_render.py's check that photon mapping lands near the path
    tracer, on the port's Cornell box (brute force).
"""
from concurrent.futures import ThreadPoolExecutor
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.engine import integrator as jint
from grail.engine import photonmap as jph
from grail.kernels import intersect as jisect
from grail.scene import parser as jparser
from grail_torch.engine import integrator as tint
from grail_torch.engine import photonmap as tph
from grail_torch.engine.render import render
from grail_torch.scene import parser as tparser
from grail_torch.scene.bridge import aux_from_numpy
from grail_torch.scene.presets import cornell_box
from tests.test_torch_goldens import _close
from tests.test_torch_media import RES, reference_rays, to_torch

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), os.pardir, "scenes")


def scene_text(name, res=RES):
    with open(os.path.join(SCENES, name + ".pbrt")) as f:
        return re.sub(r'"integer xresolution" \[\d+\] "integer yresolution" \[\d+\]',
                      f'"integer xresolution" [{res}] "integer yresolution" [{res}]',
                      f.read())


def tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tree_torch(tree):
    return aux_from_numpy(tree_np(tree), device="cpu")


def lanes_close(L, L_ref, rtol=1e-4, atol=1e-6):
    return np.all(np.abs(L - L_ref) <= atol + rtol * np.abs(L_ref), axis=-1)


@pytest.fixture(scope="module")
def photon():
    """Both parses, the reference's raw photons, grid, camera-hit shading,
    lookups and photon_li on its own map."""
    text = scene_text("photon")
    js, jm, japi = jparser.parse_string(text)
    jcfg = japi.integrator_config
    pcfg = jph.PhotonConfig(n_paths=jcfg.photon_paths, radius=jcfg.photon_radius,
                            final_gather=jcfg.photon_final_gather)
    raw = jax.jit(lambda: jph._shoot_block(js, jm, pcfg, jnp.uint32(0), pcfg.n_paths))()
    pmap = jph.build_photon_grid(js, raw, pcfg)
    rays, pix, samp = reference_rays(js, jm)

    def context(rays):
        o, d = rays["o"], rays["d"]
        hit = jisect.intersect(js, o, d, jint.BIG * jnp.ones((o.shape[0],)))
        sg, lobes, wo = jint._shade_context(js, jm, hit, o, d)
        return hit["prim"] >= 0, sg, lobes, wo

    active, sg, lobes, wo = jax.jit(context)(rays)

    def lookups(active, sg, lobes, wo):
        return (jph.knn_radius2(js, pcfg, pmap, sg, True, active),
                jph.knn_radius2(js, pcfg, pmap, sg, False, active),
                jph.radiance_estimate(js, jm, pcfg, pmap, sg, lobes, wo, False, active),
                jph.gather_photon_dirs(js, pcfg, pmap, sg, active))

    def li(rays, pix, samp):
        return jph.photon_li(js, jm, pcfg, jcfg, rays, pix, samp, pmap)

    ctx = (active, sg, lobes, wo)
    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(jax.jit(li).lower(rays, pix, samp).compile),
                pool.submit(jax.jit(lookups).lower(*ctx).compile)]
        L_ref, look = jobs[0].result()(rays, pix, samp), jobs[1].result()(*ctx)
    yield {"ported": tparser.parse_string(text, device="cpu"), "pcfg": pcfg,
           "raw": tree_np(raw), "pmap": tree_np(pmap), "rays": (rays, pix, samp),
           "ctx": ctx, "lookups": tree_np(look), "L": np.asarray(L_ref)}


def test_config_and_shoot_match_reference(photon):
    ts, tm, tapi = photon["ported"]
    pcfg = photon["pcfg"]
    tcfg = tapi.integrator_config
    assert (tcfg.kind, tcfg.photon_paths, tcfg.photon_radius) == ("photon", 2048, 0.25)
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    got = tph._shoot_block(ts, tm, tph.PhotonConfig(**vars(pcfg)), 0, pcfg.n_paths)
    assert tint.WAVES["photon_shoot"] == pcfg.max_depth
    ref = photon["raw"]
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    np.testing.assert_array_equal(got["caustic"].numpy(), ref["caustic"])
    ok = ref["valid"]
    assert ok.sum() > 400 and not ref["caustic"].any()
    for rtol, share in ((1e-5, 0.99), (1e-3, 1.0)):
        close = np.ones(int(ok.sum()), bool)
        for key in ("p", "alpha", "wi"):
            g, r = got[key].numpy()[ok], ref[key][ok]
            close &= np.all(np.abs(g - r) <= 1e-6 + rtol * np.abs(r), axis=-1)
        assert close.mean() >= share, f"{close.mean():.4%} of photons within {rtol}"


def test_grid_matches_reference_bitwise(photon):
    raw = {k: torch.tensor(v) for k, v in photon["raw"].items()}
    got = tph.build_photon_grid(raw, photon["pcfg"])
    assert got.keys() == photon["pmap"].keys()
    for key, ref in photon["pmap"].items():
        assert got[key].dtype == torch.tensor(ref).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)


def test_lookups_match_reference(photon):
    pcfg = photon["pcfg"]
    ts, tm, _ = photon["ported"]
    active, sg, lobes, wo = (tree_torch(x) for x in photon["ctx"])
    pmap = aux_from_numpy(photon["pmap"], device="cpu")
    rk_c, rk_i, est, (dirs, cnt) = photon["lookups"]
    assert active.float().mean() > 0.9
    _close(tph.knn_radius2(pcfg, pmap, sg["p"], True, active), rk_c, "caustic radius")
    rk = tph.knn_radius2(pcfg, pmap, sg["p"], False, active)
    _close(rk, rk_i, "indirect radius")
    assert (rk.numpy() < pcfg.radius ** 2).any()     # the k-NN radius shrinks somewhere
    got = tph.radiance_estimate(tm, pcfg, pmap, sg, lobes, wo, False, active)
    assert (est > 0).any(axis=-1).mean() > 0.3
    _close(got, est, "indirect estimate")
    gd, gc = tph.gather_photon_dirs(pcfg, pmap, sg["p"], active)
    np.testing.assert_array_equal(gc.numpy(), cnt)
    _close(gd, dirs, "photon directions")


def test_photon_li_matches_reference_per_lane(photon):
    ts, tm, tapi = photon["ported"]
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    L = tph.photon_li(ts, tm, photon["pcfg"], tapi.integrator_config,
                      *to_torch(*photon["rays"]),
                      aux_from_numpy(photon["pmap"], device="cpu")).numpy()
    assert {k: v for k, v in tint.WAVES.items() if v} == {
        "camera": 1, "shadow": 1, "bsdf": 1, "final_gather": 2}
    L_ref = photon["L"]
    assert np.isfinite(L).all() and L.mean() > 0.05
    close = lanes_close(L, L_ref)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"


def test_photonmap_approximates_path():
    """tests/test_render.py's photon-map ballpark check on the port."""
    scene, meta, _ = cornell_box(16, 16, 4, device="cpu")
    cfg = tint.IntegratorConfig(kind="photon", photon_paths=4096, photon_radius=0.3)
    ph = render(scene, meta, cfg, spp=4, device="cpu")[0].numpy()
    path = render(scene, meta, tint.IntegratorConfig(kind="path", max_depth=5), spp=4,
                  device="cpu")[0].numpy()
    assert np.isfinite(ph).all()
    assert 0.5 * path.mean() < ph.mean() < 1.4 * path.mean()
