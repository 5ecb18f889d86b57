"""The port's irradiance cache (grail_torch/engine/irradiance.py) against
the reference's grail/engine/irradiance.py on scenes/irradcache.pbrt at
16x16.

Both packages parse the same text (the integrator's settings equal). The
preprocess runs with ic_nsamples 8 in place of the scene's 64 (the
reference unrolls every gather into one XLA program, and 64 take it
minutes to compile); its 256 entries (valid equal; p, n, E and max_dist
within rtol 1e-5, atol 1e-6, the port's tolerance for float stages, on >=
99.9% of them) and its 25 "ic_preprocess" waves (the seed rays, then a
gather, its shadow ray and its BSDF branch a sample). _interpolate on 4,096
seeded points and normals against the reference's entries, within rtol
1e-5, atol 1e-6 per lane, and the same bitwise whatever the lane chunk;
irradiancecache_li given the reference's entries, >= 99% of lanes within
rtol 1e-4, atol 1e-6, as tests/test_torch_media_goldens.py. The
reference's programs are compiled on threads.
"""
from concurrent.futures import ThreadPoolExecutor
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.engine import irradiance as jirr
from grail.scene import parser as jparser
from grail_torch.engine import integrator as tint
from grail_torch.engine import irradiance as tirr
from grail_torch.scene import parser as tparser
from grail_torch.scene.bridge import aux_from_numpy
from tests.test_torch_goldens import _close
from tests.test_torch_media import reference_rays, to_torch
from tests.test_torch_photon import lanes_close, scene_text, tree_np

torch.set_num_threads(2)

NSAMPLES = 8


@pytest.fixture(scope="module")
def cache():
    text = scene_text("irradcache")
    js, jm, japi = jparser.parse_string(text)
    jcfg = dataclasses.replace(japi.integrator_config, ic_nsamples=NSAMPLES)
    rays, pix, samp = reference_rays(js, jm)
    n_entries = jcfg.ic_grid[0] * jcfg.ic_grid[1]
    shapes = {"p": (n_entries, 3), "n": (n_entries, 3), "E": (n_entries, 3),
              "max_dist": (n_entries,)}
    aux_spec = {k: jax.ShapeDtypeStruct(s, jnp.float32) for k, s in shapes.items()}
    aux_spec["valid"] = jax.ShapeDtypeStruct((n_entries,), jnp.bool_)

    def li(rays, pix, samp, aux):
        return jirr.irradiancecache_li(js, jm, jcfg, rays, pix, samp, aux)

    with ThreadPoolExecutor(2) as pool:
        pre = pool.submit(jirr.irradiance_preprocess, js, jm, jcfg)
        li_job = pool.submit(jax.jit(li).lower(rays, pix, samp, aux_spec).compile)
        aux = pre.result()
        L_ref = li_job.result()(rays, pix, samp, aux)
    yield {"ported": tparser.parse_string(text, device="cpu"), "japi": japi, "cfg": jcfg,
           "aux": tree_np(aux), "rays": (rays, pix, samp), "L": np.asarray(L_ref)}


def test_config_and_preprocess_match_reference(cache):
    ts, tm, tapi = cache["ported"]
    tcfg = tapi.integrator_config
    jcfg = cache["japi"].integrator_config
    for field in ("kind", "ic_nsamples", "ic_maxerror", "ic_grid"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert tcfg.ic_nsamples == 64 and abs(tcfg.ic_maxerror - 0.2) < 1e-7
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    got = tirr.irradiance_preprocess(ts, tm, dataclasses.replace(tcfg, ic_nsamples=NSAMPLES))
    assert {k: v for k, v in tint.WAVES.items() if v} == {"ic_preprocess": 1 + 3 * NSAMPLES}
    ref = cache["aux"]
    np.testing.assert_array_equal(got["valid"].numpy(), ref["valid"])
    ok = ref["valid"]
    assert ok.mean() > 0.6 and (ref["E"][ok] > 0).any(axis=-1).mean() > 0.5   # an open box
    close = np.ones(ok.shape, bool)
    for key in ("p", "n", "E", "max_dist"):
        g, r = got[key].numpy(), ref[key]
        close &= np.all((np.abs(g - r) <= 1e-6 + 1e-5 * np.abs(r)).reshape(len(r), -1),
                        axis=-1)
    assert close.mean() >= 0.999, f"{close.mean():.4%} of entries match"


def test_interpolate_matches_reference(cache, monkeypatch):
    rng = np.random.default_rng(40)
    p = rng.uniform([-1, 0, -1], [1, 2, 1], (4096, 3)).astype(np.float32)
    n = rng.normal(size=(4096, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    aux = cache["aux"]
    ref = np.asarray(jirr._interpolate({k: jnp.asarray(v) for k, v in aux.items()},
                                       jnp.asarray(p), jnp.asarray(n), 0.2))
    taux = aux_from_numpy(aux, device="cpu")
    got = tirr._interpolate(taux, torch.tensor(p), torch.tensor(n), 0.2)
    _close(got, ref, "E")
    monkeypatch.setattr(tirr, "LANE_CHUNK", 1000)       # five chunks, one ragged
    np.testing.assert_array_equal(
        tirr._interpolate(taux, torch.tensor(p), torch.tensor(n), 0.2).numpy(), got.numpy())


def test_li_matches_reference_per_lane(cache):
    ts, tm, _ = cache["ported"]
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    L = tirr.irradiancecache_li(ts, tm, cache["cfg"], *to_torch(*cache["rays"]),
                                aux_from_numpy(cache["aux"], device="cpu")).numpy()
    assert {k: v for k, v in tint.WAVES.items() if v} == {"camera": 1, "shadow": 1,
                                                          "bsdf": 1}
    assert np.isfinite(L).all() and L.mean() > 0.05
    close = lanes_close(L, cache["L"])
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"
