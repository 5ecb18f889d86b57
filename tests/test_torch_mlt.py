"""The port's Metropolis renderer (grail_torch/engine/metropolis.py) against
the reference's, on scenes/mlt.pbrt (its text with the resolution made
16x16; 4,104 triangles, a glass sphere) and on the cornell_small preset (the
Cornell box at 16x16, 36 triangles, brute force).

The reference runs eagerly, op by op, and on mlt.pbrt without its BVH, so
that its own all-pairs intersector answers every wave: the same hits as its
BVH walk, whose while loops inside one jitted bidirectional evaluation take
XLA minutes to compile. The port runs its 4-wide walk's plain version.

- per lane: 256 primary-sample vectors drawn as _bootstrap draws them
  (bitwise the same in both packages) through eval_path and
  eval_path_bidir, the latter with direct_separate off and on; at least 99%
  of lanes within rtol 1e-4, atol 1e-6 of the reference's L (float32 sums
  that XLA rounds otherwise can flip a BSDF component pick or an edge hit on
  a few lanes), the raster coordinates equal; the waves by role;
- _mutate bitwise (the keys, the sampler dimensions and the small step's
  exp as the reference's compiled exp rounds it);
- _bootstrap: b within rtol 1e-5, at least 99% of the chain starts the same
  (a start moves only where its pick lands within float noise of a CDF
  step);
- one _mlt_wave of 256 chains and 2 mutations: at least 99% of the chains
  end in the same state, the splat film within relative MAE 1e-3. A chain
  splits off only where an acceptance test lands within float noise of its
  acceptance probability a;
- the port's twins of tests/test_render.py's MLT mean checks, at the
  reference's settings: the MLT image mean against the port's own path
  render (rtol 0.25), and the bidirectional against the unidirectional
  bootstrap mean (< 0.12).
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.core import rng as jrng
from grail.engine import film as jfilm
from grail.engine import metropolis as jmlt
from grail.scene import parser as jparser
from grail.scene.presets import cornell_box as jcornell
from grail_torch.core import rng as trng
from grail_torch.core.spectrum import luminance
from grail_torch.engine import film as tfilm
from grail_torch.engine import integrator as tint
from grail_torch.engine import metropolis as tmlt
from grail_torch.engine.render import render
from grail_torch.scene import parser as tparser
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.scene.presets import cornell_box as tcornell

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), os.pardir, "scenes")
RES = 16
N = 256


def relative_mae(a, b):
    return float(np.mean(np.abs(a - b)) / (np.mean(np.abs(b)) + 1e-6))


def mlt_text(res):
    with open(os.path.join(SCENES, "mlt.pbrt")) as f:
        return re.sub(r'"integer xresolution" \[\d+\] "integer yresolution" \[\d+\]',
                      f'"integer xresolution" [{res}] "integer yresolution" [{res}]',
                      f.read())


def _to_port(cfg):
    return tmlt.MLTConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def scenes():
    """{name: (reference scene, meta, MLTConfig; port scene, meta, MLTConfig)}."""
    text = mlt_text(RES)
    js, jm, japi = jparser.parse_string(text, search_path=SCENES)
    ts, tm, tapi = tparser.parse_string(text, device="cpu", search_path=SCENES)
    assert tapi.mlt_config == _to_port(japi.mlt_config) and tapi.mlt_spp == japi.mlt_spp
    assert tm.n_tris > 2048 and ts["bvh"] is not None
    cs, cm, _ = jcornell(xres=RES, yres=RES, spp=4)          # cornell_small
    ccfg = jmlt.MLTConfig(bidirectional=True)
    cts, ctm = scene_from_numpy(jax.tree_util.tree_map(np.asarray, cs), cm, device="cpu")
    return {"mlt": (dict(js, bvh=None), jm, japi.mlt_config, ts, tm, tapi.mlt_config),
            "cornell_small": (cs, cm, ccfg, cts, ctm, _to_port(ccfg))}


def bootstrap_u(cfg, n=N, seed=0):
    """The reference's and the port's u of _bootstrap's draw, checked
    bitwise equal."""
    pix = jnp.arange(n, dtype=jnp.uint32) ^ jnp.uint32(seed)
    samp = jnp.zeros(n, jnp.uint32)
    u = jnp.stack([jrng.sample_1d(jrng.SamplerConfig(kind=jrng.RANDOM), pix, samp, d)
                   for d in range(cfg.dim)], axis=1)
    tpix = torch.arange(n, dtype=torch.int64) ^ seed
    ut = torch.stack([trng.sample_1d(trng.SamplerConfig(kind=trng.RANDOM), tpix,
                                     torch.zeros(n, dtype=torch.int64), d)
                      for d in range(cfg.dim)], dim=1)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(u))
    return u, ut


CASES = [(name, fn, ds) for name in ("mlt", "cornell_small")
         for fn, ds in (("eval_path", False), ("eval_path_bidir", False),
                        ("eval_path_bidir", True))]


@pytest.mark.parametrize("name,fn,direct_separate", CASES,
                         ids=[f"{n}-{f}{'-direct_separate' if d else ''}" for n, f, d in CASES])
def test_eval_matches_reference_per_lane(scenes, name, fn, direct_separate):
    js, jm, jcfg, ts, tm, tcfg = scenes[name]
    jcfg = dataclasses.replace(jcfg, direct_separate=direct_separate)
    tcfg = dataclasses.replace(tcfg, direct_separate=direct_separate)
    u, ut = bootstrap_u(jcfg)
    L_ref, px_ref, py_ref = (np.asarray(a) for a in getattr(jmlt, fn)(js, jm, jcfg, u))
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    L, px, py = (a.numpy() for a in getattr(tmlt, fn)(ts, tm, tcfg, ut))
    np.testing.assert_array_equal(px, px_ref)
    np.testing.assert_array_equal(py, py_ref)
    assert np.isfinite(L).all() and L.mean() > 0.005
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"
    # the waves by role: a closest hit a camera (and light) vertex, a
    # visibility test a connection
    depth = tcfg.max_depth
    if fn == "eval_path":
        want = {"mlt_camera": depth + 1, "mlt_light": 0, "mlt_connect": depth + 1}
    else:
        min_len = 3 if direct_separate else 1
        n_conn = sum(int(t + 1 >= min_len) + tcfg.s_max for t in range(1, depth + 2))
        want = {"mlt_camera": depth + 1, "mlt_light": tcfg.s_max, "mlt_connect": n_conn}
    assert {k: tint.WAVES[k] for k in want} == want
    assert sum(tint.WAVES.values()) == sum(want.values())


def test_mutate_bitwise(scenes):
    _, _, jcfg, _, _, tcfg = scenes["mlt"]
    u, ut = bootstrap_u(jcfg)
    mutate = jax.jit(jmlt._mutate, static_argnums=(3,))
    for wave, k in ((0, 0), (3, 5), (70000, 15)):
        key = ((jnp.arange(N, dtype=jnp.uint32) + jnp.uint32(17))
               ^ (jnp.uint32(wave) * jnp.uint32(7919)) ^ (jnp.uint32(k) * jnp.uint32(104729)))
        u_ref, large_ref = (np.asarray(a) for a in mutate(u, key, jnp.uint32(k), jcfg))
        u_new, large = tmlt._mutate(ut, torch.tensor(np.asarray(key).astype(np.int64)), k, tcfg)
        np.testing.assert_array_equal(large.numpy(), large_ref)
        np.testing.assert_array_equal(u_new.numpy(), u_ref)
        assert 0.1 < large_ref.mean() < 0.5 and (u_new.numpy() != ut.numpy()).all()


def test_bootstrap_matches_reference(scenes):
    js, jm, jcfg, ts, tm, tcfg = scenes["mlt"]
    jcfg = dataclasses.replace(jcfg, n_chains=N, n_bootstrap=N)
    tcfg = dataclasses.replace(tcfg, n_chains=N, n_bootstrap=N)
    u_ref, b_ref = jmlt._bootstrap(js, jm, jcfg, jmlt.eval_path_bidir,
                                   jnp.asarray([0], jnp.uint32))
    u, b = tmlt._bootstrap(ts, tm, tcfg, tmlt.eval_path_bidir, 0)
    np.testing.assert_allclose(float(b), float(b_ref), rtol=1e-5)
    same = np.all(u.numpy() == np.asarray(u_ref), axis=1)
    assert same.mean() >= 0.99, f"{same.mean():.4%} of chain starts match"


def _loop_scan(f, init, xs):
    """jax.lax.scan by its definition, a Python loop: the reference's step
    then runs eagerly, op by op, where the scan would compile it whole."""
    carry = init
    for x in xs:
        carry, _ = f(carry, x)
    return carry, None


def test_mlt_wave_matches_reference(scenes, monkeypatch):
    """One wave of every chain against the reference's: the chains' states
    after it and the splat film."""
    js, jm, jcfg, ts, tm, tcfg = scenes["mlt"]
    jcfg = dataclasses.replace(jcfg, n_chains=N, mutations_per_wave=2)
    tcfg = dataclasses.replace(tcfg, n_chains=N, mutations_per_wave=2)
    u, ut = bootstrap_u(jcfg, seed=5)
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "scan", _loop_scan)
        film_ref, u_ref = jmlt._mlt_wave(js, jm, jcfg, jmlt.eval_path_bidir,
                                         jfilm.new_film(RES, RES), u, jnp.uint32(1))
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    film, u_new = tmlt._mlt_wave(ts, tm, tcfg, tmlt.eval_path_bidir,
                                 tfilm.new_film(RES, RES, "cpu"), ut, 1)
    assert tint.WAVES["mlt_camera"] == 3 * (tcfg.max_depth + 1)     # 1 + 2 evaluations
    same = np.all(u_new.numpy() == np.asarray(u_ref), axis=1)
    assert same.mean() >= 0.99, f"{same.mean():.4%} of chains end in the same state"
    assert (u_new.numpy() != ut.numpy()).any(axis=1).mean() > 0.2     # chains moved
    splat, splat_ref = film["splat"].numpy(), np.asarray(film_ref["splat"])
    assert np.isfinite(splat).all() and splat.sum() > 0
    assert relative_mae(splat, splat_ref) < 1e-3
    assert not film["rgb"].any() and not film["weight"].any()


def test_mlt_matches_path_mean():
    """The port's twin of tests/test_render.py::test_mlt_matches_path_mean
    (the splat normalization), at its settings, on the port's cornell_small."""
    scene, meta, _ = tcornell(xres=16, yres=16, spp=4, device="cpu")
    mlt, _ = tmlt.render_mlt(scene, meta, tmlt.MLTConfig(max_depth=3, n_chains=2048,
                                                         n_bootstrap=4096,
                                                         mutations_per_wave=8),
                             n_waves=4, device="cpu")
    path, _ = render(scene, meta, tint.IntegratorConfig(kind="path", max_depth=3), spp=8,
                     device="cpu")
    mlt, path = mlt.numpy(), path.numpy()
    assert np.isfinite(mlt).all()
    np.testing.assert_allclose(mlt.mean(), path.mean(), rtol=0.25)


def test_mlt_bidirectional_matches_unidirectional_mean():
    """The port's twin of tests/test_render.py::
    test_mlt_bidirectional_matches_path_mean, at its settings: the
    bootstrap mean luminance of eval_path_bidir against eval_path on the
    diffuse Cornell box."""
    scene, meta, _ = tcornell(xres=32, yres=32, spp=4, with_boxes=False, device="cpu")
    nb = 8192

    def mean_L(cfg, evalf, seed):
        pix = torch.arange(nb, dtype=torch.int64) ^ seed
        samp = torch.zeros(nb, dtype=torch.int64)
        u = torch.stack([trng.sample_1d(trng.SamplerConfig(kind=trng.RANDOM), pix, samp, d)
                         for d in range(cfg.dim)], dim=1)
        L, _, _ = evalf(scene, meta, cfg, u)
        return float(luminance(L).mean())

    b_bi = mean_L(tmlt.MLTConfig(max_depth=3, bidirectional=True), tmlt.eval_path_bidir, 7)
    b_un = mean_L(tmlt.MLTConfig(max_depth=3, bidirectional=False), tmlt.eval_path, 7)
    assert abs(b_bi - b_un) / max(b_un, 1e-9) < 0.12, (b_bi, b_un)
