"""The port's participating media against the reference's.

Seeded numpy inputs through both packages on one region table of the three
kinds (a rotated homogeneous box, a seeded 4x5x6 density grid in a moved
box, an exponential slab): region_segment and density_at per kind, tau and
transmittance (the grid and exponential marches), emission_li with an
emitting region, sample_distance, the phase function library (allclose
rtol 1e-5, atol 1e-6, the port's tolerance for float stages;
rtol 1e-4 where 32 march steps accumulate rounding). single_scatter_li on
a parsed world of 14 triangles (brute force) with a spot and a point
light, under the Halton sampler, whose march dimensions the reference
computes as traced values (base 2): per lane, its shadow rays through the
port's trace hook as 32 "medium" waves. Then li per lane at 16x16 on that
world with three Volume regions (homogeneous, volumegrid, exponential)
under VolumeIntegrator "single", for kind direct and kind path (>= 99% of
lanes within rtol 1e-4, atol 1e-6, as tests/test_torch_render.py); the
reference's programs are traced in turn and compiled on threads.
"""
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.core import rng as jrng
from grail.engine import camera as jcam, film as jfilm
from grail.engine import integrator as jint
from grail.scene import parser as jparser
from grail.shade import media as jmed
from grail_torch.core import rng as trng
from grail_torch.core import transform as ttr
from grail_torch.engine import integrator as tint
from grail_torch.scene import parser as tparser
from grail_torch.shade import media as tmed
from tests.test_torch_goldens import _close, _dirs

torch.set_num_threads(2)

N = 4096
RES = 16


def _region_table(rng):
    """Three regions (homogeneous, grid, exponential) as numpy columns, and
    the grid."""
    v2w = [ttr.rotate(30.0, [0.3, 1.0, 0.2]) @ ttr.translate([0.2, 0.1, -0.3]),
           ttr.translate([0.5, 0.0, 0.2]) @ ttr.scale(1.5, 1.0, 1.2),
           ttr.identity()]
    media = {
        "w2v": np.stack([ttr.inverse(m) for m in v2w]).astype(np.float32),
        "bounds_min": np.asarray([[-1, -1, -1], [-0.8, 0, -0.9], [-2, 0, -2]], np.float32),
        "bounds_max": np.asarray([[1, 1, 1], [0.9, 1.2, 0.7], [2, 1.5, 2]], np.float32),
        "sigma_a": rng.uniform(0.05, 0.5, (3, 3)).astype(np.float32),
        "sigma_s": rng.uniform(0.1, 1.0, (3, 3)).astype(np.float32),
        "g": np.asarray([0.3, -0.2, 0.6], np.float32),
        "le": rng.uniform(0.0, 0.5, (3, 3)).astype(np.float32),
        "grid_id": np.asarray([-1, 0, -1], np.int32),
        "exp_a": np.asarray([1.0, 1.0, 1.7], np.float32),
        "exp_b": np.asarray([1.0, 1.0, 2.3], np.float32),
        "updir": np.asarray([[0, 1, 0], [0, 1, 0], [0.1, 0.9, 0.2]], np.float32),
    }
    grid = rng.uniform(0.0, 2.0, (4, 5, 6)).astype(np.float32)
    return media, grid


@pytest.fixture(scope="module")
def regions():
    rng = np.random.default_rng(50)
    media, grid = _region_table(rng)
    kinds = (jmed.HOMOGENEOUS, jmed.GRID, jmed.EXPONENTIAL)
    js = {"media": {k: jnp.asarray(v) for k, v in media.items()},
          "density_grids": (jnp.asarray(grid),)}
    ts = {"media": {k: torch.tensor(v) for k, v in media.items()},
          "density_grids": (torch.tensor(grid),)}
    o = rng.uniform(-2.5, 2.5, (N, 3)).astype(np.float32)
    d = _dirs(rng, N)
    tmax = rng.uniform(0.5, 6.0, N).astype(np.float32)
    u = rng.random(N).astype(np.float32)
    pts = rng.uniform(-1.5, 2.0, (N, 3)).astype(np.float32)
    return SimpleNamespace(js=js, ts=ts, kinds=kinds, o=o, d=d, tmax=tmax, u=u, pts=pts)


def _meta(pkg_rng, kinds):
    """What the media stages read of a SceneMeta, for either package."""
    return SimpleNamespace(media_kinds=kinds,
                           sampler=pkg_rng.SamplerConfig(kind=pkg_rng.ZERO_TWO, spp=4))


@pytest.mark.parametrize("r", (0, 1, 2))
def test_region_segment_and_density_match_reference(regions, r):
    R = regions
    t0, t1, hit = tmed.region_segment(R.ts["media"], r, torch.tensor(R.o),
                                      torch.tensor(R.d), torch.tensor(R.tmax))
    j0, j1, jhit = jmed.region_segment(R.js["media"], r, jnp.asarray(R.o),
                                       jnp.asarray(R.d), jnp.asarray(R.tmax))
    _close(hit, jhit, "hit")
    assert 0.1 < float(np.asarray(jhit).mean()) < 0.9
    _close(t0, j0, "t0", atol=1e-5)
    _close(t1, j1, "t1", atol=1e-5)
    kind = R.kinds[r]
    dens = tmed.density_at(R.ts["media"], R.ts["density_grids"], r, kind,
                           torch.tensor(R.pts))
    ref = jmed.density_at(R.js["media"], R.js["density_grids"], r, kind,
                          jnp.asarray(R.pts))
    _close(dens, ref, "density")
    assert (np.asarray(ref) > 0).mean() > 0.05


def test_tau_and_transmittance_match_reference(regions):
    R = regions
    args_t = (torch.tensor(R.o), torch.tensor(R.d), torch.tensor(R.tmax),
              torch.tensor(R.u))
    args_j = tuple(jnp.asarray(a) for a in (R.o, R.d, R.tmax, R.u))
    tau = tmed.tau(R.ts, _meta(trng, R.kinds), *args_t)
    ref = jmed.tau(R.js, _meta(jrng, R.kinds), *args_j)
    _close(tau, ref, "tau", rtol=1e-4)
    assert (np.asarray(ref) > 0).any(axis=-1).mean() > 0.2
    _close(tmed.transmittance(R.ts, _meta(trng, R.kinds), *args_t),
           jmed.transmittance(R.js, _meta(jrng, R.kinds), *args_j), "T", rtol=1e-4)
    # without media: ones, and no march
    ones = tmed.transmittance({}, _meta(trng, ()), *args_t)
    assert torch.equal(ones, torch.ones(N, 3))


def test_emission_li_matches_reference(regions):
    R = regions
    pix = np.arange(N, dtype=np.uint32)
    samp = (np.arange(N) % 3).astype(np.uint32)
    got = tmed.emission_li(R.ts, _meta(trng, R.kinds), torch.tensor(R.o),
                           torch.tensor(R.d), torch.tensor(R.tmax),
                           torch.tensor(pix.astype(np.int64)),
                           torch.tensor(samp.astype(np.int64)), 3000)
    ref = jmed.emission_li(R.js, _meta(jrng, R.kinds), jnp.asarray(R.o),
                           jnp.asarray(R.d), jnp.asarray(R.tmax), jnp.asarray(pix),
                           jnp.asarray(samp), 3000)
    for g, r, what in zip(got, ref, ("Lv", "T")):
        _close(g, r, what, rtol=1e-4)
    assert float(np.asarray(ref[0]).max()) > 0.01


def test_sample_distance_matches_reference(regions):
    R = regions
    rng = np.random.default_rng(51)
    cu = rng.random(N).astype(np.float32)
    got = tmed.sample_distance(R.ts, None, torch.tensor(R.o), torch.tensor(R.d),
                               torch.tensor(R.tmax), torch.tensor(R.u), torch.tensor(cu))
    ref = jmed.sample_distance(R.js, None, jnp.asarray(R.o), jnp.asarray(R.d),
                               jnp.asarray(R.tmax), jnp.asarray(R.u), jnp.asarray(cu))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], k, atol=1e-5)
    assert 0.0 < float(np.asarray(ref["in_medium"]).mean()) < 0.5
    assert tmed.sample_distance({}, None, *(torch.zeros(1, 3),) * 2, *(torch.zeros(1),) * 3) \
        is None


def test_phase_functions_match_reference():
    rng = np.random.default_rng(52)
    cos = rng.uniform(-1, 1, N).astype(np.float32)
    g = rng.uniform(-0.9, 0.9, N).astype(np.float32)
    jc, tc, jg, tg = jnp.asarray(cos), torch.tensor(cos), jnp.asarray(g), torch.tensor(g)
    for name in ("phase_isotropic", "phase_rayleigh", "phase_mie_hazy", "phase_mie_murky"):
        _close(getattr(tmed, name)(tc), getattr(jmed, name)(jc), name)
    _close(tmed.phase_schlick(tg, tc), jmed.phase_schlick(jg, jc), "schlick", rtol=1e-4)
    _close(tmed.phase_hg_eval(tg, tc), jmed.phase_hg_eval(jg, jc), "hg")


# ------------------------------------------------ the march and li on a scene
def _box(lo, hi):
    """A trianglemesh box (12 triangles)."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    p = [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
         (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)]
    idx = (0, 2, 1, 0, 3, 2, 4, 5, 6, 4, 6, 7, 0, 1, 5, 0, 5, 4,
           3, 7, 6, 3, 6, 2, 0, 4, 7, 0, 7, 3, 1, 2, 6, 1, 6, 5)
    return ('Shape "trianglemesh" "integer indices" [%s] "point P" [%s]\n'
            % (" ".join(map(str, idx)), " ".join(f"{c:g}" for v in p for c in v)))


# a floor and a box (14 triangles: brute force) under a spot and a point
# light, in three overlapping regions of the three kinds
MEDIA_WORLD = """LookAt 0 1.5 4  0 0.6 0  0 1 0
Camera "perspective" "float fov" [45]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "{sampler}" "integer pixelsamples" [2]
SurfaceIntegrator "{integrator}" "integer maxdepth" [2]
VolumeIntegrator "single"
WorldBegin
LightSource "spot" "rgb I" [30 28 26] "point from" [-1.5 3 1] "point to" [0.3 0 0]
  "float coneangle" [30]
LightSource "point" "rgb I" [4 4 5] "point from" [1.5 2 2]
Volume "homogeneous" "rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [0.2 0.25 0.3]
  "float g" [0.3] "point p0" [-3 0 -3] "point p1" [3 3 3]
Volume "volumegrid" "integer nx" [3] "integer ny" [2] "integer nz" [2]
  "float density" [0.2 1.5 0.4  2.0 0.1 0.8  1.1 0.3 1.7  0.5 2.2 0.9]
  "rgb sigma_a" [0.1 0.1 0.1] "rgb sigma_s" [0.4 0.3 0.2] "float g" [-0.2]
  "point p0" [-1 0 -1] "point p1" [1.2 1.5 1]
Volume "exponential" "float a" [0.8] "float b" [1.5] "vector updir" [0 1 0]
  "rgb sigma_a" [0.02 0.03 0.04] "rgb sigma_s" [0.3 0.3 0.3] "rgb Le" [0.05 0.02 0.0]
  "point p0" [-3 0 -3] "point p1" [3 2 3]
Material "matte" "rgb Kd" [0.6 0.6 0.6]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 0 4  4 0 4  4 0 -4  -4 0 -4]
Material "plastic" "rgb Kd" [0.5 0.2 0.2] "rgb Ks" [0.3 0.3 0.3]
""" + _box((0.2, 0.0, -0.4), (0.9, 0.8, 0.3)) + "WorldEnd\n"


def media_text(integrator="directlighting", sampler="lowdiscrepancy"):
    return MEDIA_WORLD.format(integrator=integrator, sampler=sampler)


def reference_rays(js, jm, res=RES):
    """The reference's camera rays for sample index 0 of every pixel in
    tile order, with their sampler coordinates."""
    px_t, py_t = jfilm.lane_pixel(jnp.arange(res * res, dtype=jnp.uint32), res)
    pix = py_t.astype(jnp.uint32) * res + px_t.astype(jnp.uint32)
    samp = jnp.zeros_like(pix)
    ufx, ufy = jrng.sample_2d(jm.sampler, pix, samp, jint.SLOT_FILM)
    ul1, ul2 = jrng.sample_2d(jm.sampler, pix, samp, jint.SLOT_LENS)
    ut = jrng.sample_1d(jm.sampler, pix, samp, jint.SLOT_TIME)
    rays = jcam.generate_rays(js["camera"], (pix % res).astype(jnp.int32),
                              (pix // res).astype(jnp.int32), ufx, ufy, ul1, ul2, ut,
                              jm.cam_kind)
    return {k: rays[k] for k in ("o", "d", "weight")}, pix, samp


def to_torch(rays, pix, samp):
    return ({k: torch.tensor(np.asarray(v)) for k, v in rays.items()},
            torch.tensor(np.asarray(pix).astype(np.int64)),
            torch.tensor(np.asarray(samp).astype(np.int64)))


def test_single_scatter_matches_reference():
    text = media_text(sampler="halton")
    js, jm, _ = jparser.parse_string(text)
    ts, tm, _ = tparser.parse_string(text, device="cpu")
    assert tm.media_kinds == jm.media_kinds == (0, 1, 2) and tm.n_tris == 14
    rays, pix, samp = reference_rays(js, jm)
    tmax = jnp.full((RES * RES,), 8.0, jnp.float32)
    ref = jax.jit(lambda r, p, s: jmed.single_scatter_li(
        js, jm, r["o"], r["d"], tmax, p, s, 3000))(rays, pix, samp)
    trays, tpix, tsamp = to_torch(rays, pix, samp)
    calls = []

    def trace(o, d, t):
        calls.append(o.shape[0])
        return tint._trace(ts, o, d, t, any_hit=True, role="medium")

    got = tmed.single_scatter_li(ts, tm, trays["o"], trays["d"], torch.tensor(
        np.asarray(tmax)), tpix, tsamp, trace, 3000)
    assert calls == [RES * RES] * 3 * tmed.MAX_MARCH_STEPS      # each region's march
    for g, r, what in zip(got, ref, ("Lv", "T")):
        _close(g, r, what, rtol=1e-4)
    assert float(np.asarray(ref[0]).max()) > 0.01


@pytest.fixture(scope="module")
def li_cases():
    """{kind: (port parse, rays, pix, samp, the reference's L)} on the media
    world, the reference's programs compiled on threads."""
    with ThreadPoolExecutor(2) as pool:
        jobs = {}
        for kind, integrator in (("direct", "directlighting"), ("path", "path")):
            text = media_text(integrator)
            js, jm, japi = jparser.parse_string(text)
            args = reference_rays(js, jm)
            fn = jax.jit(partial(jint.li, js, jm, japi.integrator_config))
            jobs[kind] = (pool.submit(fn.lower(*args).compile),
                          tparser.parse_string(text, device="cpu"), args)
        yield {kind: (ported,) + args + (np.asarray(job.result()(*args)),)
               for kind, (job, ported, args) in jobs.items()}


@pytest.mark.parametrize("kind", ("direct", "path"))
def test_media_li_matches_reference_per_lane(li_cases, kind):
    (ts, tm, tapi), rays, pix, samp, L_ref = li_cases[kind]
    cfg = tapi.integrator_config
    assert cfg.kind == kind and cfg.vol == "single" and tm.n_tris <= 64
    tint.WAVES.update(dict.fromkeys(tint.WAVES, 0))
    L = tint.li(ts, tm, cfg, *to_torch(rays, pix, samp)).numpy()
    assert tint.WAVES["medium"] == tmed.MAX_MARCH_STEPS * len(tm.media_kinds)
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"
