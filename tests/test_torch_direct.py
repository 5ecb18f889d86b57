"""The port's direct-lighting, Whitted and ambient-occlusion integrators
against the reference's.

Seeded numpy inputs through both packages: SPOT and DISTANT light samples;
light_power and the power-weighted light distribution with its discrete
draw and pmf (allclose rtol 1e-5, atol 1e-6); estimate_direct per lane at
a scene's first hits, with and without its BSDF-sampling branch (every
lane within rtol 1e-4, 99% within rtol 1e-5, atol 1e-6). Then li
per lane (>= 99% of lanes within rtol 1e-4, atol 1e-6, as
tests/test_torch_render.py) for every ported kind and light strategy on
the Cornell box (one area light) and on a mixed scene parsed by both
packages (mirror and glass, so specular continuations run past bounce 0;
an area, a spot and an infinite light; the Halton sampler, whose
dimensions past bounce 0 take base 2 in the reference), both on brute
force (tests/test_torch_direct_goldens.py holds the BVH scenes). On
the Cornell box the three strategies give the same estimate (one light),
and kind="direct" matches the independent NumPy oracle
(tests/oracle/oracle.py) at tests/test_oracle.py's block statistics.
"""
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.core import montecarlo as jmc, rng as jrng
from grail.engine import camera as jcam, film as jfilm
from grail.engine import integrator as jint
from grail.scene import parser as jparser
from grail.scene.presets import cornell_box
from grail.shade import lights as jlt
from grail_torch.core import montecarlo as tmc
from grail_torch.engine import integrator as tint
from grail_torch.engine.render import render
from grail_torch.kernels import intersect as tisect
from grail_torch.scene import buffers as tbuf, parser as tparser
from grail_torch.scene.api import _spot_frame
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.scene.presets import cornell_box as torch_cornell
from grail_torch.shade import lights as tlt
from tests.oracle.oracle import render_direct, scene_to_oracle
from tests.test_torch_goldens import _close

torch.set_num_threads(2)

N = 4096

def _box(lo, hi):
    """A trianglemesh box (12 triangles, outward normals)."""
    (x0, y0, z0), (x1, y1, z1) = lo, hi
    p = [(x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
         (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1)]
    idx = (0, 2, 1, 0, 3, 2, 4, 5, 6, 4, 6, 7, 0, 1, 5, 0, 5, 4,
           3, 7, 6, 3, 6, 2, 0, 4, 7, 0, 7, 3, 1, 2, 6, 1, 6, 5)
    return ('Shape "trianglemesh" "integer indices" [%s] "point P" [%s]\n'
            % (" ".join(map(str, idx)), " ".join(f"{c:g}" for v in p for c in v)))


# mirror, glass and plastic boxes over a floor (40 triangles: brute force);
# an area light, a spot light and an infinite light; the Halton sampler
MIXED = """LookAt 0 1.1 3.2  0 0.7 0  0 1 0
Camera "perspective" "float fov" [42]
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Sampler "halton" "integer pixelsamples" [2]
SurfaceIntegrator "directlighting" "integer maxdepth" [3]
WorldBegin
LightSource "spot" "rgb I" [30 30 28] "point from" [-1.5 3 1] "point to" [0 0 0]
  "float coneangle" [25] "float conedeltaangle" [8]
LightSource "infinite" "rgb L" [0.3 0.32 0.4]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 4 3.5]
  Translate 0 2.4 0
  Shape "trianglemesh" "integer indices" [0 2 1 0 3 2]
    "point P" [-0.5 0 -0.5  0.5 0 -0.5  0.5 0 0.5  -0.5 0 0.5]
AttributeEnd
Material "matte" "rgb Kd" [0.6 0.58 0.55]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-2.4 0 2.4  2.4 0 2.4  2.4 0 -2.4  -2.4 0 -2.4]
AttributeBegin
  Rotate 25 0 1 0
  Material "mirror" "rgb Kr" [0.85 0.85 0.85]
  """ + _box((-1.2, 0.05, -0.5), (-0.3, 1.1, 0.3)) + """AttributeEnd
AttributeBegin
  Rotate -20 0 1 0
  Material "glass" "rgb Kr" [0.9 0.9 0.9] "rgb Kt" [0.9 0.9 0.9] "float index" [1.5]
  """ + _box((0.3, 0.05, -0.1), (1.1, 1.0, 0.7)) + """AttributeEnd
AttributeBegin
  Material "plastic" "rgb Kd" [0.3 0.45 0.2]
  """ + _box((-0.2, 0.0, 0.8), (0.4, 0.5, 1.3)) + """AttributeEnd
WorldEnd
"""


def _lanes_close(L, L_ref):
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"


@pytest.fixture(scope="module")
def scenes():
    """{name: (reference scene, reference meta, port scene, port meta)}:
    the Cornell box carried across by the bridge, and the mixed scene parsed
    by both packages."""
    js, jm, _ = cornell_box(16, 16, 2)
    ts, tm = scene_from_numpy(jax.tree_util.tree_map(np.asarray, js), jm, device="cpu")
    jx, jxm, _ = jparser.parse_string(MIXED)
    tx, txm, _ = tparser.parse_string(MIXED, device="cpu")
    return {"cornell": (js, jm, ts, tm), "mixed": (jx, jxm, tx, txm)}


def _camera_lanes(js, jm):
    """Pixel and sample ids of every authored sample in tile order, and the
    reference's camera rays for them."""
    res, spp = jm.xres, jm.sampler.spp
    px_t, py_t = jfilm.lane_pixel(jnp.arange(res * res, dtype=jnp.uint32), res)
    pix = jnp.tile(py_t.astype(jnp.uint32) * res + px_t.astype(jnp.uint32), spp)
    samp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), res * res)
    ufx, ufy = jrng.sample_2d(jm.sampler, pix, samp, jint.SLOT_FILM)
    ul1, ul2 = jrng.sample_2d(jm.sampler, pix, samp, jint.SLOT_LENS)
    ut = jrng.sample_1d(jm.sampler, pix, samp, jint.SLOT_TIME)
    rays = jcam.generate_rays(js["camera"], (pix % res).astype(jnp.int32),
                              (pix // res).astype(jnp.int32), ufx, ufy, ul1, ul2, ut,
                              jm.cam_kind)
    return {k: rays[k] for k in ("o", "d", "weight")}, pix, samp


def _torch(x):
    a = np.asarray(x)
    return torch.tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


# ------------------------------------------------------------------- lights
def _light_table(rng, n_lights, ltype):
    """Light columns for both packages: random spot frames and cones, or
    random distant directions."""
    l2w = np.tile(np.eye(4, dtype=np.float32), (n_lights, 1, 1))
    l2w[:] = [_spot_frame(rng.normal(size=3).astype(np.float32) * 2,
                          rng.normal(size=3).astype(np.float32) * 0.3)
              for _ in range(n_lights)]
    cone = rng.uniform(10, 60, n_lights)
    delta = rng.uniform(1, 9, n_lights)
    wdir = rng.normal(size=(n_lights, 3))
    wdir /= np.linalg.norm(wdir, axis=1, keepdims=True)
    return {"type": np.full(n_lights, ltype, np.int32),
            "emit": rng.uniform(0.5, 20, (n_lights, 3)).astype(np.float32),
            "l2w": l2w, "w2l": np.linalg.inv(l2w).astype(np.float32),
            "cos_total": np.cos(np.radians(cone)).astype(np.float32),
            "cos_falloff": np.cos(np.radians(cone - delta)).astype(np.float32),
            "world_dir": wdir.astype(np.float32),
            "area": np.ones(n_lights, np.float32)}


@pytest.mark.parametrize("ltype", (tlt.SPOT, tlt.DISTANT))
def test_spot_and_distant_sample_li_match_reference(ltype):
    rng = np.random.default_rng(ltype)
    lights = _light_table(rng, 5, ltype)
    p = rng.normal(size=(N, 3)).astype(np.float32)
    li = rng.integers(0, 5, N).astype(np.int32)
    u = rng.random((3, N)).astype(np.float32)
    ref = jlt.sample_li({"lights": {k: jnp.asarray(v) for k, v in lights.items()}},
                        jnp.asarray(li), jnp.asarray(p), *jnp.asarray(u), (ltype,))
    got = tlt.sample_li({"lights": {k: torch.tensor(v) for k, v in lights.items()}},
                        torch.tensor(li), torch.tensor(p), *torch.tensor(u), (ltype,))
    for key in ("wi", "radiance", "pdf", "dist", "delta"):
        _close(got[key], ref[key], key)
    rad = got["radiance"].numpy()
    if ltype == tlt.SPOT:
        # inside, between and outside the cones
        assert (rad.max(1) == 0).any() and (rad.max(1) > 0).mean() > 0.05
    else:
        np.testing.assert_array_equal(rad, lights["emit"][li])


def test_light_power_and_discrete_draw_match_reference():
    """Power per light of every ported type, the Distribution1D built on it,
    and SampleDiscrete's index (exact) and pmf."""
    rng = np.random.default_rng(9)
    types = np.asarray([tlt.POINT, tlt.SPOT, tlt.DISTANT, tlt.AREA, tlt.INFINITE,
                        tlt.SPOT, tlt.POINT], np.int32)
    lights = _light_table(rng, len(types), tlt.SPOT)
    lights["type"] = types
    lights["area"] = rng.uniform(0.1, 3, len(types)).astype(np.float32)
    radius = np.float32(7.25)
    ref = jlt.light_power({"lights": {k: jnp.asarray(v) for k, v in lights.items()},
                           "world_radius": jnp.float32(radius)})
    got = tlt.light_power({k: torch.tensor(v) for k, v in lights.items()},
                          torch.tensor(radius))
    _close(got, ref, "power")
    jd = jmc.build_distribution_1d(ref)
    td = tmc.build_distribution_1d(got)
    _close(td["cdf"], jd["cdf"], "cdf")
    u = np.concatenate([rng.random(N), np.asarray(jd["cdf"])[1:-1]]).astype(np.float32)
    idx_ref, pmf_ref = jmc.sample_distribution_1d_discrete(jd, jnp.asarray(u))
    idx, pmf = tmc.sample_distribution_1d_discrete(td, torch.tensor(u))
    _close(idx.to(torch.int32), idx_ref, "index")
    _close(pmf, pmf_ref, "pmf")
    _close(tmc.distribution_1d_pdf_discrete(td, idx),
           jmc.distribution_1d_pdf_discrete(jd, idx_ref), "pdf_discrete")
    # SceneBuilder's table: the same distribution from its numpy columns
    built = tbuf.light_power_distribution(lights, radius)
    _close(built["cdf"], jd["cdf"], "builder cdf")


# ----------------------------------------------------------- estimate_direct
@pytest.mark.parametrize("bsdf_branch", (False, True))
def test_estimate_direct_matches_reference(scenes, bsdf_branch):
    """Both packages' estimate_direct at the same first hits of the mixed
    scene (its BSDF branch hits the area light and escapes to the infinite
    one; the spot light is delta), a light row a lane drawn at random (pmf
    1/n), some lanes inactive."""
    js, jm, ts, tm = scenes["mixed"]
    rays, pix, samp = _camera_lanes(js, jm)
    o, d = _torch(rays["o"]), _torch(rays["d"])
    n = o.shape[0]
    hit = tisect.intersect(ts, o, d, torch.full((n,), 1e7), device="cpu")
    rng = np.random.default_rng(int(bsdf_branch))
    lidx = rng.integers(0, tm.n_lights, n).astype(np.int32)
    pmf = np.full(n, 1.0 / tm.n_lights, np.float32)
    u = rng.random((6, n)).astype(np.float32)
    active = (hit["prim"] >= 0).numpy() & (rng.random(n) < 0.9)

    def ref_fn(hit_j, o_j, d_j, lidx_j, pmf_j, u_j, active_j):
        sg, lobes, wo = jint._shade_context(js, jm, hit_j, o_j, d_j)
        return jint.estimate_direct(js, jm, sg, lobes, wo, lidx_j, pmf_j,
                                    (u_j[0], u_j[1]), u_j[2], u_j[3], (u_j[4], u_j[5]),
                                    active_j, bsdf_branch=bsdf_branch)

    hit_j = {k: jnp.asarray(v.numpy()) for k, v in hit.items()}
    ref = jax.jit(ref_fn)(hit_j, rays["o"], rays["d"], jnp.asarray(lidx),
                          jnp.asarray(pmf), jnp.asarray(u), jnp.asarray(active))
    sg, lobes, wo = tint._shade_context(ts, tm, hit, o, d)
    ut = torch.tensor(u)
    got = tint.estimate_direct(ts, tm, sg, lobes, wo, torch.tensor(lidx),
                               torch.tensor(pmf), (ut[0], ut[1]), ut[2], ut[3],
                               (ut[4], ut[5]), torch.tensor(active),
                               bsdf_branch=bsdf_branch)
    # every lane within rtol 1e-4, and 99% within rtol 1e-5, atol 1e-6: the
    # infinite light's pdf divides by sinθ of an acos, which near the pole
    # turns a last-bit difference of float32 acos into a few 1e-5
    _close(got, ref, "Ld", rtol=1e-4)
    got, ref = got.numpy(), np.asarray(ref)
    assert np.all(np.abs(got - ref) <= 1e-6 + 1e-5 * np.abs(ref), axis=-1).mean() >= 0.99
    assert float(got.max()) > 0


# --------------------------------------------------------------------- li
_KINDS = {"direct_one": dict(kind="direct", max_depth=3, light_strategy="one"),
          "direct_power": dict(kind="direct", max_depth=3, light_strategy="power"),
          "direct_all": dict(kind="direct", max_depth=3, light_strategy="all"),
          "whitted": dict(kind="whitted", max_depth=3),
          "ao": dict(kind="ao", ao_samples=3, ao_maxdist=1.5)}
# on the Cornell box "one" and "power" draw what "all" draws (one light:
# test_light_strategies_agree_on_cornell); on the mixed scene, "one"'s
# estimate_direct with a light drawn a lane is
# test_estimate_direct_matches_reference
_LI_CASES = ([("cornell", k) for k in ("direct_all", "whitted", "ao")]
             + [("mixed", k) for k in ("direct_power", "direct_all", "whitted")])


@pytest.fixture(scope="module")
def reference_li(scenes):
    """{case: (camera rays, pix, samp, the reference's L)} of _LI_CASES: the
    reference's li programs traced in turn on this thread and compiled on a
    pool's (XLA compiles without the GIL), the longest first."""
    with ThreadPoolExecutor(4) as pool:
        jobs = {}
        for case in sorted(_LI_CASES, key=lambda c: (c[0] != "mixed", c[1] != "direct_all")):
            js, jm = scenes[case[0]][:2]
            args = _camera_lanes(js, jm)
            fn = jax.jit(partial(jint.li, js, jm, jint.IntegratorConfig(**_KINDS[case[1]])))
            jobs[case] = (pool.submit(fn.lower(*args).compile), args)
        yield {case: args + (np.asarray(job.result()(*args)),)
               for case, (job, args) in jobs.items()}


@pytest.mark.parametrize("scene_name,kind", _LI_CASES)
def test_li_matches_reference_per_lane(scenes, reference_li, scene_name, kind):
    ts, tm = scenes[scene_name][2:]
    rays, pix, samp, L_ref = reference_li[(scene_name, kind)]
    L = tint.li(ts, tm, tint.IntegratorConfig(**_KINDS[kind]),
                {k: _torch(v) for k, v in rays.items()}, _torch(pix), _torch(samp)).numpy()
    assert np.isfinite(L).all() and L.mean() > 0.01
    _lanes_close(L, L_ref)


@pytest.mark.parametrize("kind", ("direct", "path"))
def test_light_strategies_agree_on_cornell(kind):
    """One light: the uniform pick, the power pick and "all" draw the same
    light with pmf 1 from the same dimensions, so every lane agrees to the
    bit (tests/test_render.py compares their means). Under path, "all"
    runs no BSDF branch besides path-vertex reuse (ROADMAP C.7)."""
    scene, meta, _ = torch_cornell(16, 16, 8, device="cpu")
    imgs = [render(scene, meta, tint.IntegratorConfig(kind=kind, max_depth=1,
                                                      light_strategy=s),
                   device="cpu")[0].numpy() for s in ("one", "power", "all")]
    assert imgs[0].mean() > 0.05
    np.testing.assert_array_equal(imgs[1], imgs[0])
    np.testing.assert_array_equal(imgs[2], imgs[0])


def test_direct_matches_numpy_oracle():
    """kind="direct" on the Cornell box without its boxes against the
    independent NumPy estimator (no MIS, its own RNG): block means, as
    tests/test_oracle.py."""
    res = 24
    scene, meta, b = torch_cornell(res, res, 8, with_boxes=False, device="cpu")
    img = render(scene, meta, tint.IntegratorConfig(kind="direct", max_depth=1,
                                                    light_strategy="one"),
                 spp=32, device="cpu")[0].numpy()
    ref = render_direct(scene_to_oracle(scene, meta, b), res, res, spp=32, seed=5)

    def blocks(a, k=6):
        h, w, _ = a.shape
        return a[:h // k * k, :w // k * k].reshape(h // k, k, w // k, k, 3).mean(axis=(1, 3))

    bd, br = blocks(img), blocks(ref)
    mask = br < 5.0        # the light's own blocks: emission is exact in both
    rel = np.abs(bd - br) / np.maximum(br, 0.02)
    assert np.median(rel[mask]) < 0.08, np.median(rel[mask])
    assert (rel[mask] < 0.35).mean() > 0.9


def test_unported_kinds_and_strategies_raise():
    scene, meta, _ = torch_cornell(4, 4, 1, device="cpu")
    # every kind of the reference is ported: an unknown kind raises, and li
    # refuses a kind whose Li needs the render's preprocess
    with pytest.raises(ValueError, match="spectral"):
        render(scene, meta, tint.IntegratorConfig(kind="spectral"), device="cpu")
    for kind in ("photon", "irradiancecache"):
        with pytest.raises(ValueError, match="preprocess"):
            tint.li(scene, meta, tint.IntegratorConfig(kind=kind), {}, None, None)
    with pytest.raises(ValueError, match="light_strategy"):
        render(scene, meta, tint.IntegratorConfig(light_strategy="spatial"), device="cpu")
