"""The port's shading for the path goldens, and the goldens themselves.

Lobes against the reference on seeded inputs (allclose rtol 1e-5, atol 1e-6:
float32 transcendental functions and operation order round the last bits):
OREN_NAYAR's f, pdf and cosine sample; the delta lobes' sampled direction
and value entering, leaving and at total internal reflection; bsdf_sample
over stacks that mix delta and non-delta lobes (glass, uber), per lane;
the `scale` and `mix` texture rows. Then li per lane on cornell, glossy and
envlight, parsed by both packages from the same text at 16x16 (>= 99% of
lanes within rtol 1e-4, atol 1e-6, as tests/test_torch_render.py); the
Cornell box's li per (pixel, sample) against the matched-sampler NumPy
oracle (tests/oracle/oracle_path.py) with tests/test_oracle.py's quantiles;
and each scene rendered at its authored settings against its golden image
at tests/test_golden.py's relative MAE.
"""
from functools import partial
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.core import rng as jrng
from grail.engine import camera as jcam, film as jfilm
from grail.engine import integrator as jint
from grail.scene import parser as jparser
from grail.shade import bsdf as jbsdf, textures as jtex
from grail_torch.engine import integrator as tint
from grail_torch.engine.imageio import read_image
from grail_torch.engine.render import camera_rays, render
from grail_torch.scene import parser as tparser
from grail_torch.scene.presets import cornell_box
from grail_torch.shade import bsdf as tbsdf, textures as ttex
from tests.oracle import oracle_path as op

torch.set_num_threads(2)

SCENES = os.path.join(os.path.dirname(__file__), os.pardir, "scenes")
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
PATH_GOLDENS = ("cornell", "envlight", "glossy")
GOLDEN_RELMAE = 0.02          # tests/test_golden.py's threshold for these scenes
N = 4096


def relative_mae(a, b):
    return float(np.mean(np.abs(a - b)) / (np.mean(np.abs(b)) + 1e-6))


def _close(got, ref, what, rtol=1e-5, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    if ref.dtype == np.bool_ or np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def _dirs(rng, n, zsign=0.0):
    """Unit directions; zsign > 0 or < 0 forces the hemisphere."""
    v = rng.normal(size=(n, 3))
    if zsign:
        v[:, 2] = zsign * np.abs(v[:, 2])
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _both(*arrays):
    return [jnp.asarray(a) for a in arrays], [torch.tensor(a) for a in arrays]


# ------------------------------------------------------------------- lobes
def test_oren_nayar_matches_reference():
    rng = np.random.default_rng(0)
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    wi[:64, :2] = 0.0                              # normal incidence: sinθ = 0
    wi[:64, 2] = 1.0
    R = rng.random((N, 3)).astype(np.float32)
    sigma = np.radians(rng.uniform(0, 40, N)).astype(np.float32)
    u1, u2 = rng.random(N).astype(np.float32), rng.random(N).astype(np.float32)
    t = np.full(N, jbsdf.OREN_NAYAR, np.int32)
    (jt, jwo, jwi, jR, js, ju1, ju2), (tt, two, twi, tR, ts, tu1, tu2) = _both(
        t, wo, wi, R, sigma, u1, u2)
    zero = jnp.zeros(N)
    present = (jbsdf.OREN_NAYAR,)
    ref_f = jbsdf.lobe_f(jt, jwo, jwi, jR, jR, jR, js, zero, zero, jt * 0, present)
    _close(tbsdf.lobe_f(tt, two, twi, tR, tR, tR, ts, ts * 0, tt * 0, present), ref_f, "f")
    assert float(np.asarray(ref_f).max()) > 0
    _close(tbsdf.lobe_pdf(tt, two, twi, ts, present),
           jbsdf.lobe_pdf(jt, jwo, jwi, js, zero, present), "pdf")
    wi_ref, ok_ref = jbsdf.lobe_sample_wi(jt, jwo, ju1, ju2, js, zero, zero, present)
    wi_got, ok_got = tbsdf.lobe_sample_wi(tt, two, tu1, tu2, ts, ts * 0, present)
    _close(wi_got, wi_ref, "wi")
    _close(ok_got, ok_ref, "valid")


@pytest.mark.parametrize("case", ("entering", "leaving", "tir"))
def test_delta_lobes_match_reference(case):
    rng = np.random.default_rng(("entering", "leaving", "tir").index(case))
    n = N // 2
    # entering from outside; leaving near the normal (below every critical
    # angle up to ior 2.4); inside glass of ior 1.5 beyond its critical angle
    lo, hi, sign = {"entering": (0.05, 1.0, 1.0), "leaving": (0.95, 1.0, -1.0),
                    "tir": (0.0, 0.7, -1.0)}[case]
    cos = rng.uniform(lo, hi, n)
    phi = rng.uniform(0, 2 * np.pi, n)
    sin = np.sqrt(1 - cos * cos)
    wo = np.stack([sin * np.cos(phi), sin * np.sin(phi), sign * cos], -1).astype(np.float32)
    types = np.where(np.arange(n) % 2 == 0, jbsdf.SPEC_REFL, jbsdf.SPEC_TRANS)
    types = types.astype(np.int32)
    fr = np.where(np.arange(n) % 4 == 0, jbsdf.FR_DIELECTRIC,
                  np.where(np.arange(n) % 4 == 2, jbsdf.FR_CONDUCTOR,
                           jbsdf.FR_NOOP)).astype(np.int32)
    ior = (np.full(n, 1.5) if case == "tir" else rng.uniform(1.0, 2.4, n)).astype(np.float32)
    R = rng.random((n, 3)).astype(np.float32)
    u = rng.random(n).astype(np.float32)
    present = (jbsdf.SPEC_REFL, jbsdf.SPEC_TRANS)
    (jt, jwo, jior, jR, ju, jfr), (tt, two, tior, tR, tu, tfr) = _both(
        types, wo, ior, R, u, fr)
    wi_ref, ok_ref = jbsdf.lobe_sample_wi(jt, jwo, ju, ju, jior, jior, jior, present)
    wi_got, ok_got = tbsdf.lobe_sample_wi(tt, two, tu, tu, tior, tior, present)
    _close(ok_got, ok_ref, "valid")
    _close(wi_got, wi_ref, "wi")
    trans = types == jbsdf.SPEC_TRANS
    if case == "tir":
        assert not np.asarray(ok_ref)[trans].any()
    else:
        assert np.asarray(ok_ref).all()
        # a refracted ray crosses the surface, a reflected one stays
        assert (np.sign(wi_got[:, 2].numpy()) != np.sign(wo[:, 2]))[trans].all()
    val_ref = jbsdf.lobe_specular_value(jt, jwo, wi_ref, jR, jR, jR, jior, jfr, present)
    _close(tbsdf.lobe_specular_value(tt, two, wi_got, tR, tR, tR, tior, tfr, present),
           val_ref, "value")


def _stack(rng, n, types):
    """A lobe stack: every lane holds `types` in its slots."""
    k = len(types)
    return {"type": np.tile(np.asarray(types, np.int32), (n, 1)),
            "fr": np.tile(np.asarray([jbsdf.FR_DIELECTRIC if t != jbsdf.LAMBERT else 0
                                      for t in types], np.int32), (n, 1)),
            "R": rng.random((n, k, 3)).astype(np.float32),
            "S1": rng.random((n, k, 3)).astype(np.float32),
            "S2": rng.random((n, k, 3)).astype(np.float32),
            # Blinn exponents of roughness 0.04-0.2, as the scenes' materials
            "f0": rng.uniform(5, 25, (n, k)).astype(np.float32),
            "f1": np.zeros((n, k), np.float32),
            "f2": np.where(np.asarray(types) == jbsdf.SPEC_TRANS, 1.0,
                           rng.uniform(1.3, 1.7, (n, k))).astype(np.float32)}


_STACKS = {"glass": (jbsdf.SPEC_REFL, jbsdf.SPEC_TRANS),
           "uber": (jbsdf.LAMBERT, jbsdf.BLINN, jbsdf.SPEC_REFL, jbsdf.SPEC_TRANS),
           "matte_mirror": (jbsdf.OREN_NAYAR, jbsdf.SPEC_REFL)}


@pytest.mark.parametrize("stack", sorted(_STACKS))
def test_bsdf_sample_mixed_stack_matches_reference(stack):
    """pbrt BSDF::Sample_f per lane: the component pick, a delta pick's value
    and pdf 1/n_match; a non-delta pick's summed f and averaged pdf. uber's
    pass-through lobe (SPEC_TRANS, ior 1) goes straight through."""
    rng = np.random.default_rng(sorted(_STACKS).index(stack))
    types = _STACKS[stack]
    lobes = _stack(rng, N, types)
    if stack == "glass":
        lobes["f2"][:] = 1.5
    wo = _dirs(rng, N)
    u = rng.random((3, N)).astype(np.float32)
    present = tuple(sorted(set(types)))
    ref = jbsdf.bsdf_sample({k: jnp.asarray(v) for k, v in lobes.items()},
                            jnp.asarray(wo), *jnp.asarray(u), present)
    got = tbsdf.bsdf_sample({k: torch.tensor(v) for k, v in lobes.items()},
                            torch.tensor(wo), *torch.tensor(u), present)
    for key in ("specular", "valid", "wi", "pdf", "f"):
        _close(got[key], ref[key], key)
    spec = np.asarray(ref["specular"])
    assert spec.any() and (stack == "glass" or not spec.all())
    if stack == "uber":
        # the ior-1 pass-through crosses the surface with no sideways offset
        wi = got["wi"].numpy()
        through = spec & (np.sign(wi[:, 2]) != np.sign(wo[:, 2]))
        assert through.sum() >= N // 8
        np.testing.assert_array_equal(wi[through, :2], -wo[through, :2])
        # cosθt = sqrt(1 - sin²θ) rounds 1 - cos²θ in float32: near grazing
        # the cosine keeps only a few of its bits
        np.testing.assert_allclose(wi[through, 2], -wo[through, 2], atol=1e-4)
    # delta lobes have no f or pdf outside a sample of them
    wi = torch.tensor(_dirs(rng, N))
    tl = {k: torch.tensor(v) for k, v in lobes.items()}
    jl = {k: jnp.asarray(v) for k, v in lobes.items()}
    _close(tbsdf.bsdf_f(tl, torch.tensor(wo), wi, present, include_specular=False),
           jbsdf.bsdf_f(jl, jnp.asarray(wo), jnp.asarray(wi.numpy()), present,
                        include_specular=False), "bsdf_f")
    _close(tbsdf.bsdf_pdf(tl, torch.tensor(wo), wi, present),
           jbsdf.bsdf_pdf(jl, jnp.asarray(wo), jnp.asarray(wi.numpy()), present), "bsdf_pdf")
    if stack == "glass":
        assert not tbsdf.bsdf_f(tl, torch.tensor(wo), wi, present).any()


def test_scale_and_mix_textures_match_reference():
    rng = np.random.default_rng(7)
    n = 512
    const = rng.random((4, 3)).astype(np.float32)
    specs = [ttex.TexSpec(kind="const")] * 4 + [
        ttex.TexSpec(kind="scale", inputs=(0, 1)),
        ttex.TexSpec(kind="mix", inputs=(4, 2, 3)),
        ttex.TexSpec(kind="mix", inputs=(1, 5, 0))]
    jspecs = [jtex.TexSpec(kind=s.kind, inputs=s.inputs) for s in specs]
    w2t = np.tile(np.eye(4, dtype=np.float32), (len(specs), 1, 1))
    cst = np.concatenate([const, np.zeros((3, 3), np.float32)])
    p = rng.random((n, 3)).astype(np.float32)
    uv = rng.random((n, 2)).astype(np.float32)
    ref = jtex.eval_textures(tuple(jspecs), {"const": jnp.asarray(cst),
                                             "w2t": jnp.asarray(w2t)},
                             {"p": jnp.asarray(p), "uv": jnp.asarray(uv)})
    got = ttex.eval_textures(tuple(specs), {"const": torch.tensor(cst),
                                            "w2t": torch.tensor(w2t)},
                             {"p": torch.tensor(p), "uv": torch.tensor(uv)})
    _close(got, ref, "textures")


# ------------------------------------------------------------------- slice
def _scene_text(name, res=None):
    with open(os.path.join(SCENES, name + ".pbrt")) as f:
        text = f.read()
    if res is not None:
        text = re.sub(r'"integer xresolution" \[\d+\] "integer yresolution" \[\d+\]',
                      f'"integer xresolution" [{res}] "integer yresolution" [{res}]', text)
    return text


@pytest.mark.parametrize("name", PATH_GOLDENS)
def test_li_matches_reference_per_lane(name):
    """One camera wave of every authored sample at 16x16, made by the
    reference's raygen, through both li."""
    res = 16
    text = _scene_text(name, res)
    js, jm, japi = jparser.parse_string(text, search_path=SCENES)
    ts, tm, tapi = tparser.parse_string(text, device="cpu", search_path=SCENES)
    spp = jm.sampler.spp
    n_pix = res * res
    px_t, py_t = jfilm.lane_pixel(jnp.arange(n_pix, dtype=jnp.uint32), res)
    pix = jnp.tile(py_t.astype(jnp.uint32) * res + px_t.astype(jnp.uint32), spp)
    samp = jnp.repeat(jnp.arange(spp, dtype=jnp.uint32), n_pix)
    ufx, ufy = jrng.sample_2d(jm.sampler, pix, samp, jint.SLOT_FILM)
    ul1, ul2 = jrng.sample_2d(jm.sampler, pix, samp, jint.SLOT_LENS)
    ut = jrng.sample_1d(jm.sampler, pix, samp, jint.SLOT_TIME)
    rays = jcam.generate_rays(js["camera"], (pix % res).astype(jnp.int32),
                              (pix // res).astype(jnp.int32), ufx, ufy, ul1, ul2,
                              ut, jm.cam_kind)
    rays = {k: rays[k] for k in ("o", "d", "weight")}
    L_ref = np.asarray(jax.jit(partial(jint.li, js, jm, japi.integrator_config))(
        rays, pix, samp))
    L = tint.li(ts, tm, tapi.integrator_config,
                {k: torch.tensor(np.asarray(v)) for k, v in rays.items()},
                torch.tensor(np.asarray(pix).astype(np.int64)),
                torch.tensor(np.asarray(samp).astype(np.int64))).numpy()
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"


def test_cornell_li_matches_path_oracle():
    """The port's Cornell box (LAMBERT walls, one area light) against the
    independent float64 NumPy path estimator on the same sample stream, per
    (pixel, sample), at tests/test_oracle.py's quantiles."""
    xres = yres = 24
    spp = 6
    scene, meta, b = cornell_box(xres=xres, yres=yres, spp=spp, device="cpu")
    n_pix = xres * yres
    pix = np.tile(np.arange(n_pix, dtype=np.uint32), spp)
    samp = np.repeat(np.arange(spp, dtype=np.uint32), n_pix)
    pix_t = torch.tensor(pix.astype(np.int64))
    samp_t = torch.tensor(samp.astype(np.int64))
    rays = camera_rays(scene, meta, pix_t, samp_t)[0]
    cfg = tint.IntegratorConfig(kind="path", max_depth=5, compact=False)
    L_dev = tint.li(scene, meta, cfg, rays, pix_t, samp_t).numpy().astype(np.float64)
    sc = op.extract({k: v for k, v in scene.items()}, meta, b)
    L_ref = op.path_radiance(sc, pix, samp, xres, max_depth=cfg.max_depth,
                             rr_depth=cfg.rr_depth)
    rel = np.abs(L_dev - L_ref).max(axis=-1) / np.maximum(1.0, np.abs(L_ref).max(axis=-1))
    assert np.quantile(rel, 0.95) < 2e-5, np.quantile(rel, 0.95)
    assert np.quantile(rel, 0.999) < 1e-2, np.quantile(rel, 0.999)
    assert (rel < 1e-4).mean() > 0.97
    assert abs(L_dev.mean() - L_ref.mean()) / L_ref.mean() < 2e-3


@pytest.mark.parametrize("name", PATH_GOLDENS)
def test_golden_at_authored_settings(name):
    """The scene file as authored (resolution, sampler, samples, filter,
    depth) through the port's parser and render, against its golden."""
    scene, meta, api = tparser.parse_file(os.path.join(SCENES, name + ".pbrt"),
                                          device="cpu")
    img, _ = render(scene, meta, api.integrator_config, device="cpu")
    img = img.numpy()
    gold = read_image(os.path.join(GOLDENS, name + ".exr"))
    assert img.shape == gold.shape and np.isfinite(img).all()
    assert relative_mae(img, gold) < GOLDEN_RELMAE
