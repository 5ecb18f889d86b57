"""The port's last lobes and its measured BRDFs against the reference's.

Seeded numpy inputs through both packages. Henyey-Greenstein's pdf and
sample (rtol 1e-5, atol 1e-6, the port's tolerance for float stages). ANISO, FRESNEL_BLEND, LAMBERT_T, BLINN_T and MEASURED: lobe_f,
lobe_pdf and lobe_sample_wi per lane, rtol 1e-4 where a microfacet
distribution raises a rounded cosine to an exponent of up to 100 (its
relative error grows with the exponent), rtol 1e-5 elsewhere; bsdf_sample
over the translucent, substrate and measured stacks. The .brdf reader and
the bake are host numpy and bitwise; MERL's reader too, on a file of its
size. The measured lookup picks each lane's cell by truncating a float
product, so one ulp in arccos or atan2 can move a lane to the next cell:
the test states the share of lanes whose cell is the reference's (at least
99%) and bounds every other lane to a neighbouring cell. Last, a scene
with an ANISO material, which no parser directive reaches, built by both
packages' SceneBuilder with the same calls: li per lane at 16x16 (>= 99% of
lanes within rtol 1e-4, atol 1e-6, as tests/test_torch_render.py).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.core import montecarlo as jmc, rng as jrng
from grail.engine import camera as jcam
from grail.engine import integrator as jint
from grail.scene import buffers as jbuf
from grail.shade import bsdf as jbsdf, measured as jmsr
from grail_torch.core import montecarlo as tmc, rng as trng, transform as ttr
from grail_torch.engine import camera as tcam
from grail_torch.engine import integrator as tint
from grail_torch.scene import buffers as tbuf
from grail_torch.shade import bsdf as tbsdf, measured as tmsr
from tests.test_torch_goldens import _both, _close, _dirs

torch.set_num_threads(2)

N = 4096
SCENES = os.path.join(os.path.dirname(__file__), os.pardir, "scenes")
BRDF = os.path.join(SCENES, "assets", "redglossy.brdf")
NEW_LOBES = {"aniso": jbsdf.ANISO, "fresnel_blend": jbsdf.FRESNEL_BLEND,
             "lambert_t": jbsdf.LAMBERT_T, "blinn_t": jbsdf.BLINN_T,
             "measured": jbsdf.MEASURED}


@pytest.fixture(scope="module")
def table():
    return jmsr.bake_irregular(*jmsr.read_brdf(BRDF))


# ----------------------------------------------------------- Henyey-Greenstein
def test_henyey_greenstein_matches_reference():
    rng = np.random.default_rng(10)
    cos = rng.uniform(-1, 1, N).astype(np.float32)
    g = rng.uniform(-0.95, 0.95, N).astype(np.float32)
    g[:256] = rng.uniform(-1e-3, 1e-3, 256)          # the isotropic branch
    u1, u2 = rng.random(N).astype(np.float32), rng.random(N).astype(np.float32)
    w = _dirs(rng, N)
    (jc, jg, ju1, ju2, jw), (tc, tg, tu1, tu2, tw) = _both(cos, g, u1, u2, w)
    _close(tmc.hg_pdf(tc, tg), jmc.hg_pdf(jc, jg), "hg_pdf")
    got = tmc.sample_hg(tw, tu1, tu2, tg)
    _close(got, jmc.sample_hg(jw, ju1, ju2, jg), "sample_hg", atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


# ----------------------------------------------------------------- the lobes
def _lobe_inputs(rng, lobe):
    """Directions in both hemispheres, spectra, exponents (1/roughness for
    roughness in [0.01, 1]), iors and Fresnel kinds for one lobe type."""
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    wo[: N // 2, 2] = np.abs(wo[: N // 2, 2])
    R, S1 = rng.random((N, 3)).astype(np.float32), rng.random((N, 3)).astype(np.float32)
    S2 = rng.uniform(0.5, 4.0, (N, 3)).astype(np.float32)
    f0, f1 = (1.0 / rng.uniform(0.01, 1.0, N)).astype(np.float32), \
        (1.0 / rng.uniform(0.01, 1.0, N)).astype(np.float32)
    f2 = rng.uniform(1.1, 2.4, N).astype(np.float32)
    fr = (np.arange(N) % 3).astype(np.int32)         # noop, dielectric, conductor
    u1, u2 = rng.random(N).astype(np.float32), rng.random(N).astype(np.float32)
    t = np.full(N, lobe, np.int32)
    return t, wo, wi, R, S1, S2, f0, f1, f2, fr, u1, u2


@pytest.mark.parametrize("name", sorted(NEW_LOBES))
def test_new_lobe_matches_reference(name, table):
    lobe = NEW_LOBES[name]
    rng = np.random.default_rng(sorted(NEW_LOBES).index(name) + 20)
    arrays = _lobe_inputs(rng, lobe)
    if lobe == jbsdf.MEASURED:
        arrays[7][:] = 0.0                            # f1: the table row
    (jt, jwo, jwi, jR, jS1, jS2, jf0, jf1, jf2, jfr, ju1, ju2), \
        (tt, two, twi, tR, tS1, tS2, tf0, tf1, tf2, tfr, tu1, tu2) = _both(*arrays)
    present = (lobe,)
    tables_j, tables_t = (jnp.asarray(table),), (torch.tensor(table),)
    ref_f = np.asarray(jbsdf.lobe_f(jt, jwo, jwi, jR, jS1, jS2, jf0, jf1, jf2, jfr,
                                    present, tables=tables_j))
    got_f = tbsdf.lobe_f(tt, two, twi, tR, tS1, tS2, tf0, tf2, tfr, present, tf1,
                         tables_t).numpy()
    assert (ref_f > 0).any(axis=-1).mean() > 0.2, name
    if lobe == jbsdf.MEASURED:
        # a lane whose cell moved (test_measured_lookup_cells) has another value
        close = np.all(np.isclose(got_f, ref_f, rtol=1e-5, atol=1e-6), axis=-1)
        assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"
    else:
        rtol = 1e-5 if lobe == jbsdf.LAMBERT_T else 1e-4
        _close(got_f, ref_f, "f", rtol=rtol)
    _close(tbsdf.lobe_pdf(tt, two, twi, tf0, present, tf1),
           jbsdf.lobe_pdf(jt, jwo, jwi, jf0, jf1, present), "pdf", rtol=1e-4)
    wi_ref, ok_ref = jbsdf.lobe_sample_wi(jt, jwo, ju1, ju2, jf0, jf1, jf2, present)
    wi_got, ok_got = tbsdf.lobe_sample_wi(tt, two, tu1, tu2, tf0, tf2, present, tf1)
    _close(ok_got, ok_ref, "valid")
    _close(wi_got, wi_ref, "wi", atol=1e-5)


STACKS = {   # (lobe types, Fresnel kinds) of the parser's new materials
    "translucent": ((jbsdf.LAMBERT, jbsdf.BLINN, jbsdf.LAMBERT_T, jbsdf.BLINN_T),
                    (0, 1, 0, 1)),
    "substrate": ((jbsdf.FRESNEL_BLEND,), (0,)),
    "measured": ((jbsdf.MEASURED,), (0,)),
}


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_bsdf_sample_over_new_stacks(stack, table):
    types, frs = STACKS[stack]
    rng = np.random.default_rng(sorted(STACKS).index(stack) + 30)
    K = len(types)
    lobes = {"type": np.tile(np.asarray(types, np.int32), (N, 1)),
             "fr": np.tile(np.asarray(frs, np.int32), (N, 1)),
             "R": rng.random((N, K, 3)).astype(np.float32),
             "S1": rng.random((N, K, 3)).astype(np.float32),
             "S2": rng.random((N, K, 3)).astype(np.float32),
             "f0": (1.0 / rng.uniform(0.05, 1.0, (N, K))).astype(np.float32),
             "f1": (1.0 / rng.uniform(0.05, 1.0, (N, K))).astype(np.float32),
             "f2": np.full((N, K), 1.5, np.float32)}
    if stack == "measured":
        lobes["f1"][:] = 0.0
    wo = _dirs(rng, N)
    u = [rng.random(N).astype(np.float32) for _ in range(3)]
    present = tuple(sorted(set(types)))
    jl = {k: jnp.asarray(v) for k, v in lobes.items()}
    tl = {k: torch.tensor(v) for k, v in lobes.items()}
    ref = jbsdf.bsdf_sample(jl, jnp.asarray(wo), *map(jnp.asarray, u), present,
                            tables=(jnp.asarray(table),))
    got = tbsdf.bsdf_sample(tl, torch.tensor(wo), *map(torch.tensor, u), present,
                            tables=(torch.tensor(table),))
    for k in ("specular", "valid"):
        _close(got[k], ref[k], k)
    _close(got["wi"], ref["wi"], "wi", atol=1e-5)
    ok = np.asarray(ref["valid"])
    assert ok.mean() > 0.3
    close = np.all(np.isclose(got["f"].numpy(), np.asarray(ref["f"]), rtol=1e-4,
                              atol=1e-6), axis=-1) & np.isclose(
        got["pdf"].numpy(), np.asarray(ref["pdf"]), rtol=1e-4, atol=1e-6)
    # every lane, but the measured stack's lanes whose cell moved
    assert close.mean() >= (0.99 if stack == "measured" else 1.0), close.mean()


# ---------------------------------------------------------- measured tables
def test_brdf_reader_and_bake_match_reference_bitwise():
    angles_j, rgb_j = jmsr.read_brdf(BRDF)
    angles_t, rgb_t = tmsr.read_brdf(BRDF)
    np.testing.assert_array_equal(angles_t, angles_j)
    np.testing.assert_array_equal(rgb_t, rgb_j)
    tab_j = jmsr.bake_irregular(angles_j, rgb_j)
    tab_t = tmsr.bake_irregular(angles_t, rgb_t)
    assert tab_t.shape == (32, 16, 32, 3) and tab_t.max() > 0
    np.testing.assert_array_equal(tab_t, tab_j)
    np.testing.assert_array_equal(tmsr.albedo_estimate(tab_t), jmsr.albedo_estimate(tab_j))


def test_merl_reader_matches_reference(tmp_path):
    """A file in MERL's layout (three int32 dims, then every channel's
    doubles) read by both packages, bitwise."""
    n = tmsr.MERL_N_THETA_H * tmsr.MERL_N_THETA_D * tmsr.MERL_N_PHI_D
    path = tmp_path / "fake.binary"
    with open(path, "wb") as f:
        np.asarray([90, 90, 180], np.int32).tofile(f)
        np.random.default_rng(5).uniform(-0.1, 2.0, 3 * n).tofile(f)
    got, ref = tmsr.read_merl(str(path)), jmsr.read_merl(str(path))
    assert got.shape == (90, 90, 180, 3) and got.min() >= 0.0
    np.testing.assert_array_equal(got, ref)


def _cells(th, td, pd, shape, xp):
    """The nearest-cell indices lookup takes, in the package's arithmetic."""
    nh, nd, npd = shape
    if xp is jnp:
        i32 = lambda x: x.astype(jnp.int32)              # noqa: E731
    else:
        i32 = lambda x: x.to(torch.int32)                # noqa: E731
    ih = i32(xp.sqrt(xp.clip(th / (np.pi / 2), 0.0, None)) * nh)
    return np.stack([np.clip(np.asarray(ih), 0, nh - 1),
                     np.clip(np.asarray(i32(td / (np.pi / 2) * nd)), 0, nd - 1),
                     np.clip(np.asarray(i32(pd / np.pi * npd)), 0, npd - 1)], -1)


def test_measured_lookup_cells(table):
    rng = np.random.default_rng(40)
    wo, wi = _dirs(rng, N, 1.0), _dirs(rng, N, 1.0)
    (jwo, jwi), (two, twi) = _both(wo, wi)
    coords_j = jmsr._halfdiff_coords(jwo, jwi)
    coords_t = tmsr._halfdiff_coords(two, twi)
    for got, ref, what in zip(coords_t, coords_j, ("theta_h", "theta_d", "phi_d")):
        _close(got, ref, what, atol=1e-5)
    cells_j = _cells(*coords_j, table.shape[:3], jnp)
    cells_t = _cells(*coords_t, table.shape[:3], torch)
    same = np.all(cells_t == cells_j, axis=-1)
    # state the share: at least 99% of lanes in the reference's cell, and no
    # lane further than the neighbouring cell
    assert same.mean() >= 0.99, f"{same.mean():.4%} of lanes in the reference's cell"
    assert np.abs(cells_t - cells_j).max() <= 1
    gid = np.zeros(N, np.int32)
    ref = np.asarray(jmsr.lookup((jnp.asarray(table),), jnp.asarray(gid), jwo, jwi))
    got = tmsr.lookup((torch.tensor(table),), torch.tensor(gid), two, twi).numpy()
    np.testing.assert_array_equal(got[same], ref[same])
    np.testing.assert_array_equal(got, table[tuple(cells_t.T)])


# ----------------------------------------------------- ANISO through the builder
def _aniso_scene(buf, cam, rng_mod, **finalize):
    """The same calls on either package's SceneBuilder: an anisotropic
    conductor quad (exponents 40 and 400) and a Lambertian quad under a
    point light, 16x16."""
    b = buf.SceneBuilder()
    ks = b.const_tex((0.9, 0.8, 0.6))
    eta, k = b.const_tex((0.2, 0.9, 1.1)), b.const_tex((3.9, 2.4, 2.1))
    ex, ey = b.const_tex((40.0,) * 3), b.const_tex((400.0,) * 3)
    aniso = b.add_material([{"type": jbsdf.ANISO, "s0": ks, "s1": eta, "s2": k,
                             "fr": jbsdf.FR_CONDUCTOR, "f0": ex, "f1": ey}])
    quad = np.asarray([[0, 1, 2], [0, 2, 3]])
    b.add_mesh(np.asarray([[-2, 0, 2], [2, 0, 2], [2, 0, -2], [-2, 0, -2]], np.float32),
               quad, aniso)
    b.add_mesh(np.asarray([[-2, 0, -2], [2, 0, -2], [2, 2, -2], [-2, 2, -2]], np.float32),
               quad, b.matte(kd=(0.6, 0.5, 0.4)))
    b.add_point_light(np.asarray([0.5, 1.5, 1.0], np.float32), (6.0, 6.0, 6.0))
    c2w = ttr.look_at([0.0, 1.6, 3.2], [0.0, 0.3, 0.0], [0.0, 1.0, 0.0])
    b.xres = b.yres = 16
    b.sampler = rng_mod.SamplerConfig(kind=rng_mod.ZERO_TWO, spp=1)
    b.camera = cam.build_camera(cam.PERSPECTIVE, c2w, c2w, 16, 16, fov=50.0)
    return b.finalize(**finalize)


def test_aniso_scene_li_matches_reference():
    js, jm = _aniso_scene(jbuf, jcam, jrng)
    ts, tm = _aniso_scene(tbuf, tcam, trng, device="cpu")
    assert jbsdf.ANISO in tm.lobe_types and tm.lobe_types == jm.lobe_types
    pix = jnp.arange(256, dtype=jnp.uint32)
    samp = jnp.zeros_like(pix)
    ufx, ufy = jrng.sample_2d(jm.sampler, pix, samp, jint.SLOT_FILM)
    rays = jcam.generate_rays(js["camera"], (pix % 16).astype(jnp.int32),
                              (pix // 16).astype(jnp.int32), ufx, ufy, ufx, ufy, ufx,
                              jm.cam_kind)
    rays = {k: rays[k] for k in ("o", "d", "weight")}
    cfg_j = jint.IntegratorConfig(kind="path", max_depth=3)
    L_ref = np.asarray(jax.jit(lambda r, p, s: jint.li(js, jm, cfg_j, r, p, s))(
        rays, pix, samp))
    L = tint.li(ts, tm, tint.IntegratorConfig(kind="path", max_depth=3),
                {k: torch.tensor(np.asarray(v)) for k, v in rays.items()},
                torch.tensor(np.asarray(pix).astype(np.int64)),
                torch.tensor(np.asarray(samp).astype(np.int64))).numpy()
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"
