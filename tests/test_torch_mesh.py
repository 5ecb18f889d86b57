"""The port's mesh-scene path against grail's: the 100k-triangle terrain
preset cut to grid=24 (3,266 triangles), with its image texture, glossy
sphere and environment light, carried across by scene_from_numpy.

Stages (inputs made with numpy from a seed): Distribution2D build, sample
and pdf to rtol 1e-5; MIP pyramid build and pack bit for bit; EWA and image
lookups with uv differentials, the BLINN lobe with dielectric Fresnel and
the infinite light to rtol 1e-4 (float32 transcendental functions and
another operation order round the last bits differently).
Slice: li per lane at depth 3 (>= 99% of lanes within rtol 1e-4, atol 1e-6,
as in tests/test_torch_render.py), unbinned and with ray binning forced on
(the 4-wide traversal's route), the rendered image's relative MAE below
1e-3, and wavefront compaction bitwise equal to compact=False.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.core import montecarlo as jmc
from grail.core import rng as jrng
from grail.engine import camera as jcam, film as jfilm
from grail.engine import integrator as jint
from grail.engine.render import render as jax_render
from grail.kernels.intersect import intersect_brute
from grail.scene.presets import _checker_image, mesh_scene
from grail.shade import bsdf as jbsdf, geometry as jgeom, lights as jlights
from grail.shade import mipmap as jmip, textures as jtex
from grail_torch.core import montecarlo as tmc
from grail_torch.engine import integrator as tint
from grail_torch.engine.render import camera_rays, megawave_lanes, render
from grail_torch.kernels import intersect as tisect
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.scene.presets import mesh_scene as torch_mesh_scene
from grail_torch.shade import bsdf as tbsdf, geometry as tgeom, lights as tlights
from grail_torch.shade import mipmap as tmip, textures as ttex

torch.set_num_threads(2)

RES, SPP, DEPTH = 16, 2, 3
N = 2048


def relative_mae(a, b):
    return float(np.mean(np.abs(a - b)) / (np.mean(np.abs(b)) + 1e-6))


def _close(ref, got, what, rtol=1e-4, atol=1e-6):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, what
    if ref.dtype == np.bool_ or np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def mesh():
    scene, meta, _ = mesh_scene(RES, RES, SPP, grid=24)
    ts, tm = scene_from_numpy(jax.tree_util.tree_map(np.asarray, scene), meta,
                              device="cpu")
    return scene, meta, ts, tm


def _camera_wave(scene, meta):
    """Camera rays of one SPP megawave and their differential rays, made by
    the reference's raygen as its render_wave makes them."""
    n_pix = RES * RES
    px_t, py_t = jfilm.lane_pixel(jnp.arange(n_pix, dtype=jnp.uint32), RES)
    pix = jnp.tile(py_t.astype(jnp.uint32) * RES + px_t.astype(jnp.uint32), SPP)
    samp = jnp.repeat(jnp.arange(SPP, dtype=jnp.uint32), n_pix)
    ufx, ufy = jrng.sample_2d(meta.sampler, pix, samp, jint.SLOT_FILM)
    ul1, ul2 = jrng.sample_2d(meta.sampler, pix, samp, jint.SLOT_LENS)
    ut = jrng.sample_1d(meta.sampler, pix, samp, jint.SLOT_TIME)
    px, py = (pix % RES).astype(jnp.int32), (pix // RES).astype(jnp.int32)

    def gen(x, y):
        return jcam.generate_rays(scene["camera"], x, y, ufx, ufy, ul1, ul2, ut,
                                  meta.cam_kind)
    rays, rx, ry = gen(px, py), gen(px + 1, py), gen(px, py + 1)
    rays = {k: rays[k] for k in ("o", "d", "weight")}
    rays["camdiff"] = (rx["o"], rx["d"], ry["o"], ry["d"])
    return rays, pix, samp


def _to_torch(rays, pix, samp):
    rt = {k: torch.tensor(np.asarray(v)) for k, v in rays.items() if k != "camdiff"}
    rt["camdiff"] = tuple(torch.tensor(np.asarray(v)) for v in rays["camdiff"])
    return (rt, torch.tensor(np.asarray(pix).astype(np.int64)),
            torch.tensor(np.asarray(samp).astype(np.int64)))


# ------------------------------------------------------------------- stages
def _distribution(rs, scene, meta, ts, tm):
    func = (rs.rand(16, 24) ** 3).astype(np.float32)
    func[3] = 0.0                                   # an all-zero row
    ref = jmc.build_distribution_2d(jnp.asarray(func))
    got = tmc.build_distribution_2d(torch.tensor(func))
    for part in ("cond", "marg"):
        for k in ref[part]:
            _close(ref[part][k], got[part][k], f"{part} {k}", rtol=1e-5)
    u1, u2 = rs.rand(2, N).astype(np.float32)
    ru, rv, rpdf = jmc.sample_distribution_2d(ref, jnp.asarray(u1), jnp.asarray(u2))
    gu, gv, gpdf = tmc.sample_distribution_2d(got, torch.tensor(u1), torch.tensor(u2))
    for what, a, b in (("u", ru, gu), ("v", rv, gv), ("pdf", rpdf, gpdf)):
        _close(a, b, "sample " + what, rtol=1e-5)
    _close(jmc.distribution_2d_pdf(ref, jnp.asarray(u1), jnp.asarray(u2)),
           tmc.distribution_2d_pdf(got, torch.tensor(u1), torch.tensor(u2)),
           "pdf", rtol=1e-5)


def _pyramid(rs, scene, meta, ts, tm):
    for img in (_checker_image(), rs.rand(20, 24, 3).astype(np.float32)):
        ref, got = jmip.build_pyramid(img), tmip.build_pyramid(img)
        assert len(ref) == len(got)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(b, a)
        rp, gp = jmip.pack_pyramid(ref), tmip.pack_pyramid(got)
        assert rp["n_levels"] == gp["n_levels"]
        for k in ("flat", "h", "w", "off"):
            np.testing.assert_array_equal(gp[k], np.asarray(rp[k]), err_msg=k)


def _textures(rs, scene, meta, ts, tm):
    """lookup_ewa, lookup_trilinear and image_lookup with differentials
    spanning every pyramid level, and the finest-level bilinear path."""
    s, t = (rs.rand(2, N) * 3 - 1).astype(np.float32)
    dd = (rs.randn(4, N) * np.exp(rs.uniform(-9, 0, (4, N)))).astype(np.float32)
    pyr_j, pyr_t = scene["mipmaps"][0], ts["mipmaps"][0]
    args_j = [jnp.asarray(a) for a in (s, t, *dd)]
    args_t = [torch.tensor(a) for a in (s, t, *dd)]
    _close(jmip.lookup_ewa(pyr_j, *args_j), tmip.lookup_ewa(pyr_t, *args_t), "ewa")
    width = np.abs(dd[0]) * 2
    _close(jmip.lookup_trilinear(pyr_j, *args_j[:2], jnp.asarray(width)),
           tmip.lookup_trilinear(pyr_t, *args_t[:2], torch.tensor(width)), "trilinear")
    spec = meta.tex_specs[0]
    assert spec.kind == "image"
    uv = rs.rand(N, 2).astype(np.float32)
    sg_j = {"uv": jnp.asarray(uv), "duvdx": jnp.asarray(dd[:2].T),
            "duvdy": jnp.asarray(dd[2:].T)}
    sg_t = {k: torch.tensor(np.asarray(v)) for k, v in sg_j.items()}
    for sgj, sgt in ((sg_j, sg_t), ({"uv": sg_j["uv"]}, {"uv": sg_t["uv"]})):
        ss, tt = jtex.apply_mapping(spec, None, sgj)
        _close(jtex.image_lookup(spec, scene["images"], scene["mipmaps"], sgj, ss, tt),
               ttex.image_lookup(spec, ts["images"], ts["mipmaps"], sgt,
                                 *ttex.apply_mapping(spec, None, sgt)), "image_lookup")


def _uv_differentials(rs, scene, meta, ts, tm):
    rays, _, _ = _camera_wave(scene, meta)
    hit = intersect_brute(scene, rays["o"], rays["d"],
                          jnp.full(rays["o"].shape[:1], 1e7, jnp.float32))
    assert float(jnp.mean(hit["prim"] >= 0)) > 0.5
    sg = jgeom.shading_geometry(scene, hit, rays["o"], rays["d"])
    got_sg = tgeom.shading_geometry(
        ts, {k: torch.tensor(np.asarray(v)) for k, v in hit.items()},
        torch.tensor(np.asarray(rays["o"])), torch.tensor(np.asarray(rays["d"])))
    ref = jgeom.uv_differentials(sg, *rays["camdiff"])
    got = tgeom.uv_differentials(got_sg, *(torch.tensor(np.asarray(v))
                                           for v in rays["camdiff"]))
    hit = np.asarray(hit["prim"]) >= 0          # a miss's record is garbage
    for a, b, what in zip(ref, got, ("duvdx", "duvdy")):
        _close(np.asarray(a)[hit], b.numpy()[hit], what, atol=1e-5)


def _blinn(rs, scene, meta, ts, tm):
    """A two-slot LAMBERT + BLINN stack with dielectric Fresnel, as the
    sphere's material, with a NONE slot on some lanes."""
    types = np.stack([rs.choice([jbsdf.NONE, jbsdf.LAMBERT], N),
                      np.full(N, jbsdf.BLINN)], 1).astype(np.int32)
    lobes = {"type": types,
             "fr": np.where(types == jbsdf.BLINN, jbsdf.FR_DIELECTRIC,
                            jbsdf.FR_NOOP).astype(np.int32),
             "R": rs.rand(N, 2, 3).astype(np.float32),
             "S1": np.zeros((N, 2, 3), np.float32),
             "S2": np.zeros((N, 2, 3), np.float32),
             "f0": rs.uniform(1.0, 60.0, (N, 2)).astype(np.float32),
             "f1": np.zeros((N, 2), np.float32),
             "f2": np.full((N, 2), 1.5, np.float32)}
    wo, wi = _unit(rs, N), _unit(rs, N)
    u = rs.rand(3, N).astype(np.float32)
    present = (jbsdf.LAMBERT, jbsdf.BLINN)
    jl = {k: jnp.asarray(v) for k, v in lobes.items()}
    tl = {k: torch.tensor(v) for k, v in lobes.items()}
    ref = jbsdf.bsdf_sample(jl, jnp.asarray(wo), *map(jnp.asarray, u), present)
    got = tbsdf.bsdf_sample(tl, torch.tensor(wo), *map(torch.tensor, u), present)
    for k in ("wi", "f", "pdf", "specular", "valid"):
        _close(ref[k], got[k], "sample " + k, atol=1e-5)
    assert bool(got["valid"].any()) and not bool(got["valid"].all())
    _close(jbsdf.bsdf_f(jl, jnp.asarray(wo), jnp.asarray(wi), present),
           tbsdf.bsdf_f(tl, torch.tensor(wo), torch.tensor(wi), present), "f")
    _close(jbsdf.bsdf_pdf(jl, jnp.asarray(wo), jnp.asarray(wi), present),
           tbsdf.bsdf_pdf(tl, torch.tensor(wo), torch.tensor(wi), present), "pdf")
    cosi = rs.uniform(-1, 1, N).astype(np.float32)
    _close(jbsdf.fr_dielectric(jnp.asarray(cosi), 1.0, 1.5),
           tbsdf.fr_dielectric(torch.tensor(cosi), torch.tensor(1.0), torch.tensor(1.5)),
           "fr_dielectric")


def _infinite(rs, scene, meta, ts, tm):
    p = (rs.rand(N, 3) * 8 - 4).astype(np.float32)
    u = rs.rand(3, N).astype(np.float32)
    li = np.zeros(N, np.int32)
    assert int(scene["env_row"]) == 0 and meta.light_types == (jlights.INFINITE,)
    ref = jlights.sample_li(scene, jnp.asarray(li), jnp.asarray(p),
                            *map(jnp.asarray, u), meta.light_types)
    got = tlights.sample_li(ts, torch.tensor(li), torch.tensor(p),
                            *map(torch.tensor, u), tm.light_types)
    for k in ("wi", "radiance", "pdf", "dist", "delta"):
        _close(ref[k], got[k], k)
    w = _unit(rs, N)
    _close(jlights.env_pdf(scene, jnp.asarray(li), jnp.asarray(w)),
           tlights.env_pdf(ts, torch.tensor(li), torch.tensor(w)), "env_pdf")
    _close(jlights.escaped_radiance(scene, jnp.asarray(w), meta.light_types),
           tlights.escaped_radiance(ts, torch.tensor(w), tm.light_types), "escaped")


_STAGES = {"distribution": _distribution, "pyramid": _pyramid,
           "textures": _textures, "uv_differentials": _uv_differentials,
           "blinn": _blinn, "infinite": _infinite}


@pytest.mark.parametrize("stage", sorted(_STAGES))
def test_stage_matches_reference(stage, mesh):
    _STAGES[stage](np.random.RandomState(sorted(_STAGES).index(stage)), *mesh)


# -------------------------------------------------------------------- slice
@pytest.fixture(scope="module")
def li_ref(mesh):
    """The reference's li over one camera wave, with the port's inputs."""
    scene, meta, _, _ = mesh
    rays, pix, samp = _camera_wave(scene, meta)
    cfg = jint.IntegratorConfig(kind="path", max_depth=DEPTH)
    L_ref = np.asarray(jax.jit(partial(jint.li, scene, meta, cfg))(rays, pix, samp))
    return L_ref, _to_torch(rays, pix, samp)


def _li_close(mesh, li_ref):
    _, _, ts, tm = mesh
    L_ref, args = li_ref
    L = tint.li(ts, tm, tint.IntegratorConfig(kind="path", max_depth=DEPTH),
                *args).numpy()
    assert np.isfinite(L).all() and L.mean() > 0.01
    close = np.all(np.abs(L - L_ref) <= 1e-6 + 1e-4 * np.abs(L_ref), axis=-1)
    assert close.mean() >= 0.99, f"{close.mean():.4%} of lanes match"


def test_li_matches_reference_per_lane(mesh, li_ref):
    _li_close(mesh, li_ref)


def test_li_binned_matches_reference_per_lane(mesh, li_ref, monkeypatch):
    """With the binning threshold lowered below this wave's 512 lanes, the
    bounces after the camera wave bin and sort their rays, take the 4-wide
    traversal and gather the results back, as every wave of the bench
    render does; the camera wave takes the 4-wide traversal unbinned. The
    reference, at its own threshold, bins none of them."""
    kinds = []

    def recording(route, traverse):
        def call(*args, **kw):
            kinds.append((route, kw.get("kind"), kw.get("any_hit", False)))
            return traverse(*args, **kw)
        return call

    monkeypatch.setattr(tisect, "SORT_MIN", 256)
    monkeypatch.setattr(tisect, "bvh4_traverse", recording("bvh4", tisect.bvh4_traverse))
    _li_close(mesh, li_ref)
    assert kinds.count(("bvh4", None, False)) == DEPTH + 1
    assert {k for k in kinds if k[2]} == {("bvh4", None, True)}


def test_render_matches_reference(mesh):
    scene, meta, ts, tm = mesh
    img_ref, _ = jax_render(scene, meta, jint.IntegratorConfig(kind="path",
                                                               max_depth=DEPTH),
                            spp=SPP)
    img, _ = render(ts, tm, tint.IntegratorConfig(kind="path", max_depth=DEPTH),
                    spp=SPP, device="cpu")
    img = img.numpy()
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all() and img.mean() > 0
    assert relative_mae(img, np.asarray(img_ref)) < 1e-3


def test_compaction_is_bitwise_exact(monkeypatch):
    """At 32x32, 2 spp (2,048 lanes) the pre-Russian-roulette split of a BVH
    scene packs the survivors of bounce 2 into 1,024 lanes; the packed and
    the full-width waves give the same radiance bit for bit."""
    ts, tm, _ = torch_mesh_scene(32, 32, 2, grid=24, device="cpu")
    pix, samp, _ = megawave_lanes(tm, 0, 2, "cpu")
    rays = camera_rays(ts, tm, pix, samp)[0]
    seen = []
    take = tint._compaction_take

    def recording_take(active, cap):
        out = take(active, cap)
        seen.append((cap, int(out[1])))
        return out

    monkeypatch.setattr(tint, "_compaction_take", recording_take)
    packed = tint.li(ts, tm, tint.IntegratorConfig(max_depth=DEPTH, compact_min=2048),
                     rays, pix, samp)
    assert len(seen) == 1 and seen[0][0] == 1024 and 0 < seen[0][1] <= 1024
    full = tint.li(ts, tm, tint.IntegratorConfig(max_depth=DEPTH, compact=False),
                   rays, pix, samp)
    assert torch.equal(packed, full)
