"""Device stages of the port against their grail counterparts on the same
inputs (made with numpy from a seed), to rtol 1e-5: camera rays, shading
geometry and lobe gather, area-light sampling, the LAMBERT lobe stack, and
film accumulation + develop. float32 arithmetic in another operation order
(XLA fuses and contracts some multiply-adds, PyTorch does not) differs in the
last bits, hence a tolerance rather than bitwise equality."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from grail.scene.presets import cornell_box
from grail.engine import camera as jcam, film as jfilm
from grail.kernels.intersect import intersect_brute
from grail.shade import bsdf as jbsdf, geometry as jgeom, lights as jlights
from grail.shade import materials as jmtl
from grail.shade.textures import eval_textures as jeval_textures
from grail_torch.engine import camera as tcam, film as tfilm
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.shade import bsdf as tbsdf, geometry as tgeom, lights as tlights
from grail_torch.shade import materials as tmtl
from grail_torch.shade.textures import eval_textures as teval_textures

torch.set_num_threads(2)

N = 2048
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def cornell():
    scene, meta, _ = cornell_box(16, 16, 4)
    ts, tm = scene_from_numpy(jax.tree_util.tree_map(np.asarray, scene), meta,
                              device="cpu")
    return scene, meta, ts, tm


def _close(ref, got, what):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, what
    if ref.dtype == np.bool_ or np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got, ref, err_msg=what)
    else:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=what)


def _unit(rs, n):
    v = rs.randn(n, 3).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _camera(rs, scene, meta, ts, tm):
    px = rs.randint(0, meta.xres, N).astype(np.int32)
    py = rs.randint(0, meta.yres, N).astype(np.int32)
    u = rs.rand(5, N).astype(np.float32)
    ref = jcam.generate_rays(scene["camera"], jnp.asarray(px), jnp.asarray(py),
                             *map(jnp.asarray, u), meta.cam_kind)
    got = tcam.generate_rays(ts["camera"], torch.tensor(px), torch.tensor(py),
                             *map(torch.tensor, u), tm.cam_kind)
    for k in ("o", "d", "time", "weight"):
        _close(ref[k], got[k], k)


def _shading(rs, scene, meta, ts, tm):
    o = (rs.rand(N, 3) * 1.9 + [-0.95, 0.05, -0.95]).astype(np.float32)
    d = _unit(rs, N)
    hit = intersect_brute(scene, jnp.asarray(o), jnp.asarray(d),
                          jnp.full((N,), 1e7, jnp.float32))
    sg = jgeom.shading_geometry(scene, hit, jnp.asarray(o), jnp.asarray(d))
    hit_t = {k: torch.tensor(np.asarray(v)) for k, v in hit.items()}
    got = tgeom.shading_geometry(ts, hit_t, torch.tensor(o), torch.tensor(d))
    assert sg.keys() == got.keys()
    for k in sg:
        _close(sg[k], got[k], k)
    _close(jgeom.hit_geometric(scene, hit)["ng"],
           tgeom.hit_geometric(ts, hit_t)["ng"], "hit_geometric ng")
    lobes = jmtl.gather_lobes(scene, sg, jeval_textures(
        meta.tex_specs, scene["tex_data"], sg))
    got_lobes = tmtl.gather_lobes(ts, got, teval_textures(
        tm.tex_specs, ts["tex_data"], got))
    for k in lobes:
        _close(lobes[k], got_lobes[k], "lobes " + k)
    w = _unit(rs, N)
    _close(jgeom.world_to_local(sg, jnp.asarray(w)),
           tgeom.world_to_local(got, torch.tensor(w)), "world_to_local")
    _close(jgeom.local_to_world(sg, jnp.asarray(w)),
           tgeom.local_to_world(got, torch.tensor(w)), "local_to_world")


def _sample_li(rs, scene, meta, ts, tm):
    p = (rs.rand(N, 3) * 1.9 + [-0.95, 0.05, -0.95]).astype(np.float32)
    u = rs.rand(3, N).astype(np.float32)
    li = np.zeros(N, np.int32)
    ref = jlights.sample_li(scene, jnp.asarray(li), jnp.asarray(p),
                            *map(jnp.asarray, u), meta.light_types)
    got = tlights.sample_li(ts, torch.tensor(li), torch.tensor(p),
                            *map(torch.tensor, u), tm.light_types)
    for k in ("wi", "radiance", "pdf", "dist", "delta"):
        _close(ref[k], got[k], k)
    # emission and the BSDF-branch pdf at light hits
    sg = {"light": np.where(rs.rand(N) < 0.5, 0, -1).astype(np.int32),
          "ng": _unit(rs, N)}
    wo = _unit(rs, N)
    _close(jlights.area_light_emitted(scene, {k: jnp.asarray(v) for k, v in sg.items()},
                                      jnp.asarray(wo)),
           tlights.area_light_emitted(ts, {k: torch.tensor(v) for k, v in sg.items()},
                                      torch.tensor(wo)), "emitted")
    t_hit = rs.rand(N).astype(np.float32) * 3
    cos_at = rs.rand(N).astype(np.float32) * 2 - 1
    _close(jlights.area_light_pdf_dir(scene, jnp.asarray(li), None, None,
                                      jnp.asarray(t_hit), jnp.asarray(cos_at)),
           tlights.area_light_pdf_dir(ts, torch.tensor(li), None, None,
                                      torch.tensor(t_hit), torch.tensor(cos_at)),
           "pdf_dir")


def _bsdf(rs, scene, meta, ts, tm):
    """A two-slot stack with LAMBERT / NONE slots, so the matching mask and
    the component pick both vary per lane."""
    types = rs.choice([jbsdf.NONE, jbsdf.LAMBERT], size=(N, 2)).astype(np.int32)
    types[:16] = jbsdf.NONE
    lobes = {"type": types, "fr": np.zeros((N, 2), np.int32),
             "R": rs.rand(N, 2, 3).astype(np.float32),
             "S1": np.zeros((N, 2, 3), np.float32),
             "S2": np.zeros((N, 2, 3), np.float32),
             "f0": np.zeros((N, 2), np.float32), "f1": np.zeros((N, 2), np.float32),
             "f2": np.zeros((N, 2), np.float32)}
    wo, wi = _unit(rs, N), _unit(rs, N)
    u = rs.rand(3, N).astype(np.float32)
    present = (jbsdf.LAMBERT,)
    jl = {k: jnp.asarray(v) for k, v in lobes.items()}
    tl = {k: torch.tensor(v) for k, v in lobes.items()}
    ref = jbsdf.bsdf_sample(jl, jnp.asarray(wo), *map(jnp.asarray, u), present)
    got = tbsdf.bsdf_sample(tl, torch.tensor(wo), *map(torch.tensor, u), present)
    for k in ("wi", "f", "pdf", "specular", "valid"):
        _close(ref[k], got[k], "sample " + k)
    _close(jbsdf.bsdf_f(jl, jnp.asarray(wo), jnp.asarray(wi), present),
           tbsdf.bsdf_f(tl, torch.tensor(wo), torch.tensor(wi), present), "f")
    _close(jbsdf.bsdf_pdf(jl, jnp.asarray(wo), jnp.asarray(wi), present),
           tbsdf.bsdf_pdf(tl, torch.tensor(wo), torch.tensor(wi), present), "pdf")


def _film(rs, scene, meta, ts, tm):
    """Two sample-major waves over a 16x16 grid in tile order; some samples
    sit exactly on a pixel border (u = 0), which the box filter's inclusive
    extent also hands to the neighbour pixel."""
    xres = yres = 16
    chunk = 2
    lane = np.arange(xres * yres)
    pxt, pyt = jfilm.lane_pixel(jnp.asarray(lane, jnp.uint32), xres)
    px = np.tile(np.asarray(pxt), chunk).astype(np.float32)
    py = np.tile(np.asarray(pyt), chunk).astype(np.float32)
    u = rs.rand(2, px.size).astype(np.float32)
    u[:, :40] = 0.0
    sx, sy = px + u[0], py + u[1]
    L = rs.rand(px.size, 3).astype(np.float32)
    ref = jfilm.add_samples_grid(jfilm.new_film(xres, yres), meta.filter,
                                 jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(L),
                                 chunk, tiled=True)
    got = tfilm.add_samples_grid(tfilm.new_film(xres, yres, "cpu"), tm.filter,
                                 torch.tensor(sx), torch.tensor(sy), torch.tensor(L),
                                 chunk, tiled=True)
    for k in ("rgb", "weight", "splat"):
        _close(ref[k], got[k], k)
    assert float(got["weight"].max()) > chunk          # border samples spill
    _close(jfilm.develop(ref), tfilm.develop(got), "develop")


_STAGES = {"camera": _camera, "shading": _shading, "sample_li": _sample_li,
           "bsdf": _bsdf, "film": _film}


@pytest.mark.parametrize("stage", sorted(_STAGES))
def test_stage_matches_reference(stage, cornell):
    _STAGES[stage](np.random.RandomState(sorted(_STAGES).index(stage)), *cornell)
