"""Gradients through the port's render against grail's jax.grad, on the CPU.

- The intersectors' backward (intersect.ClosestHit, both routes): the
  gradients of (t, b1, b2) for verts, o, d, tmin and tmax equal those of
  the reference's custom VJPs (pallas_intersect.brute_intersect_pallas and
  bvh_stream.bvh_stream_intersect, run in Pallas interpret mode) to rtol
  1e-4, atol 1e-5 of the largest entry (a vertex sums the terms of many rays,
  in float32 and in another order). Ray binning keeps the gradients of the
  rays.
- The Cornell box (brute route), kind="path", depth 3, rr_depth=99 (Russian
  roulette off: its weight is detached, so only without it is the per-sample
  estimator smooth and finite differences meaningful), 16x16, 1 spp, a
  spatially weighted mean of the image: the gradients for tex_data.const,
  lights.emit, verts and camera.c2w.m0 equal jax.grad's to rtol 1e-3, atol
  1e-5 of the largest entry, and central differences as tests/test_grad.py
  requires (rtol 2e-2; the pose, whose finite difference also moves
  visibility edges that the detached-sampling gradient leaves out, by sign
  and order). The reference's own gradient for verts and m0 is NaN here: at a
  miss its emission MIS squares the miss sentinel t = 3e37 to infinity, and
  the zero cotangent of the masked lane times that is NaN (ROADMAP C.4). The
  reference is run with that one function given t = 0 on those lanes, which
  changes no value it computes.
- The terrain (mesh_scene, grid=24; 4-wide route via the bridge), 8x8, 1 spp,
  depth 3: the texel gradients of images[0] (bilinear lookups after bounce
  0) and of its MIP pyramid's flat table (EWA on bounce 0) equal jax.grad's
  to rtol 1e-3, atol 2e-3 of the largest entry (a texel's weight is the
  fraction of a texel coordinate up to 6 x 256: XLA contracts that product
  into a multiply-add, which moves the weight by up to 1.2e-4) wherever the
  reference's are finite; the reference's are NaN on some
  entries (a masked lane's zero cotangent times an infinite local slope,
  ROADMAP C.5), the port's are finite everywhere. The vertex gradient, NaN
  in the reference on nearly every entry, is held against the port's own
  brute route on the same scene.
- optimize_albedo recovers the Cornell walls' albedo as the reference's test
  does; and recording gradients changes no rendered value.
"""
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import grail.kernels.bvh_stream as jbs
import grail.kernels.intersect as jisect
import grail.kernels.pallas_intersect as jpi
import grail.shade.lights as jlights
from grail.engine import film as jfilm
from grail.engine.integrator import IntegratorConfig as JaxConfig
from grail.engine.render import render_wave as jax_render_wave
from grail.kernels.bvh_stream import bvh_stream_intersect
from grail.scene.presets import cornell_box as jax_cornell, mesh_scene as jax_mesh
from grail_torch.engine import film as flm
from grail_torch.engine.integrator import IntegratorConfig
from grail_torch.engine.render import render, render_wave
from grail_torch.kernels import intersect as tisect
from grail_torch.kernels.brute_intersect import brute_intersect
from grail_torch.kernels.bvh4 import bvh4_traverse
from grail_torch.scene.bridge import scene_from_numpy
from grail_torch.tools.optimize import optimize_albedo

torch.set_num_threads(2)

CFG = dict(kind="path", max_depth=3, rr_depth=99)
CORNELL_RES, MESH_RES = 16, 8


def _bridged(scene, meta):
    return scene_from_numpy(jax.tree_util.tree_map(np.asarray, scene), meta,
                            device="cpu")


def _weight(xres):
    return np.linspace(0.0, 1.0, xres, dtype=np.float32)[None, :, None]


# ------------------------------------------------------------- intersectors
def _rays(rs, n, lo, hi, eye):
    o = (rs.rand(n, 3) * (np.asarray(hi) - lo) + lo).astype(np.float32)
    o[: n // 4] = eye
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1.0e7, np.float32)
    tmax[n // 2: n // 2 + n // 8] = rs.rand(n // 8).astype(np.float32) * 2.0
    return o, d, np.zeros(n, np.float32), tmax


@pytest.mark.parametrize("route", ["brute", "bvh4"])
def test_closest_hit_backward_matches_reference(route, monkeypatch):
    """ClosestHit's frozen-prim backward against the reference's custom VJP
    of the kernel it stands for, on the same rays and a random cotangent
    (zero on the b1, b2 of misses, where the reference's brute-force
    version reports another triangle's barycentrics)."""
    rs = np.random.RandomState(3)
    if route == "brute":
        scene, meta, _ = jax_cornell(8, 8, 1)
        rays = _rays(rs, 768, [-0.99, 0.01, -0.99], [0.99, 1.99, 0.99], [0, 1, 3.9])
        monkeypatch.setattr(jpi, "_run", functools.partial(jpi._run, interpret=True))

        def ref_closest(verts, *r):
            return jpi.brute_intersect_pallas(
                jpi.pack_tris(dict(scene, verts=verts)), *r)
    else:
        scene, meta, _ = jax_mesh(8, 8, 1, grid=24)
        rays = _rays(rs, 768, [-4.3, -0.5, -4.3], [4.3, 2.5, 4.3], [0, 3.2, 7.5])
        monkeypatch.setitem(os.environ, "GRAIL_PALLAS_INTERPRET", "1")

        def ref_closest(verts, *r):
            return bvh_stream_intersect(scene["bvh"]["stream"],
                                        jpi.pack_tris(dict(scene, verts=verts)), *r)
    ts, _ = _bridged(scene, meta)
    t_ref, prim_ref, _, _ = ref_closest(scene["verts"], *map(jnp.asarray, rays))
    hit = np.asarray(prim_ref) >= 0
    assert 0.2 < hit.mean() < 0.95
    w = rs.randn(3, len(hit)).astype(np.float32)
    w[1:, ~hit] = 0.0

    def ref_loss(verts, o, d, tmin, tmax):
        t, _, b1, b2 = ref_closest(verts, o, d, tmin, tmax)
        return jnp.sum(w[0] * t + w[1] * b1 + w[2] * b2)

    ref = jax.grad(ref_loss, argnums=tuple(range(5)))(
        scene["verts"], *map(jnp.asarray, rays))

    leaves = [ts["verts"].clone()] + [torch.tensor(a) for a in rays]
    for a in leaves:
        a.requires_grad_(True)
    if route == "brute":
        def traverse(*r):
            return brute_intersect(tisect.pack_tris(dict(ts, verts=leaves[0])), *r)
    else:
        def traverse(*r):
            return bvh4_traverse(ts["bvh"]["bvh4_nodes"], ts["bvh"]["bvh4_tris"], *r,
                                 stack=ts["bvh"]["bvh4_stack"])
    t, prim, b1, b2 = tisect.ClosestHit.apply(traverse, leaves[0], ts["tri_idx"],
                                             *leaves[1:])
    assert (prim.numpy() == np.asarray(prim_ref)).mean() >= 0.999
    wt = torch.tensor(w)
    (wt[0] * t + wt[1] * b1 + wt[2] * b2).sum().backward()
    for name, a, r in zip(("verts", "o", "d", "tmin", "tmax"), leaves, ref):
        r = np.asarray(r)
        g = (torch.zeros_like(a) if a.grad is None else a.grad).numpy()
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-5 * np.abs(r).max(),
                                   err_msg=name)
    assert np.abs(leaves[0].grad.numpy()).sum() > 0


def test_binning_keeps_ray_gradients():
    """A wave binned (sorted into coherence buckets and gathered back) has
    the gradients of the same wave traced in lane order."""
    scene, meta, _ = jax_mesh(8, 8, 1, grid=24)
    ts, _ = _bridged(scene, meta)
    o, d, _, tmax = _rays(np.random.RandomState(4), 512, [-4.3, -0.5, -4.3],
                          [4.3, 2.5, 4.3], [0, 3.2, 7.5])
    grads = []
    for sort in (False, True):
        leaves = [torch.tensor(a, requires_grad=True) for a in (o, d)]
        hit = tisect.intersect(ts, *leaves, torch.tensor(tmax), device="cpu", sort=sort)
        ok = hit["prim"] >= 0
        torch.where(ok, hit["t"] + 3.0 * hit["b1"] - hit["b2"], 0.0).sum().backward()
        grads.append([a.grad for a in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b) and bool(a.abs().sum() > 0)


# ------------------------------------------------------------------ Cornell
def _cornell_loss_ref(scene, meta):
    w = _weight(meta.xres)

    def loss(leaves):
        s = dict(scene, verts=leaves["verts"])
        s["tex_data"] = dict(scene["tex_data"], const=leaves["const"])
        s["lights"] = dict(scene["lights"], emit=leaves["emit"])
        s["camera"] = dict(scene["camera"])
        s["camera"]["c2w"] = dict(scene["camera"]["c2w"], m0=leaves["m0"])
        f = jax_render_wave(s, meta, JaxConfig(**CFG),
                            jfilm.new_film(meta.xres, meta.yres), jnp.uint32(0))
        return (jfilm.develop(f) * w).mean()
    return loss


def _cornell_loss(ts, tm, leaves):
    s = dict(ts, verts=leaves["verts"])
    s["tex_data"] = dict(ts["tex_data"], const=leaves["const"])
    s["lights"] = dict(ts["lights"], emit=leaves["emit"])
    s["camera"] = dict(ts["camera"], c2w=dict(ts["camera"]["c2w"], m0=leaves["m0"]))
    f = render_wave(s, tm, IntegratorConfig(**CFG),
                    flm.new_film(tm.xres, tm.yres, "cpu"), 0, device="cpu")
    return (flm.develop(f) * torch.tensor(_weight(tm.xres))).mean()


def _area_light_pdf_dir_at_hits(orig):
    """The reference's area_light_pdf_dir with the miss sentinel replaced by
    t = 0, which its caller discards anyway (ROADMAP C.4)."""
    def pdf(scene, li, p, wi, hit_t, cos_at_light):
        return orig(scene, li, p, wi, jnp.where(hit_t < 1e30, hit_t, 0.0), cos_at_light)
    return pdf


@pytest.fixture(scope="module")
def cornell():
    scene, meta, _ = jax_cornell(CORNELL_RES, CORNELL_RES, 1)
    ts, tm = _bridged(scene, meta)
    names = {"const": ("tex_data", "const"), "emit": ("lights", "emit"),
             "verts": ("verts",), "m0": ("camera", "c2w", "m0")}

    def get(tree, path):
        return functools.reduce(lambda t, k: t[k], path, tree)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlights, "area_light_pdf_dir",
                   _area_light_pdf_dir_at_hits(jlights.area_light_pdf_dir))
        ref_value, ref = jax.value_and_grad(_cornell_loss_ref(scene, meta))(
            {k: get(scene, p) for k, p in names.items()})
    leaves = {k: get(ts, p).clone().requires_grad_(True) for k, p in names.items()}
    value = _cornell_loss(ts, tm, leaves)
    value.backward()
    return {"ts": ts, "tm": tm, "leaves": leaves, "value": float(value),
            "ref_value": float(ref_value),
            "ref": {k: np.asarray(v) for k, v in ref.items()}}


@pytest.mark.parametrize("leaf", ["const", "emit", "verts", "m0"])
def test_cornell_grads_match_reference(cornell, leaf):
    np.testing.assert_allclose(cornell["value"], cornell["ref_value"], rtol=1e-5)
    ref = cornell["ref"][leaf]
    got = cornell["leaves"][leaf].grad.numpy()
    assert np.isfinite(ref).all() and np.isfinite(got).all()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-5 * np.abs(ref).max())


def test_cornell_grads_match_central_differences(cornell):
    ts, tm, leaves = cornell["ts"], cornell["tm"], cornell["leaves"]
    e = 1e-3

    def fd(name, idx):
        out = []
        for sign in (1.0, -1.0):
            moved = {k: v.detach().clone() for k, v in leaves.items()}
            moved[name][idx] += sign * e
            with torch.no_grad():
                out.append(float(_cornell_loss(ts, tm, moved)))
        return (out[0] - out[1]) / (2 * e)

    for name, idx in (("const", (0, 0)), ("emit", (0, 1))):
        np.testing.assert_allclose(fd(name, idx), float(leaves[name].grad[idx]),
                                   rtol=2e-2, err_msg=name)
    g, f = float(leaves["m0"].grad[0, 3]), fd("m0", (0, 3))
    assert f * g > 0 and abs(f) < 10 * abs(g) + 1e-4


# --------------------------------------------------------------------- mesh
@pytest.fixture(scope="module")
def mesh():
    """The port's terrain and the reference's texel gradients through its
    differentiable BVH route: the stream kernels (Pallas, here in interpret
    mode) with their custom VJP; their CPU route, a jnp while loop, has no
    reverse mode. Its any hit, which has no gradient by design, gets its rays
    with the gradient stopped: the Pallas call has no JVP (ROADMAP C.5)."""
    scene, meta, _ = jax_mesh(MESH_RES, MESH_RES, 1, grid=24)
    ts, tm = _bridged(scene, meta)
    occluded = jbs.bvh_stream_intersect_p

    def ref_loss(img, flat):
        s = dict(scene, images=(img,) + tuple(scene["images"][1:]))
        s["mipmaps"] = (dict(scene["mipmaps"][0], flat=flat),) + tuple(scene["mipmaps"][1:])
        f = jax_render_wave(s, meta, JaxConfig(**CFG),
                            jfilm.new_film(meta.xres, meta.yres), jnp.uint32(0))
        return jfilm.develop(f).mean()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jisect, "_pallas_ok", lambda: True)
        mp.setitem(os.environ, "GRAIL_PALLAS_INTERPRET", "1")
        mp.setattr(jbs, "bvh_stream_intersect_p", lambda table, *rays, **kw: occluded(
            table, *map(jax.lax.stop_gradient, rays), **kw))
        ref = jax.grad(ref_loss, argnums=(0, 1))(scene["images"][0],
                                                scene["mipmaps"][0]["flat"])
    return ts, tm, {"img": np.asarray(ref[0]), "flat": np.asarray(ref[1])}


def _mesh_grads(ts, tm, **kw):
    leaves = {"img": ts["images"][0].clone(), "flat": ts["mipmaps"][0]["flat"].clone(),
              "verts": ts["verts"].clone()}
    for v in leaves.values():
        v.requires_grad_(True)
    s = dict(ts, verts=leaves["verts"], images=(leaves["img"],) + ts["images"][1:], **kw)
    s["mipmaps"] = (dict(ts["mipmaps"][0], flat=leaves["flat"]),) + ts["mipmaps"][1:]
    f = render_wave(s, tm, IntegratorConfig(**CFG),
                    flm.new_film(tm.xres, tm.yres, "cpu"), 0, device="cpu")
    flm.develop(f).mean().backward()
    return {k: v.grad.numpy() for k, v in leaves.items()}


@pytest.mark.parametrize("leaf", ["img", "flat"])
def test_mesh_texel_grads_match_reference(mesh, leaf):
    ts, tm, ref = mesh
    got = _mesh_grads(ts, tm)[leaf]
    ref = ref[leaf]
    finite = np.isfinite(ref)
    assert np.isfinite(got).all() and (ref[finite] != 0).sum() > 100
    np.testing.assert_allclose(got[finite], ref[finite], rtol=1e-3,
                               atol=2e-3 * np.abs(ref[finite]).max())


def test_mesh_vertex_grads_match_brute_route(mesh):
    """The 4-wide route's vertex gradient against the brute-force route's on
    the same scene (the same hits, the same closed-form backward)."""
    ts, tm, _ = mesh
    bvh4 = _mesh_grads(ts, tm)["verts"]
    brute = _mesh_grads(ts, tm, bvh=None)["verts"]
    assert np.isfinite(bvh4).all() and (bvh4 != 0).sum() > 100
    np.testing.assert_allclose(bvh4, brute, rtol=1e-4, atol=1e-6 * np.abs(brute).max())


# ------------------------------------------------------------ optimize, serve
def test_optimize_albedo_recovers_albedo():
    """tools/optimize.py's demo: the white walls' albedo from a target image,
    as the reference's test_inverse_rendering_recovers_albedo (with the path
    integrator at depth 1)."""
    scene, meta, _ = jax_cornell(16, 16, 1)
    ts, tm = _bridged(scene, meta)
    cfg = IntegratorConfig(kind="path", max_depth=1)
    target, _ = render(ts, tm, cfg, spp=1, device="cpu")
    rec, losses = optimize_albedo(ts, tm, cfg, target, steps=25, lr=0.1, spp=1,
                                  param_rows=(0,), device="cpu")
    true = ts["tex_data"]["const"].numpy()[0]
    assert losses[-1] < 0.3 * losses[0]
    assert np.abs(true - rec.numpy()[0]).mean() < 0.5 * np.abs(true - 0.5).mean()
    np.testing.assert_array_equal(rec.numpy()[1:], ts["tex_data"]["const"].numpy()[1:])


def test_recording_gradients_changes_no_value(cornell):
    """The serving render (no_grad), a wave with gradients on and no leaf
    that requires them, and a wave with a leaf that does: the same image bit
    for bit."""
    ts, tm = cornell["ts"], cornell["tm"]
    cfg = IntegratorConfig(**CFG)
    img, _ = render(ts, tm, cfg, spp=1, device="cpu")
    plain = flm.develop(render_wave(ts, tm, cfg, flm.new_film(tm.xres, tm.yres, "cpu"),
                                    0, device="cpu"))
    const = ts["tex_data"]["const"].clone().requires_grad_(True)
    s = dict(ts, tex_data=dict(ts["tex_data"], const=const))
    graded = flm.develop(render_wave(s, tm, cfg, flm.new_film(tm.xres, tm.yres, "cpu"),
                                     0, device="cpu"))
    assert not img.requires_grad and not plain.requires_grad and graded.requires_grad
    assert torch.equal(img, plain) and torch.equal(img, graded.detach())
