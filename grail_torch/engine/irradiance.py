"""Irradiance caching (port of grail/engine/irradiance.py; pbrt
src/integrators/irradiancecache.cpp) in the reference's two phases.

pbrt fills its cache lazily, on a miss at a shade point; the reference (and
the port) seed it once a render instead: the camera's hits on a coarse
ic_grid[0] x ic_grid[1] pixel grid, each gathering ic_nsamples
cosine-sampled rays whose hits add their emission and one light's direct
lighting (the depth-1 path of pbrt's gather), giving each entry its
irradiance E and the harmonic mean of its gather distances. Every wave of
the preprocess (the seed rays, the gathers, their shadow rays and BSDF
branches) is an "ic_preprocess" wave. Li interpolates over every entry with
pbrt's weight 1/(|p - p_i|/maxDist_i + sqrt((1 - n.n_i)/(1 - cos 10deg))),
cut at 1/maxerror, as a dense (lanes, entries) contraction in chunks of
LANE_CHUNK lanes (each lane's sums are over its own entries, so the chunks
do not change them); where no entry passes, the nearest valid one's E.
"""
from __future__ import annotations

import math

import torch

from .. import telemetry
from ..core import montecarlo as mc
from ..core import rng as rngmod
from ..core.vecmath import coordinate_system, dot
from ..shade import bsdf as bx
from ..shade import geometry as geom
from ..shade import lights as lt
from . import camera as cam
from . import integrator as integ

_DIM = 8000
LANE_CHUNK = 65536    # lanes a contraction step
_ROLES = ("ic_preprocess", "ic_preprocess")


def _gather_radiance(scene, meta, p, n_normal, eps, pix, samp, dim):
    """The radiance along one cosine-sampled gather ray about n_normal:
    emission and direct lighting at its hit, the environment where it
    escapes. Returns (L, hit distance or 1e7)."""
    u1, u2 = rngmod.sample_2d(meta.sampler, pix, samp, dim)
    wl = mc.cosine_sample_hemisphere(u1, u2)
    t1, t2 = coordinate_system(n_normal)
    w = wl[..., 0:1] * t1 + wl[..., 1:2] * t2 + wl[..., 2:3] * n_normal
    n = p.shape[0]
    hit = integ._trace(scene, p + w * eps[..., None], w, p.new_full((n,), 1.0e7),
                       role=_ROLES[0])
    active = hit["prim"] >= 0
    sg, lobes, wo_local = integ._shade_context(scene, meta, hit, p, w)
    L = p.new_zeros((n, 3))
    if lt.AREA in meta.light_types:
        L = L + lt.area_light_emitted(scene, sg, -w)
    if meta.n_lights > 0:
        # the reference picks the light at bounce 0's slot of every gather
        lidx, pmf = integ._pick_light(scene, meta, integ.IntegratorConfig(kind="direct"),
                                      pix, samp, 0)
        L = L + integ.estimate_direct(
            scene, meta, sg, lobes, wo_local, lidx, pmf,
            rngmod.sample_2d(meta.sampler, pix, samp, dim + 1),
            rngmod.sample_1d(meta.sampler, pix, samp, dim + 3),
            rngmod.sample_1d(meta.sampler, pix, samp, dim + 4),
            rngmod.sample_2d(meta.sampler, pix, samp, dim + 5), active, roles=_ROLES)
    L = torch.where(active[..., None], L, lt.escaped_radiance(scene, w, meta.light_types))
    return L, torch.where(active, hit["t"], 1.0e7)


@telemetry.spanned("ic_preprocess")
def irradiance_preprocess(scene, meta, cfg):
    """The cache: {p, n, E, max_dist, valid} of the ic_grid[0] x ic_grid[1]
    seed entries (ic_grid[2] is read by nothing, as in the reference)."""
    dev = scene["verts"].device
    gx, gy, _ = cfg.ic_grid
    n_entries = gx * gy
    xs = ((torch.arange(gx, device=dev) + 0.5) / gx * meta.xres).to(torch.int32)
    ys = ((torch.arange(gy, device=dev) + 0.5) / gy * meta.yres).to(torch.int32)
    px, py = (a.reshape(-1) for a in torch.meshgrid(xs, ys, indexing="ij"))
    pixid = (py.to(torch.int64) * meta.xres + px.to(torch.int64))
    samp = torch.zeros(n_entries, dtype=torch.int64, device=dev)
    half = torch.full((n_entries,), 0.5, dtype=torch.float32, device=dev)
    rays = cam.generate_rays(scene["camera"], px, py, half, half, half, half, half * 0.0,
                             meta.cam_kind)
    hit = integ._trace(scene, rays["o"], rays["d"], half.new_full((n_entries,), 1.0e7),
                       role=_ROLES[0])
    sg = geom.shading_geometry(scene, hit, rays["o"], rays["d"])
    nrm = torch.where((dot(sg["ns"], -rays["d"]) < 0.0)[..., None], -sg["ns"], sg["ns"])
    p, eps = sg["p"], sg["ray_eps"]
    E = p.new_zeros((n_entries, 3))
    inv_d = p.new_zeros(n_entries)
    ns = cfg.ic_nsamples
    for s in range(ns):
        L, dist = _gather_radiance(scene, meta, p, nrm, eps, pixid, samp, _DIM + 8 * s)
        E = E + (math.pi / ns) * L
        inv_d = inv_d + 1.0 / torch.clamp_min(dist, 1e-4)
    max_dist = ns / torch.clamp_min(inv_d, 1e-9)        # the harmonic mean distance
    return {"p": p, "n": nrm, "E": E, "max_dist": torch.clamp(max_dist, 1e-3, 1e6),
            "valid": hit["prim"] >= 0}


def _interpolate_chunk(aux, p, n_normal, max_error):
    diff = p[:, None, :] - aux["p"][None]
    perr = torch.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2) \
        / aux["max_dist"][None]                                 # (N,P)
    nerr = torch.sqrt(torch.clamp_min(
        (1.0 - n_normal @ aux["n"].T) / (1.0 - math.cos(0.1745)), 0.0))
    err = torch.clamp_min(perr, 1e-6) + nerr
    w = torch.where(aux["valid"][None] & (err < 1.0 / max_error), 1.0 / err, 0.0)
    wsum = torch.sum(w, dim=1, keepdim=True)
    nearest = torch.argmin(torch.where(aux["valid"][None], perr, math.inf), dim=1)
    E = (w @ aux["E"]) / torch.clamp_min(wsum, 1e-12)
    return torch.where(wsum > 0.0, E, aux["E"][nearest])


@telemetry.spanned("ic_interpolate")
def _interpolate(aux, p, n_normal, max_error):
    """pbrt IrradianceCache::InterpolateE's weight and cutoff, dense over the
    entry table, LANE_CHUNK lanes at a time: E (N,3)."""
    out = [_interpolate_chunk(aux, p[i:i + LANE_CHUNK], n_normal[i:i + LANE_CHUNK],
                              max_error) for i in range(0, p.shape[0], LANE_CHUNK)]
    return torch.cat(out) if out else p.new_zeros((0, 3))


def irradiancecache_li(scene, meta, cfg, rays, pix, samp, aux):
    """IrradianceCacheIntegrator::Li: rho/pi times the interpolated
    irradiance, emission and direct lighting; escaped rays take the
    environment. Returns L (N,3) times the ray weight."""
    o, d = rays["o"], rays["d"]
    n = o.shape[0]
    hit = integ._trace(scene, o, d, o.new_full((n,), 1.0e7), role="camera")
    active = hit["prim"] >= 0
    sg, lobes, wo_local = integ._shade_context(scene, meta, hit, o, d)
    nf = torch.where((dot(sg["ns"], -d) < 0.0)[..., None], -sg["ns"], sg["ns"])
    L = bx.diffuse_albedo(lobes) / math.pi * _interpolate(aux, sg["p"], nf, cfg.ic_maxerror)
    if lt.AREA in meta.light_types:
        L = L + lt.area_light_emitted(scene, sg, -d)
    if meta.n_lights > 0:
        lidx, pmf = integ._pick_light(scene, meta, cfg, pix, samp, 0)
        L = L + integ.estimate_direct(
            scene, meta, sg, lobes, wo_local, lidx, pmf,
            rngmod.sample_2d(meta.sampler, pix, samp, _DIM + 7000),
            rngmod.sample_1d(meta.sampler, pix, samp, _DIM + 7002),
            rngmod.sample_1d(meta.sampler, pix, samp, _DIM + 7003),
            rngmod.sample_2d(meta.sampler, pix, samp, _DIM + 7004), active)
    L = torch.where(active[..., None], L, lt.escaped_radiance(scene, d, meta.light_types))
    return L * rays["weight"][..., None]
