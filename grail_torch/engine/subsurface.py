"""Dipole BSSRDF subsurface scattering (port of grail/engine/subsurface.py;
pbrt src/integrators/dipolesubsurface.cpp and src/renderers/
surfacepoints.cpp), as the reference reshapes it for a wavefront.

The preprocess samples the surface uniformly in area (each point stands for
A_total / P; pbrt's Poisson repulsion walk is not run) and bakes each point's
direct irradiance in one vectorized pass, whose shadow rays are the
integrator's "irradiance" waves. Li then sums Mo(p) = sum_i Rd(|p - p_i|^2)
E_i A_i over every point, densely: pbrt's octree and its error cutoff
(sss_maxerror, read by nothing) are replaced by the full contraction. The
contraction runs in chunks of LANE_CHUNK lanes and POINT_CHUNK points, the
points in the reference's chunks and order, so each lane's sum is the
reference's while the (lanes, points, 3) intermediate stays bounded. Like
the reference, the camera wave is a plain closest hit (binned at a full
megawave), and the irradiance rays skip alpha cutouts and carry no time.

The dipole's diffusion profile Rd and the Fresnel moments follow
dipolesubsurface.cpp (Jensen et al. 2001); subsurface_from_diffuse inverts
the dipole's albedo on the host (kdsubsurface.cpp).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import telemetry
from ..core import rng as rngmod
from ..core.vecmath import dot
from ..shade import bsdf as bx
from ..shade import lights as lt
from . import integrator as integ

_DIM = 7000          # the sampler dimensions of the preprocess and of Li
POINT_CHUNK = 512    # surface points a contraction step (the reference's)
LANE_CHUNK = 65536   # lanes a contraction step


def fresnel_diffuse_reflectance(eta):
    """Fdr(eta) (pbrt FresnelDiffuseReflectance)."""
    if eta >= 1.0:
        return -1.4399 / (eta * eta) + 0.7099 / eta + 0.6681 + 0.0636 * eta
    return -0.4399 + 0.7099 / eta - 0.3319 / (eta * eta) + 0.0636 / (eta * eta * eta)


def rd_integral(alphap, A):
    """The dipole's total diffuse albedo for reduced albedo alphap (pbrt
    volume.cpp RdIntegral); numpy."""
    s = np.sqrt(3.0 * (1.0 - alphap))
    return alphap / 2.0 * (1.0 + np.exp(-4.0 / 3.0 * A * s)) * np.exp(-s)


def subsurface_from_diffuse(kd, meanfreepath, eta):
    """(sigma_a, sigma_prime_s) for diffuse reflectance kd and a mean free
    path: the dipole's albedo inverted by bisection per channel (pbrt
    volume.cpp SubsurfaceFromDiffuse, RdToAlphap). Host-side."""
    kd = np.asarray(kd, np.float64)
    fdr = fresnel_diffuse_reflectance(eta)
    A = (1.0 + fdr) / (1.0 - fdr)
    lo = np.zeros_like(kd)
    hi = np.ones_like(kd)
    for _ in range(32):
        mid = 0.5 * (lo + hi)
        below = rd_integral(mid, A) < kd
        lo = np.where(below, mid, lo)
        hi = np.where(below, hi, mid)
    alphap = 0.5 * (lo + hi)
    sigma_tr = 1.0 / max(float(meanfreepath), 1e-9)
    sigmap_t = sigma_tr / np.sqrt(3.0 * np.maximum(1.0 - alphap, 1e-9))
    sigmap_s = alphap * sigmap_t
    sigma_a = sigmap_t - sigmap_s
    return tuple(float(x) for x in sigma_a), tuple(float(x) for x in sigmap_s)


def dipole_rd(d2, sigma_a, sigma_prime_s, eta):
    """Jensen's dipole diffusion profile Rd(d^2) per channel: d2 (...,1)
    squared distances, sigma_* (3,) tensors."""
    sigmap_t = sigma_a + sigma_prime_s
    alphap = sigma_prime_s / torch.clamp_min(sigmap_t, 1e-9)
    sigma_tr = torch.sqrt(3.0 * sigma_a * sigmap_t)
    fdr = fresnel_diffuse_reflectance(eta)
    A = (1.0 + fdr) / (1.0 - fdr)
    zr = 1.0 / torch.clamp_min(sigmap_t, 1e-9)
    zv = zr * (1.0 + 4.0 / 3.0 * A)
    dr = torch.sqrt(d2 + zr * zr)
    dv = torch.sqrt(d2 + zv * zv)
    return (alphap / (4.0 * math.pi)
            * (zr * (sigma_tr * dr + 1.0) * torch.exp(-sigma_tr * dr) / (dr ** 3)
               + zv * (sigma_tr * dv + 1.0) * torch.exp(-sigma_tr * dv) / (dv ** 3)))


def sample_surface_points(scene, n_points, seed=0):
    """surfacepoints.cpp's point set, as the reference makes it: triangles
    picked by area, uniform barycentrics, from np.random.default_rng(seed)
    on the host (so the points are the reference's bit for bit). Returns
    (p, n, area) on the scene's device; each point stands for the total
    area over n_points."""
    verts = scene["verts"].detach().cpu().numpy()
    tris = scene["tri_idx"].cpu().numpy()
    v0 = verts[tris[:, 0]]
    e1 = verts[tris[:, 1]] - v0
    e2 = verts[tris[:, 2]] - v0
    cr = np.cross(e1, e2)
    areas = 0.5 * np.linalg.norm(cr, axis=1)
    total = float(areas.sum())
    cdf = np.cumsum(areas) / max(total, 1e-20)
    rng = np.random.default_rng(seed)
    ti = np.minimum(np.searchsorted(cdf, rng.random(n_points)), len(areas) - 1)
    u1 = np.sqrt(rng.random(n_points))
    u2 = rng.random(n_points)
    b0 = 1.0 - u1
    b1 = u1 * (1.0 - u2)
    p = (b0[:, None] * v0[ti] + b1[:, None] * (v0[ti] + e1[ti])
         + (1.0 - b0 - b1)[:, None] * (v0[ti] + e2[ti]))
    n = cr[ti] / np.maximum(np.linalg.norm(cr[ti], axis=1, keepdims=True), 1e-20)
    dev = scene["verts"].device
    return (torch.tensor(p.astype(np.float32), device=dev),
            torch.tensor(n.astype(np.float32), device=dev),
            torch.full((n_points,), total / n_points, dtype=torch.float32, device=dev))


def irradiance_at_points(scene, meta, p, n, n_samples=4):
    """The direct irradiance E at each surface point (dipolesubsurface.cpp's
    IrradiancePointTask): n_samples samples of every light, each shadow ray
    an "irradiance" wave."""
    npts = p.shape[0]
    pix = torch.arange(npts, dtype=torch.int64, device=p.device)
    samp = torch.zeros_like(pix)
    E = p.new_zeros((npts, 3))
    for lrow in range(meta.n_lights):
        lidx = torch.full((npts,), lrow, dtype=torch.int32, device=p.device)
        for s in range(n_samples):
            d0 = _DIM + (lrow * n_samples + s) * 3
            u1, u2 = rngmod.sample_2d(meta.sampler, pix, samp, d0)
            u3 = rngmod.sample_1d(meta.sampler, pix, samp, d0 + 2)
            ls = lt.sample_li(scene, lidx, p, u1, u2, u3, meta.light_types,
                              meta.light_image_rows)
            cosw = dot(ls["wi"], n)
            ok = (ls["pdf"] > 0.0) & (cosw > 0.0)
            occ = integ._trace(scene, p + ls["wi"] * 1e-3, ls["wi"],
                               torch.where(ok, ls["dist"] - 2e-3, 0.0), any_hit=True,
                               role="irradiance")
            w = torch.where(ok & ~occ,
                            cosw / (torch.clamp_min(ls["pdf"], 1e-12) * n_samples), 0.0)
            E = E + ls["radiance"] * w[..., None]
    return E


@telemetry.spanned("dipole_preprocess")
def dipole_preprocess(scene, meta, cfg):
    """The point cloud and its irradiance, once a render."""
    p, n, area = sample_surface_points(scene, cfg.sss_npoints)
    return {"p": p, "n": n, "area": area, "E": irradiance_at_points(scene, meta, p, n)}


@telemetry.spanned("dipole_contraction")
def _mo(p, aux, sigma_a, sigma_ps, eta):
    """Mo = sum_i Rd(|p - p_i|^2) E_i A_i for lanes p (N,3), in chunks of
    lanes and of points (the points in the reference's order)."""
    n_pts = aux["p"].shape[0]
    out = []
    for l0 in range(0, p.shape[0], LANE_CHUNK):
        pl = p[l0:l0 + LANE_CHUNK]
        Mo = pl.new_zeros((pl.shape[0], 3))
        for s in range(0, n_pts, POINT_CHUNK):
            pp = aux["p"][s:s + POINT_CHUNK]
            EA = aux["E"][s:s + POINT_CHUNK] * aux["area"][s:s + POINT_CHUNK][:, None]
            d2 = torch.sum((pl[:, None, :] - pp[None, :, :]) ** 2, dim=-1)
            rd = dipole_rd(d2[..., None], sigma_a, sigma_ps, eta)
            Mo = Mo + torch.sum(rd * EA[None], dim=1)
        out.append(Mo)
    return torch.cat(out) if out else p.new_zeros((0, 3))


def dipole_li(scene, meta, cfg, rays, pix, samp, aux):
    """DipoleSubsurfaceIntegrator::Li: Lo = Ft / pi (1 - Fdr) Mo at the
    camera hit, plus direct lighting with MIS; escaped rays take the
    environment. Returns L (N,3) times the ray weight."""
    o, d = rays["o"], rays["d"]
    n_rays = o.shape[0]
    hit = integ._trace(scene, o, d, o.new_full((n_rays,), integ.BIG), role="camera")
    active = hit["prim"] >= 0
    sg, lobes, wo_local = integ._shade_context(scene, meta, hit, o, d)
    eta = float(cfg.sss_eta)
    Mo = _mo(sg["p"], aux, o.new_tensor(cfg.sss_sigma_a), o.new_tensor(cfg.sss_sigma_s),
             eta)
    cos_o = torch.abs(bx.cos_theta(wo_local))
    Ft = 1.0 - bx.fr_dielectric(cos_o, torch.ones_like(cos_o), torch.full_like(cos_o, eta))
    fdt = 1.0 - fresnel_diffuse_reflectance(eta)
    L_sss = (Ft / math.pi)[..., None] * fdt * Mo

    Ld = torch.zeros_like(L_sss)
    if meta.n_lights > 0:
        lidx, pmf = integ._pick_light(scene, meta, cfg, pix, samp, 0)
        Ld = integ.estimate_direct(
            scene, meta, sg, lobes, wo_local, lidx, pmf,
            rngmod.sample_2d(meta.sampler, pix, samp, _DIM + 900),
            rngmod.sample_1d(meta.sampler, pix, samp, _DIM + 902),
            rngmod.sample_1d(meta.sampler, pix, samp, _DIM + 903),
            rngmod.sample_2d(meta.sampler, pix, samp, _DIM + 904), active)
    L = torch.where(active[..., None], L_sss + Ld,
                    lt.escaped_radiance(scene, d, meta.light_types))
    return L * rays["weight"][..., None]
