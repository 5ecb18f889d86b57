"""Precomputed radiance transfer (port of grail/engine/prt.py; pbrt
src/integrators/diffuseprt.cpp, glossyprt.cpp, useprobes.cpp and
src/renderers/createprobes.cpp) over the spherical harmonics of core/sh.py.

Each projection is a static loop over (light x sample), with
counter-based draws, over the whole batch of points. The preprocess of
diffuseprt and glossyprt projects the direct radiance incident at the
centre of the scene's bound, without visibility (the distant-lighting
assumption), and windows it (SHReduceRinging). diffuseprt's Li projects
the visibility-masked cosine transfer at each camera hit (prt_nsamples
"prt_transfer" waves, any hit) and contracts it with that expansion.
glossyprt's projects the transferred radiance in the world frame and, as
the reference does in place of pbrt's rotated transfer matrix, evaluates
the Phong-convolved expansion at the mirror direction (exact for the
radially symmetric lobe), with the BRDF from the integrator's Kd, Ks and
roughness. Radiance probes: bake_probes projects the incident direct
radiance at the cell centres of a grid over the scene's bound (each light
sample's shadow ray a "probe_bake" wave); useprobes_li interpolates the
coefficients trilinearly at the camera hit, convolves them with the cosine
and shades the diffuse reflectance. write_probes and read_probes keep the
reference's text format, byte for byte.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import telemetry
from ..core import montecarlo as mc
from ..core import rng as rngmod
from ..core import sh
from ..core.vecmath import dot, normalize
from ..shade import bsdf as bx
from ..shade import lights as lt
from . import integrator as integ

_DIM_BASE = 5000     # the sampler dimensions of the projections
_GLOSSY_DIM = _DIM_BASE + 100000
_TRANSFER_DIM = _DIM_BASE + 50000


def project_incident_direct(scene, meta, p, eps, lmax, n_samples, pix, samp,
                            dim_base=_DIM_BASE, with_visibility=True):
    """SHProjectIncidentDirectRadiance: the direct radiance incident at p
    (N,3), projected by sampling every light n_samples times; with
    visibility each sample traces a "probe_bake" shadow wave. Returns c
    (N, terms, 3)."""
    n = p.shape[0]
    c = p.new_zeros((n, sh.sh_terms(lmax), 3))
    for lrow in range(meta.n_lights):
        lidx = torch.full((n,), lrow, dtype=torch.int32, device=p.device)
        for s in range(n_samples):
            d0 = dim_base + (lrow * n_samples + s) * 3
            u1, u2 = rngmod.sample_2d(meta.sampler, pix, samp, d0)
            u3 = rngmod.sample_1d(meta.sampler, pix, samp, d0 + 2)
            ls = lt.sample_li(scene, lidx, p, u1, u2, u3, meta.light_types,
                              meta.light_image_rows)
            ok = (ls["pdf"] > 0.0) & torch.any(ls["radiance"] > 0.0, dim=-1)
            if with_visibility:
                occ = integ._trace(scene, p + ls["wi"] * eps[..., None], ls["wi"],
                                   torch.where(ok, ls["dist"] - 2.0 * eps, 0.0),
                                   any_hit=True, role="probe_bake")
                ok = ok & ~occ
            w = torch.where(ok, 1.0 / (torch.clamp_min(ls["pdf"], 1e-12) * n_samples), 0.0)
            Y = sh.sh_evaluate(ls["wi"], lmax)
            c = c + Y[..., None] * (ls["radiance"] * w[..., None])[:, None, :]
    return c


@telemetry.spanned("prt_transfer")
def compute_diffuse_transfer(scene, meta, p, ns_normal, eps, lmax, n_samples, pix, samp,
                             dim_base=_TRANSFER_DIM):
    """SHComputeDiffuseTransfer: T_i = 1/ns sum Y_i(w) V(w) max(0, w.n)/pdf
    over uniform sphere directions, each a "prt_transfer" wave. Returns
    (N, terms)."""
    n = p.shape[0]
    T = p.new_zeros((n, sh.sh_terms(lmax)))
    pdf = 1.0 / (4.0 * math.pi)
    for s in range(n_samples):
        u1, u2 = rngmod.sample_2d(meta.sampler, pix, samp, dim_base + s)
        w = mc.uniform_sample_sphere(u1, u2)
        cosw = dot(w, ns_normal)
        ok = cosw > 0.0
        occ = integ._trace(scene, p + w * eps[..., None], w, torch.where(ok, 1.0e7, 0.0),
                           any_hit=True, role="prt_transfer")
        wgt = torch.where(ok & ~occ, cosw / (pdf * n_samples), 0.0)
        T = T + sh.sh_evaluate(w, lmax) * wgt[..., None]
    return T


def _bounds(scene):
    v = scene["verts"]
    return torch.amin(v, dim=0), torch.amax(v, dim=0)


def prt_preprocess(scene, meta, cfg):
    """DiffusePRT/GlossyPRT Preprocess: {"c_in": (terms, 3)}."""
    lo, hi = _bounds(scene)
    p = ((lo + hi) * 0.5)[None, :]
    zero = torch.zeros(1, dtype=torch.int64, device=p.device)
    c = project_incident_direct(scene, meta, p, p.new_full((1,), 1e-3), cfg.prt_lmax,
                                cfg.prt_nsamples, zero, zero, with_visibility=False)
    return {"c_in": sh.sh_reduce_ringing(c[0], cfg.prt_lmax)}


def _camera_hit(scene, meta, rays):
    o, d = rays["o"], rays["d"]
    hit = integ._trace(scene, o, d, o.new_full((o.shape[0],), 1.0e7), role="camera")
    sg, lobes, _ = integ._shade_context(scene, meta, hit, o, d)
    return hit["prim"] >= 0, sg, lobes


def _facing(sg, d):
    return torch.where((dot(sg["ns"], -d) < 0.0)[..., None], -sg["ns"], sg["ns"])


def diffuseprt_li(scene, meta, cfg, rays, pix, samp, aux):
    """DiffusePRTIntegrator::Li: (rho/pi) sum_i c_in[i] T[i], T the
    transfer over the hemisphere facing the viewer; escaped rays take the
    environment."""
    d = rays["d"]
    active, sg, lobes = _camera_hit(scene, meta, rays)
    T = compute_diffuse_transfer(scene, meta, sg["p"], _facing(sg, d), sg["ray_eps"],
                                 cfg.prt_lmax, cfg.prt_nsamples, pix, samp)
    L = bx.diffuse_albedo(lobes) / math.pi * (T @ aux["c_in"])
    L = torch.where(active[..., None], torch.clamp_min(L, 0.0),
                    lt.escaped_radiance(scene, d, meta.light_types))
    return L * rays["weight"][..., None]


@telemetry.spanned("prt_transfer")
def project_transferred(scene, meta, p, eps, lmax, n_samples, pix, samp, c_in):
    """The transferred radiance c_t (N, terms, 3): V(w) max(0, L_in(w))
    projected over n_samples uniform sphere directions, L_in rebuilt from
    the expansion c_in, each direction a "prt_transfer" wave."""
    n = p.shape[0]
    c_t = p.new_zeros((n, sh.sh_terms(lmax), 3))
    pdf = 1.0 / (4.0 * math.pi)
    for s in range(n_samples):
        u1, u2 = rngmod.sample_2d(meta.sampler, pix, samp, _GLOSSY_DIM + s)
        w = mc.uniform_sample_sphere(u1, u2)
        occ = integ._trace(scene, p + w * eps[..., None], w, p.new_full((n,), 1.0e7),
                           any_hit=True, role="prt_transfer")
        Y = sh.sh_evaluate(w, lmax)
        Lw = torch.clamp_min(Y @ c_in, 0.0)
        wgt = torch.where(~occ, 1.0 / (pdf * n_samples), 0.0)
        c_t = c_t + Y[..., None] * (Lw * wgt[..., None])[:, None, :]
    return c_t


def glossyprt_li(scene, meta, cfg, rays, pix, samp, aux):
    """GlossyPRTIntegrator::Li: the transferred radiance c_t at the hit, its
    Phong-convolved expansion at the mirror direction times Ks, plus Kd/pi
    times its cosine convolution at the normal."""
    d = rays["d"]
    n = d.shape[0]
    lmax = cfg.prt_lmax
    active, sg, _ = _camera_hit(scene, meta, rays)
    ns = _facing(sg, d)
    p = sg["p"]
    c_t = project_transferred(scene, meta, p, sg["ray_eps"], lmax, cfg.prt_nsamples, pix,
                              samp, aux["c_in"])
    ks = p.new_tensor(cfg.prt_ks)
    expo = p.new_full((n,), 1.0 / max(cfg.prt_roughness, 1e-4))
    wo = -d
    wr = normalize(2.0 * dot(wo, ns)[..., None] * ns - wo)
    band = torch.cat([torch.exp(-l * l / (2.0 * expo))[:, None] * p.new_ones((n, 2 * l + 1))
                      for l in range(lmax + 1)], dim=1)
    Lr = torch.sum((sh.sh_evaluate(wr, lmax) * band)[..., None] * c_t, dim=1)
    L = ks * torch.clamp_min(Lr, 0.0)
    ce = sh.sh_convolve_cos_theta(lmax, c_t)
    E = torch.clamp_min(torch.sum(sh.sh_evaluate(ns, lmax)[..., None] * ce, dim=1), 0.0)
    L = L + p.new_tensor(cfg.prt_kd) / math.pi * E
    L = torch.where(active[..., None], L, lt.escaped_radiance(scene, d, meta.light_types))
    return L * rays["weight"][..., None]


# ------------------------------------------------------------------- probes
@telemetry.spanned("probe_bake")
def bake_probes(scene, meta, cfg, nx, ny, nz, n_samples=64, lmax=None):
    """createprobes.cpp: the incident direct radiance projected at the cell
    centres of an (nx, ny, nz) grid over the scene's bound. Returns
    {coeffs (nx, ny, nz, terms, 3), bmin, bmax, lmax}."""
    lmax = lmax if lmax is not None else cfg.prt_lmax
    bmin, bmax = _bounds(scene)
    dev = bmin.device
    axes = [(torch.arange(k, device=dev) + 0.5) / k for k in (nx, ny, nz)]
    t = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1).reshape(-1, 3)
    p = bmin + t * (bmax - bmin)
    n = p.shape[0]
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    c = project_incident_direct(scene, meta, p, p.new_full((n,), 1e-3), lmax, n_samples,
                                pix, torch.zeros_like(pix))
    return {"coeffs": c.reshape(nx, ny, nz, sh.sh_terms(lmax), 3), "bmin": bmin,
            "bmax": bmax, "lmax": lmax}


def write_probes(path, probes):
    """The probe grid as the reference's #-commented text float file."""
    c = probes["coeffs"].detach().cpu().numpy()
    nx, ny, nz, terms, _ = c.shape
    bmin = probes["bmin"].detach().cpu().numpy()
    bmax = probes["bmax"].detach().cpu().numpy()
    with open(path, "w") as f:
        f.write("# grail radiance probes (createprobes.cpp analog)\n")
        f.write(f"{nx} {ny} {nz} {terms}\n")
        f.write(" ".join(f"{x:.9g}" for x in list(bmin) + list(bmax)) + "\n")
        for val in c.reshape(-1):
            f.write(f"{val:.9g}\n")


def read_probes(path, device):
    """A probe file (the reference's or write_probes') as the probe dict on
    `device`."""
    with open(path) as f:
        lines = [ln for ln in f if not ln.startswith("#")]
    nx, ny, nz, terms = (int(x) for x in lines[0].split())
    bounds = [float(x) for x in lines[1].split()]
    vals = np.asarray([float(x) for ln in lines[2:] for x in ln.split()], np.float32)
    return {"coeffs": torch.tensor(vals.reshape(nx, ny, nz, terms, 3), device=device),
            "bmin": torch.tensor(bounds[:3], dtype=torch.float32, device=device),
            "bmax": torch.tensor(bounds[3:], dtype=torch.float32, device=device),
            "lmax": int(math.isqrt(terms)) - 1}


def useprobes_li(scene, meta, cfg, rays, pix, samp, aux):
    """UseRadianceProbes::Li: the probes' coefficients interpolated
    trilinearly at the camera hit, convolved with the cosine, evaluated at
    the shading normal and shaded by the diffuse reflectance; escaped rays
    take the environment."""
    probes = aux["probes"]
    c = probes["coeffs"]                                       # (nx,ny,nz,T,3)
    nx, ny, nz = c.shape[:3]
    lmax = int(math.isqrt(int(c.shape[3]))) - 1
    d = rays["d"]
    active, sg, lobes = _camera_hit(scene, meta, rays)
    t = (sg["p"] - probes["bmin"]) / torch.clamp_min(probes["bmax"] - probes["bmin"], 1e-9)
    g = [torch.clamp(t[:, a] * k - 0.5, 0.0, k - 1.0) for a, k in enumerate((nx, ny, nz))]
    i0 = [torch.floor(ga).to(torch.int64) for ga in g]
    f = [(ga - ia)[:, None, None] for ga, ia in zip(g, i0)]
    i1 = [torch.clamp_max(ia + 1, k - 1) for ia, k in zip(i0, (nx, ny, nz))]
    (ix, iy, iz), (ix1, iy1, iz1), (fx, fy, fz) = i0, i1, f
    c00 = c[ix, iy, iz] * (1 - fz) + c[ix, iy, iz1] * fz
    c01 = c[ix, iy1, iz] * (1 - fz) + c[ix, iy1, iz1] * fz
    c10 = c[ix1, iy, iz] * (1 - fz) + c[ix1, iy, iz1] * fz
    c11 = c[ix1, iy1, iz] * (1 - fz) + c[ix1, iy1, iz1] * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    ce = sh.sh_convolve_cos_theta(lmax, c0 * (1 - fx) + c1 * fx)
    E = torch.clamp_min(torch.sum(sh.sh_evaluate(sg["ns"], lmax)[..., None] * ce, dim=1), 0.0)
    L = bx.diffuse_albedo(lobes) / math.pi * E
    L = torch.where(active[..., None], L, lt.escaped_radiance(scene, d, meta.light_types))
    return L * rays["weight"][..., None]
