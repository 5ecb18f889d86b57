"""Participating media (port of grail/shade/media.py; pbrt
src/core/volume.{h,cpp}, src/volumes/* and src/integrators/{emission,
single}.cpp) over the scene's region table.

Region kinds: HOMOGENEOUS (constant sigma_a and sigma_s in a box: closed-form
optical thickness and emission), GRID (a trilinear density grid times the
base sigmas, volumegrid.cpp) and EXPONENTIAL (a e^(-b h) along `updir`,
exponential.cpp). Each region scatters with Henyey-Greenstein. The kinds are
static (SceneMeta.media_kinds): a homogeneous scene marches nothing, the
others march MAX_MARCH_STEPS jittered steps per segment. The reference's
lax.fori_loop over the steps is a Python loop over full-width tensors here,
accumulating in the reference's order.

single_scatter_li traces one shadow ray a lane at every step of the camera
segment (SingleScatteringIntegrator); those waves go through the
integrator's trace hook under the role "medium". Like the reference, it
always marches 32 steps (the configuration's vol_stepsize is read by
nothing) and its shadow rays skip alpha cutouts and carry no ray time.
"""
from __future__ import annotations

import math

import torch

from .. import telemetry
from ..core import montecarlo as mc
from ..core import rng as rngmod
from ..core import transform as tr
from ..core.vecmath import dot, lerp

HOMOGENEOUS = 0
GRID = 1
EXPONENTIAL = 2

MAX_MARCH_STEPS = 32

# GetVolumeScatteringProperties (pbrt volume.cpp's measured media; Jensen et
# al. 2001): name -> (sigma_a, sigma_prime_s) in mm^-1. Names are matched
# case-sensitively, as in the reference.
MEASURED_MEDIA = {
    "Apple": ((0.0030, 0.0034, 0.046), (2.29, 2.39, 1.97)),
    "Chicken1": ((0.015, 0.077, 0.19), (0.15, 0.21, 0.38)),
    "Chicken2": ((0.018, 0.088, 0.20), (0.19, 0.25, 0.32)),
    "Cream": ((0.0002, 0.0028, 0.0163), (7.38, 5.47, 3.15)),
    "Ketchup": ((0.061, 0.97, 1.45), (0.18, 0.07, 0.03)),
    "Marble": ((0.0021, 0.0041, 0.0071), (2.19, 2.62, 3.00)),
    "Potato": ((0.0024, 0.0090, 0.12), (0.68, 0.70, 0.55)),
    "Skimmilk": ((0.0014, 0.0025, 0.0142), (0.70, 1.22, 1.90)),
    "Skin1": ((0.032, 0.17, 0.48), (0.74, 0.88, 1.01)),
    "Skin2": ((0.013, 0.070, 0.145), (1.09, 1.59, 1.79)),
    "Spectralon": ((0.00001, 0.00001, 0.00001), (11.6, 20.4, 14.9)),
    "Wholemilk": ((0.0011, 0.0024, 0.014), (2.55, 3.21, 3.77)),
}

# the camera segment's sampler dimensions: the jitter at MEDIA_DIM, then
# three a march step (light pick, light position); secondary segments'
# jitter at MEDIA_DIM + 1 + SEGMENT_STRIDE * bounce
MEDIA_DIM = 3000
SEGMENT_STRIDE = 300


def region_segment(media, r, o, d, tmax):
    """The ray's overlap [t0, t1] with region r's box (in volume space), and
    whether it is non-empty."""
    ov = tr.xform_p(media["w2v"][r], o)
    dv = tr.xform_v(media["w2v"][r], d)
    inv = 1.0 / torch.where(torch.abs(dv) < 1e-12,
                            torch.where(dv < 0, -1e-12, 1e-12), dv)
    ta = (media["bounds_min"][r] - ov) * inv
    tb = (media["bounds_max"][r] - ov) * inv
    t0 = torch.clamp_min(torch.amax(torch.minimum(ta, tb), dim=-1), 0.0)
    t1 = torch.minimum(torch.amin(torch.maximum(ta, tb), dim=-1), tmax)
    return t0, t1, t0 < t1


def density_at(media, grids, r, kind, p_world):
    """The density multiplier at world points for region r of static kind."""
    pv = tr.xform_p(media["w2v"][r], p_world)
    bmin, bmax = media["bounds_min"][r], media["bounds_max"][r]
    inside = torch.all((pv >= bmin) & (pv <= bmax), dim=-1)
    if kind == HOMOGENEOUS:
        return inside.to(torch.float32)
    if kind == EXPONENTIAL:
        h = dot(pv - bmin, media["updir"][r])
        return torch.where(inside, media["exp_a"][r] * torch.exp(-media["exp_b"][r] * h),
                           0.0)
    # GRID: trilinear (VolumeGridDensity::Density)
    val = p_world.new_zeros(p_world.shape[:-1])
    for gid, grid in enumerate(grids):
        nz, ny, nx = grid.shape
        u = (pv - bmin) / torch.clamp_min(bmax - bmin, 1e-12)
        x = u[..., 0] * nx - 0.5
        y = u[..., 1] * ny - 0.5
        z = u[..., 2] * nz - 0.5
        x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, nx - 1)
        y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, ny - 1)
        z0 = torch.clamp(torch.floor(z).to(torch.int64), 0, nz - 1)
        x1 = torch.clamp_max(x0 + 1, nx - 1)
        y1 = torch.clamp_max(y0 + 1, ny - 1)
        z1 = torch.clamp_max(z0 + 1, nz - 1)
        fx = torch.clamp(x - x0, 0.0, 1.0)
        fy = torch.clamp(y - y0, 0.0, 1.0)
        fz = torch.clamp(z - z0, 0.0, 1.0)
        d00 = lerp(fx, grid[z0, y0, x0], grid[z0, y0, x1])
        d10 = lerp(fx, grid[z0, y1, x0], grid[z0, y1, x1])
        d01 = lerp(fx, grid[z1, y0, x0], grid[z1, y0, x1])
        d11 = lerp(fx, grid[z1, y1, x0], grid[z1, y1, x1])
        g = lerp(fz, lerp(fy, d00, d10), lerp(fy, d01, d11))
        val = torch.where(media["grid_id"][r] == gid, g, val)
    return torch.where(inside, val, 0.0)


def _regions(scene, meta):
    """(media table, density grids, region kinds), or None without media."""
    media = scene.get("media")
    if media is None or not meta.media_kinds:
        return None
    return media, scene.get("density_grids", ()), meta.media_kinds


def tau(scene, meta, o, d, tmax, u_jitter):
    """Optical thickness summed over the regions (VolumeRegion::tau): closed
    form in a homogeneous region, a jittered march elsewhere."""
    total = o.new_zeros(o.shape[:-1] + (3,))
    regions = _regions(scene, meta)
    if regions is None:
        return total
    media, grids, kinds = regions
    for r, kind in enumerate(kinds):
        t0, t1, hit = region_segment(media, r, o, d, tmax)
        seg = torch.clamp_min(t1 - t0, 0.0)
        sig_t = media["sigma_a"][r] + media["sigma_s"][r]
        if kind == HOMOGENEOUS:
            contrib = seg[..., None] * sig_t
        else:
            dt = seg / MAX_MARCH_STEPS
            accum = torch.zeros_like(seg)
            for s in range(MAX_MARCH_STEPS):
                p = o + (t0 + (s + u_jitter) * dt)[..., None] * d
                accum = accum + density_at(media, grids, r, kind, p) * dt
            contrib = accum[..., None] * sig_t
        total = total + torch.where(hit[..., None], contrib, 0.0)
    return total


@telemetry.spanned("medium")
def transmittance(scene, meta, o, d, tmax, u_jitter):
    """exp(-tau) (EmissionIntegrator::Transmittance); ones without media."""
    if _regions(scene, meta) is None:
        return o.new_ones(o.shape[:-1] + (3,))
    return torch.exp(-tau(scene, meta, o, d, tmax, u_jitter))


def phase_hg_eval(g, cos_theta):
    return mc.hg_pdf(cos_theta, g)


# the phase function library (pbrt volume.cpp PhaseIsotropic, PhaseRayleigh,
# PhaseMieHazy, PhaseMieMurky, PhaseSchlick), each normalized over the
# sphere; the regions scatter with Henyey-Greenstein, as
# HomogeneousVolumeDensity does
INV_4PI = 1.0 / (4.0 * 3.14159265358979)


def phase_isotropic(cos_theta):
    return torch.full_like(cos_theta, INV_4PI)


def phase_rayleigh(cos_theta):
    return 3.0 / (16.0 * math.pi) * (1.0 + cos_theta * cos_theta)


def phase_mie_hazy(cos_theta):
    return (0.5 + 4.5 * torch.pow(0.5 * (1.0 + cos_theta), 8.0)) * INV_4PI


def phase_mie_murky(cos_theta):
    return (0.5 + 16.5 * torch.pow(0.5 * (1.0 + cos_theta), 32.0)) * INV_4PI


def phase_schlick(g, cos_theta):
    """Schlick's Henyey-Greenstein approximation, with pbrt's g -> k
    polynomial."""
    k = 1.55 * g - 0.55 * g * g * g
    kc = k * cos_theta
    return INV_4PI * (1.0 - k * k) / ((1.0 - kc) * (1.0 - kc))


@telemetry.spanned("medium")
def emission_li(scene, meta, o, d, tmax, pix, samp, dim_base=MEDIA_DIM):
    """EmissionIntegrator::Li: the integral of T sigma_a Lve along the
    segment, closed form in a homogeneous region. Returns (Lv, T)."""
    n = o.shape[0]
    L = o.new_zeros((n, 3))
    T_total = o.new_ones((n, 3))
    regions = _regions(scene, meta)
    if regions is None:
        return L, T_total
    media, grids, kinds = regions
    u0 = rngmod.sample_1d(meta.sampler, pix, samp, dim_base)
    for r, kind in enumerate(kinds):
        t0, t1, hit = region_segment(media, r, o, d, tmax)
        seg = torch.clamp_min(t1 - t0, 0.0)
        sig_t = media["sigma_a"][r] + media["sigma_s"][r]
        lve = media["le"][r]
        if kind == HOMOGENEOUS:
            # the integral of Lve e^(-sigma_t t) over [0, L]
            T = torch.exp(-sig_t * seg[..., None])
            Lr = lve * (1.0 - T) / torch.clamp_min(sig_t, 1e-9)
        else:
            dt = seg / MAX_MARCH_STEPS
            Lr, T = o.new_zeros((n, 3)), o.new_ones((n, 3))
            for s in range(MAX_MARCH_STEPS):
                p = o + (t0 + (s + u0) * dt)[..., None] * d
                step = (density_at(media, grids, r, kind, p) * dt)[..., None]
                Lr = Lr + T * lve * step
                T = T * torch.exp(-sig_t * step)
        L = L + torch.where(hit[..., None], Lr, 0.0)
        T_total = T_total * torch.where(hit[..., None], T, 1.0)
    return L, T_total


@telemetry.spanned("medium")
def single_scatter_li(scene, meta, o, d, tmax, pix, samp, trace, dim_base=MEDIA_DIM):
    """SingleScatteringIntegrator::Li: march the segment and at each step add
    sigma_s phase T_l L_l for one uniformly picked light, plus emission.
    trace(o, d, tmax): the any-hit wave of a step's shadow rays (the
    integrator's hook, role "medium"). Returns (Lv, T)."""
    from . import lights as lt

    n = o.shape[0]
    L_out, T_out = o.new_zeros((n, 3)), o.new_ones((n, 3))
    regions = _regions(scene, meta)
    if regions is None:
        return L_out, T_out
    media, grids, kinds = regions
    n_lights = meta.n_lights
    u0 = rngmod.sample_1d(meta.sampler, pix, samp, dim_base)
    for r, kind in enumerate(kinds):
        t0, t1, hit = region_segment(media, r, o, d, tmax)
        dt = torch.clamp_min(t1 - t0, 0.0) / MAX_MARCH_STEPS
        sig_s = media["sigma_s"][r]
        sig_t = media["sigma_a"][r] + sig_s
        g = media["g"][r]
        lve = media["le"][r]
        Lr, T = o.new_zeros((n, 3)), o.new_ones((n, 3))
        for s in range(MAX_MARCH_STEPS):
            p = o + (t0 + (s + u0) * dt)[..., None] * d
            dens = density_at(media, grids, r, kind, p)
            Lr = Lr + T * lve * (dens * dt)[..., None]
            if n_lights > 0:
                # the reference's step index is traced: HALTON takes base 2
                ul, u2a, u2b = (rngmod.sample_1d(meta.sampler, pix, samp,
                                                 dim_base + k + 3 * s, traced=True)
                                for k in (1, 2, 3))
                lidx = torch.clamp_max((ul * n_lights).to(torch.int32), n_lights - 1)
                ls = lt.sample_li(scene, lidx, p, u2a, u2b, ul, meta.light_types,
                                  meta.light_image_rows)
                occluded = trace(p + ls["wi"] * 1e-4, ls["wi"],
                                 torch.where(hit, ls["dist"] * (1 - 1e-3), 0.0))
                T_light = transmittance(scene, meta, p, ls["wi"], ls["dist"], u0)
                ph = phase_hg_eval(g, dot(-d, ls["wi"]))
                ok = hit & ~occluded & (ls["pdf"] > 0)
                contrib = (T * sig_s * T_light * ls["radiance"]
                           * (dens * dt * ph * n_lights
                              / torch.clamp_min(ls["pdf"], 1e-12))[..., None])
                Lr = Lr + torch.where(ok[..., None], contrib, 0.0)
            T = T * torch.exp(-sig_t * (dens * dt)[..., None])
        L_out = L_out + torch.where(hit[..., None], Lr, 0.0)
        T_out = T_out * torch.where(hit[..., None], T, 1.0)
    return L_out, T_out


def sample_distance(scene, meta, o, d, tmax, u, channel_u):
    """Distance sampling in region 0, homogeneous (the reference's upgrade
    over fixed-step marching): t with density sigma_t e^(-sigma_t t) of one
    uniformly picked channel, weighted by the channels' average pdf. None
    without media."""
    media = scene.get("media")
    if media is None:
        return None
    n = o.shape[0]
    t0, t1, hit = region_segment(media, 0, o, d, tmax)
    sig_t_rgb = media["sigma_a"][0] + media["sigma_s"][0]
    ch = torch.clamp_max((channel_u * 3).to(torch.int64), 2)
    sig_ch = sig_t_rgb[ch]
    t = t0 + -torch.log(torch.clamp_min(1.0 - u, 1e-12)) / torch.clamp_min(sig_ch, 1e-12)
    in_medium = hit & (t < t1) & (sig_ch > 0)
    seg = torch.where(in_medium, torch.clamp_min(t - t0, 0.0),
                      torch.clamp_min(t1 - t0, 0.0))
    tr_rgb = torch.exp(-sig_t_rgb[None] * seg[..., None])
    pdf_scatter = torch.mean(sig_t_rgb[None] * tr_rgb, dim=-1)
    pdf_pass = torch.mean(tr_rgb, dim=-1)
    return {
        "t": torch.where(in_medium, t, tmax),
        "in_medium": in_medium,
        "w_scatter": (tr_rgb * media["sigma_s"][0][None]
                      / torch.clamp_min(pdf_scatter, 1e-12)[..., None]),
        "w_pass": torch.where(hit[..., None],
                              tr_rgb / torch.clamp_min(pdf_pass, 1e-12)[..., None],
                              o.new_ones((n, 3))),
        "g": media["g"][0].expand(n),
    }
