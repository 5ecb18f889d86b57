"""Materials, textures and lights of the reference renderer, in plain PyTorch:
the Lambertian and Blinn microfacet lobes (pbrt's BSDF with its component
choice and averaged pdf), the uv-mapped image texture filtered by EWA over a
MIP pyramid of 2x2 box-filtered levels (a fixed 4x4 tap grid with Gaussian
weights, as the system under test documents), the triangle area light and
the lat-long environment light sampled by a Distribution2D of
luminance·sinθ."""
from __future__ import annotations

import math

import numpy as np
import torch

from .geometry import PI, cross, dot, normalize

LAMBERT, BLINN = "lambert", "blinn"
INV_PI = 1.0 / math.pi
INV_2PI = 0.5 / math.pi
LUMA = (0.212671, 0.715160, 0.072169)


def luminance(c):
    return LUMA[0] * c[..., 0] + LUMA[1] * c[..., 1] + LUMA[2] * c[..., 2]


def power_heuristic(fp, gp):
    f = torch.clamp_max(fp, 1e18)
    g = torch.clamp_max(gp, 1e18)
    return (f * f) / torch.clamp_min(f * f + g * g, 1e-12)


def concentric_disk(u1, u2):
    sx, sy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    use_x = torch.abs(sx) > torch.abs(sy)
    r = torch.where(use_x, sx, sy)
    theta = torch.where(use_x, (PI / 4.0) * (sy / torch.where(sx == 0.0, 1.0, sx)),
                        (PI / 2.0) - (PI / 4.0) * (sx / torch.where(sy == 0.0, 1.0, sy)))
    zero = (sx == 0.0) & (sy == 0.0)
    return (torch.where(zero, 0.0, r * torch.cos(theta)),
            torch.where(zero, 0.0, r * torch.sin(theta)))


def sqrt0(x):
    return torch.sqrt(torch.clamp_min(x, 0.0))


# ------------------------------------------------------------------- textures
def bilinear(img, s, t):
    """Repeat-wrapped bilinear lookup of an (H, W, 3) image."""
    h, w = img.shape[0], img.shape[1]
    x, y = s * w - 0.5, t * h - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0f)[..., None], (y - y0f)[..., None]
    x0, y0 = x0f.to(torch.int64) % w, y0f.to(torch.int64) % h
    x1, y1 = (x0 + 1) % w, (y0 + 1) % h
    return ((1 - fx) * (1 - fy) * img[y0, x0] + (1 - fx) * fy * img[y1, x0]
            + fx * (1 - fy) * img[y0, x1] + fx * fy * img[y1, x1])


def pyramid(img):
    """MIP levels, finest first, each the 2x2 box average of the one above
    (the image is a power of two on each side)."""
    h, w = img.shape[:2]
    if h & (h - 1) or w & (w - 1):
        raise ValueError("the reference's MIP pyramid takes power-of-two images")
    levels = [img]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        cur = levels[-1]
        fh, fw = (2 if cur.shape[0] > 1 else 1), (2 if cur.shape[1] > 1 else 1)
        levels.append(cur.reshape(cur.shape[0] // fh, fh, cur.shape[1] // fw, fw, 3)
                      .mean(dim=(1, 3)))
    return levels


def _level_lookup(levels, lvl, s, t):
    out = torch.zeros(s.shape + (3,), dtype=s.dtype, device=s.device)
    for i, img in enumerate(levels):
        out = torch.where((lvl == i)[..., None], bilinear(img, s, t), out)
    return out


def trilinear(levels, s, t, width):
    n = len(levels)
    s, t = torch.remainder(s, 1.0), torch.remainder(t, 1.0)
    lvl = torch.clamp((n - 1) + torch.log2(torch.clamp_min(width, 1e-8)), 0.0, n - 1)
    l0 = torch.floor(lvl)
    frac = (lvl - l0)[..., None]
    i0 = l0.to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, n - 1)
    return (1.0 - frac) * _level_lookup(levels, i0, s, t) + frac * _level_lookup(levels, i1, s, t)


def ewa(levels, s, t, ds0, dt0, ds1, dt1, maxaniso=8.0, taps=4):
    """Elliptically weighted average over the level of the ellipse's minor
    axis, at a fixed taps x taps grid over its bounding box."""
    n = len(levels)
    len0, len1 = sqrt0(ds0 * ds0 + dt0 * dt0), sqrt0(ds1 * ds1 + dt1 * dt1)
    major, minor = torch.maximum(len0, len1), torch.minimum(len0, len1)
    minor = minor * torch.where(minor * maxaniso < major,
                                major / torch.clamp_min(minor * maxaniso, 1e-12), 1.0)
    lvl = torch.clamp((n - 1) + torch.log2(torch.clamp_min(minor, 1e-8)), 0.0, n - 1)
    li = torch.floor(lvl).to(torch.int64)
    A = dt0 * dt0 + dt1 * dt1 + 1e-10
    B = -2.0 * (ds0 * dt0 + ds1 * dt1)
    C = ds0 * ds0 + ds1 * ds1 + 1e-10
    F = A * C - B * B * 0.25
    proper = torch.isfinite(1.0 / F)
    inv_f = 1.0 / torch.where(proper, F, 1.0)
    A, B, C = A * inv_f, B * inv_f, C * inv_f
    det = torch.clamp_min(4.0 * A * C - B * B, 1e-12)
    ur = torch.clamp_max(sqrt0(C * 4.0 / det), 0.5)
    vr = torch.clamp_max(sqrt0(A * 4.0 / det), 0.5)
    acc = torch.zeros(s.shape + (3,), dtype=s.dtype, device=s.device)
    wsum = torch.zeros(s.shape + (1,), dtype=s.dtype, device=s.device)
    grid = [(k + 0.5) / taps * 2.0 - 1.0 for k in range(taps)]
    for tu in grid:
        for tv in grid:
            du, dv = tu * ur, tv * vr
            r2 = A * du * du + B * du * dv + C * dv * dv
            w = torch.where(proper & (r2 < 1.0), torch.exp(-2.0 * r2) - math.exp(-2.0), 0.0)
            w = torch.clamp_min(w, 0.0)[..., None]
            acc = acc + w * _level_lookup(levels, li, torch.remainder(s + du, 1.0),
                                          torch.remainder(t + dv, 1.0))
            wsum = wsum + w
    fallback = trilinear(levels, s, t, 2.0 ** (lvl - (n - 1)))
    return torch.where(wsum > 1e-8, acc / torch.clamp_min(wsum, 1e-8), fallback)


# ----------------------------------------------------------------------- BSDF
def _half(wo, wi):
    return normalize(wi + wo), torch.sum(torch.abs(wi + wo), dim=-1) > 1e-9


def fresnel_dielectric(cosi, eta):
    cosi = torch.clamp(cosi, -1.0, 1.0)
    entering = cosi > 0.0
    ei = torch.where(entering, 1.0, eta)
    et = torch.where(entering, eta, 1.0)
    sint = ei / et * sqrt0(1.0 - cosi * cosi)
    cost = sqrt0(1.0 - sint * sint)
    aci = torch.abs(cosi)
    rpar = (et * aci - ei * cost) / torch.clamp_min(et * aci + ei * cost, 1e-12)
    rper = (ei * aci - et * cost) / torch.clamp_min(ei * aci + et * cost, 1e-12)
    return torch.where(sint >= 1.0, 1.0, 0.5 * (rpar * rpar + rper * rper))


def _blinn_pow(wh, e):
    return torch.pow(torch.clamp_min(torch.abs(wh[..., 2]), 1e-6), e)


def lobe_f(kind, R, e, eta, wo, wi):
    reflect = wo[..., 2] * wi[..., 2] > 0.0
    if kind == LAMBERT:
        return torch.where(reflect[..., None], R * INV_PI, 0.0)
    wh, ok = _half(wo, wi)
    aci, aco = torch.abs(wi[..., 2]), torch.abs(wo[..., 2])
    fr = fresnel_dielectric(dot(wi, wh), eta)
    d = (e + 2.0) * INV_2PI * _blinn_pow(wh, e)
    wodh = torch.clamp_min(torch.abs(dot(wo, wh)), 1e-6)
    nh = torch.abs(wh[..., 2])
    g = torch.clamp_max(torch.minimum(2.0 * nh * aco / wodh, 2.0 * nh * aci / wodh), 1.0)
    denom = torch.clamp_min(4.0 * aci * aco, 1e-6)
    good = reflect & ok & (aci > 1e-6) & (aco > 1e-6)
    return torch.where(good[..., None], R * fr[..., None] * (d * g / denom)[..., None], 0.0)


def lobe_pdf(kind, e, wo, wi):
    reflect = wo[..., 2] * wi[..., 2] > 0.0
    if kind == LAMBERT:
        return torch.where(reflect, torch.abs(wi[..., 2]) * INV_PI, 0.0)
    wh, ok = _half(wo, wi)
    pdf = (e + 1.0) * _blinn_pow(wh, e) * INV_2PI / (
        4.0 * torch.clamp_min(torch.abs(dot(wo, wh)), 1e-6))
    return torch.where(reflect & ok, pdf, 0.0)


class Bsdf:
    """A lane's lobe stack: kinds (static, one per slot, shared by the lanes
    of a material) with per-lane R (N, 3), exponent and index (N,)."""

    def __init__(self, slots, present):
        self.slots = slots          # [(kind, R, e, eta)] over the stack's slots
        self.present = present      # (N, K) bool: the lane's material has slot k

    def f(self, wo, wi):
        out = torch.zeros_like(wo)
        for k, (kind, R, e, eta) in enumerate(self.slots):
            out = out + torch.where(self.present[:, k, None], lobe_f(kind, R, e, eta, wo, wi),
                                    0.0)
        return out

    def pdf(self, wo, wi):
        tot = torch.zeros_like(wo[..., 0])
        for k, (kind, _, e, _) in enumerate(self.slots):
            tot = tot + torch.where(self.present[:, k], lobe_pdf(kind, e, wo, wi), 0.0)
        n = self.present.sum(-1).to(wo.dtype)
        return torch.where(n > 0, tot / torch.clamp_min(n, 1.0), 0.0)

    def sample(self, wo, u1, u2, uc):
        """pbrt BSDF::Sample_f: a component chosen by uc, its direction, and
        the whole stack's f and averaged pdf there."""
        n = self.present.sum(-1)
        which = torch.minimum((uc * n.to(uc.dtype)).to(torch.int64), torch.clamp_min(n - 1, 0))
        rank = torch.cumsum(self.present.to(torch.int64), dim=-1) - 1
        side = torch.where(wo[..., 2] > 0.0, 1.0, -1.0).to(wo.dtype)
        wi = torch.zeros_like(wo)
        valid = torch.zeros_like(n, dtype=torch.bool)
        for k, (kind, _, e, _) in enumerate(self.slots):
            pick = self.present[:, k] & (rank[:, k] == which)
            if kind == LAMBERT:
                dx, dy = concentric_disk(u1, u2)
                cand = torch.stack([dx, dy, sqrt0(1.0 - dx * dx - dy * dy) * side], dim=-1)
                ok = torch.ones_like(pick)
            else:
                ct = torch.pow(torch.clamp_min(u1, 1e-12), 1.0 / (e + 1.0))
                st = sqrt0(1.0 - ct * ct)
                phi = u2 * 2.0 * PI
                wh = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], dim=-1)
                wh = torch.where((wo[..., 2] * wh[..., 2] > 0.0)[..., None], wh, -wh)
                cand = -wo + 2.0 * dot(wo, wh)[..., None] * wh
                ok = wo[..., 2] * cand[..., 2] > 0.0
            wi = torch.where(pick[..., None], cand, wi)
            valid = torch.where(pick, ok, valid)
        f = self.f(wo, wi)
        pdf = self.pdf(wo, wi)
        return wi, f, pdf, valid & (n > 0) & (pdf > 0.0)


# --------------------------------------------------------------------- lights
class Distribution1D:
    def __init__(self, func):
        n = func.shape[-1]
        c = torch.cumsum(func, dim=-1) / n
        self.func, self.func_int = func, c[..., -1]
        cdf = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
        self.cdf = cdf / self.func_int[..., None]


def _interval(cdf_rows, u):
    """The last i with cdf[i] <= u, clipped to [0, n - 2], a row a lane."""
    n = cdf_rows.shape[-1]
    i = torch.searchsorted(cdf_rows.contiguous(), u[..., None].contiguous(), right=True)[..., 0] - 1
    return torch.clamp(i, 0, n - 2)


class EnvLight:
    """A lat-long environment map whose +z is the light's pole (identity
    light-to-world)."""

    def __init__(self, env_map, emit, dt):
        """env_map: (H, W, 3) float32 numpy; the importance map is made on the
        host (luminance in float32, times sin θ in float64)."""
        h = env_map.shape[0]
        sint = np.sin((np.arange(h) + 0.5) / h * np.pi)
        lum = (np.float32(LUMA[0]) * env_map[..., 0] + np.float32(LUMA[1]) * env_map[..., 1]
               + np.float32(LUMA[2]) * env_map[..., 2])
        func = torch.as_tensor((lum * sint[:, None] + 1e-9).astype(np.float32),
                               device=emit.device).to(dt)
        self.map = torch.as_tensor(env_map, device=emit.device).to(dt)
        self.emit = emit
        self.cond = Distribution1D(func)
        self.marg = Distribution1D(self.cond.func_int)

    def radiance(self, w):
        w = normalize(w)
        phi = torch.atan2(w[..., 1], w[..., 0])
        phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
        theta = torch.arccos(torch.clamp(w[..., 2], -1.0, 1.0))
        return self.emit * bilinear(self.map, phi * INV_2PI, theta * INV_PI)

    def pdf(self, w):
        w = normalize(w)
        theta = torch.arccos(torch.clamp(w[..., 2], -1.0, 1.0))
        phi = torch.atan2(w[..., 1], w[..., 0])
        phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
        nv, nu = self.cond.func.shape
        iu = torch.clamp((phi * INV_2PI * nu).to(torch.int64), 0, nu - 1)
        iv = torch.clamp((theta * INV_PI * nv).to(torch.int64), 0, nv - 1)
        p2 = self.cond.func[iv, iu] / torch.clamp_min(self.marg.func_int, 1e-12)
        return p2 / (2.0 * PI * PI * torch.clamp_min(torch.sin(theta), 1e-6))

    def sample(self, p, u1, u2):
        """(wi, radiance, pdf, shadow-ray length)."""
        marg, cond = self.marg, self.cond
        nv, nu = cond.func.shape
        iv = _interval(marg.cdf.expand(u2.shape[0], -1), u2)
        c0, c1 = marg.cdf[iv], marg.cdf[iv + 1]
        v = (iv.to(u2.dtype) + (u2 - c0) / torch.clamp_min(c1 - c0, 1e-12)) / nv
        pdf_v = marg.func[iv] / torch.clamp_min(marg.func_int, 1e-12)
        rows = cond.cdf[iv]
        iu = _interval(rows, u1)
        c0 = rows.gather(1, iu[:, None])[:, 0]
        c1 = rows.gather(1, iu[:, None] + 1)[:, 0]
        u = (iu.to(u1.dtype) + (u1 - c0) / torch.clamp_min(c1 - c0, 1e-12)) / nu
        pdf_u = cond.func[iv, iu] / torch.clamp_min(cond.func_int[iv], 1e-12)
        theta, phi = v * PI, u * 2.0 * PI
        st = torch.sin(theta)
        wi = torch.stack([st * torch.cos(phi), st * torch.sin(phi), torch.cos(theta)], dim=-1)
        pdf = pdf_u * pdf_v / torch.clamp_min(2.0 * PI * PI * st, 1e-9)
        return wi, self.radiance(wi), pdf, torch.full_like(u1, 1.0e7)


class AreaLight:
    """A diffuse emitter over triangles (v0, v1, v2), each (A, 3), emitting
    on the side of cross(v1 - v0, v2 - v0)."""

    def __init__(self, v0, v1, v2, emit):
        self.v0, self.v1, self.v2, self.emit = v0, v1, v2, emit
        areas = 0.5 * torch.linalg.norm(cross(v1 - v0, v2 - v0).double(), dim=-1)
        self.area = areas.sum().to(v0.dtype)
        cdf = torch.cat([areas.new_zeros(1), torch.cumsum(areas, 0) / areas.sum()])
        self.cdf = cdf.to(v0.dtype)

    def sample(self, p, u1, u2, u3):
        k = _interval(self.cdf.expand(u3.shape[0], -1), u3)
        v0, v1, v2 = self.v0[k], self.v1[k], self.v2[k]
        su = torch.sqrt(u1)
        b0, b1 = 1.0 - su, u2 * su
        pl = b0[..., None] * v0 + b1[..., None] * v1 + (1.0 - b0 - b1)[..., None] * v2
        n = normalize(cross(v1 - v0, v2 - v0))
        vec = pl - p
        d2 = dot(vec, vec)
        dist = torch.sqrt(torch.clamp_min(d2, 1e-20))
        wi = vec / dist[..., None]
        cos_l = dot(n, -wi)
        pdf = d2 / torch.clamp_min(torch.abs(cos_l) * self.area, 1e-12)
        rad = torch.where((cos_l > 0.0)[..., None], self.emit, 0.0)
        return wi, rad, pdf, dist * (1.0 - 1e-3)

    def pdf(self, t, cos_at):
        return t * t / torch.clamp_min(torch.abs(cos_at) * self.area, 1e-12)
