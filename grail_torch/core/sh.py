"""Real spherical harmonics (port of grail/core/sh.py; pbrt src/core/sh.{h,cpp}:
SHTerms, SHIndex, SHEvaluate, SHConvolveCosTheta, SHConvolvePhong,
SHReduceRinging, SHRotateZ) over batched tensors.

The associated-Legendre recurrence runs as static Python loops over (l, m),
so every direction of the batch is evaluated at once with no control flow
on the device. Constants are Python floats, computed in the reference's
order of operations, so that float32 values agree. pbrt's general SHRotate
is replaced, as in the reference, by evaluating a convolved expansion in
the world frame (exact for radially symmetric kernels); only the rotation
about z is kept.
"""
from __future__ import annotations

import math

import torch

from .vecmath import normalize


def sh_terms(lmax: int) -> int:
    """pbrt SHTerms: (lmax+1)^2 coefficients through band lmax."""
    return (lmax + 1) * (lmax + 1)


def sh_index(l: int, m: int) -> int:
    """pbrt SHIndex: flat index of band l, order m (m in [-l, l])."""
    return l * l + l + m


def _k(l: int, m: int) -> float:
    """Normalization K(l,m) = sqrt((2l+1)/(4pi) * (l-|m|)!/(l+|m|)!)."""
    m = abs(m)
    return math.sqrt((2 * l + 1) / (4 * math.pi)
                     * math.factorial(l - m) / math.factorial(l + m))


def sh_evaluate(w, lmax: int):
    """Y_i(w) for every basis function through band lmax: w (..., 3)
    directions (normalized again here), returns (..., sh_terms(lmax)).
    Condon-Shortley-phased associated Legendre with the sin^m factor folded
    in, times sqrt(2) K cos/sin(m phi) from an angle-addition recurrence
    (pbrt SHEvaluate)."""
    w = normalize(w)
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))

    P = {}
    pmm = torch.ones_like(z)
    for m in range(lmax + 1):
        if m > 0:
            pmm = pmm * (-(2 * m - 1)) * s   # P_m^m = (-1)^m (2m-1)!! sin^m
        P[(m, m)] = pmm
        if m + 1 <= lmax:
            P[(m, m + 1)] = z * (2 * m + 1) * pmm
        for l in range(m + 2, lmax + 1):
            P[(m, l)] = ((2 * l - 1) * z * P[(m, l - 1)]
                         - (l + m - 1) * P[(m, l - 2)]) / (l - m)

    # cos(m phi), sin(m phi) from the unit-circle projection (x/s, y/s); at
    # the poles P carries a sin^m factor that is 0 for m > 0
    safe_s = torch.where(s < 1e-12, 1.0, s)
    cx = x / safe_s
    cy = y / safe_s
    cos_m = [torch.ones_like(z), cx]
    sin_m = [torch.zeros_like(z), cy]
    for m in range(2, lmax + 1):
        cos_m.append(cos_m[-1] * cx - sin_m[-1] * cy)
        sin_m.append(sin_m[-1] * cx + cos_m[-2] * cy)

    out = [None] * sh_terms(lmax)
    sqrt2 = math.sqrt(2.0)
    for l in range(lmax + 1):
        out[sh_index(l, 0)] = _k(l, 0) * P[(0, l)]
        for m in range(1, l + 1):
            klm = _k(l, m)
            out[sh_index(l, m)] = sqrt2 * klm * cos_m[m] * P[(m, l)]
            out[sh_index(l, -m)] = sqrt2 * klm * sin_m[m] * P[(m, l)]
    return torch.stack(out, dim=-1)


def _cos_theta_zh(lmax: int):
    """Zonal-harmonic coefficients A_l of the clamped cosine (Ramamoorthi and
    Hanrahan; the band weights of pbrt SHConvolveCosTheta)."""
    A = []
    for l in range(lmax + 1):
        if l == 0:
            A.append(math.pi)
        elif l == 1:
            A.append(2.0 * math.pi / 3.0)
        elif l % 2 == 1:
            A.append(0.0)
        else:
            h = l // 2
            A.append(2.0 * math.pi * ((-1.0) ** (h + 1)) / ((l + 2) * (l - 1))
                     * math.factorial(l)
                     / (2.0 ** l * math.factorial(h) ** 2))
    return A


def _band_scale(c_in, per_band):
    """Scale coefficients c_in (..., terms, C) by a per-band factor list."""
    lmax = len(per_band) - 1
    scale = torch.tensor([per_band[l] for l in range(lmax + 1) for _ in range(2 * l + 1)],
                         dtype=torch.float32, device=c_in.device)
    return c_in * scale[:, None]


def sh_convolve_cos_theta(lmax: int, c_in):
    """Convolve an incident-radiance expansion (..., terms, C) with the
    clamped cosine (pbrt SHConvolveCosTheta): evaluated at n it gives the
    irradiance E(n); constant unit radiance gives pi."""
    return _band_scale(c_in, _cos_theta_zh(lmax))


def sh_convolve_phong(lmax: int, n: float, c_in):
    """Convolve with a normalized Phong lobe of exponent n (pbrt
    SHConvolvePhong): band attenuation exp(-l^2/(2n)), unit DC gain."""
    return _band_scale(c_in, [math.exp(-l * l / (2.0 * n)) for l in range(lmax + 1)])


def sh_reduce_ringing(c_in, lmax: int, lam: float = 0.005):
    """pbrt SHReduceRinging: band l windowed by 1/(1 + lam (l(l+1))^2)."""
    return _band_scale(c_in, [1.0 / (1.0 + lam * (l * (l + 1.0)) ** 2)
                              for l in range(lmax + 1)])


def sh_rotate_z(c_in, lmax: int, alpha: float):
    """Rotation about z (pbrt SHRotateZ): each (m, -m) coefficient pair of
    c_in (..., terms, C) rotated by m alpha."""
    out = [None] * sh_terms(lmax)
    for l in range(lmax + 1):
        out[sh_index(l, 0)] = c_in[..., sh_index(l, 0), :]
        for m in range(1, l + 1):
            ca = math.cos(m * alpha)
            sa = math.sin(m * alpha)
            cp = c_in[..., sh_index(l, m), :]
            cn = c_in[..., sh_index(l, -m), :]
            out[sh_index(l, m)] = ca * cp - sa * cn
            out[sh_index(l, -m)] = sa * cp + ca * cn
    return torch.stack(out, dim=-2)
