"""MIP pyramids and their lookups (port of grail/shade/mipmap.py: the
Lanczos pow2 resample and pyramid build on the host, trilinear and EWA
lookups on the device).

As in the reference, the EWA ellipse is sampled with a fixed 4x4 tap grid
over its bounding box with Gaussian weights, and wrap mode is repeat.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.vecmath import safe_sqrt


def lanczos(x, tau=2.0):
    x = np.abs(x)
    s = np.where(x < 1e-6, 1.0, np.sin(math.pi * x) / (math.pi * x))
    lz = np.where(x < 1e-6, 1.0, np.sin(math.pi * x / tau) / (math.pi * x / tau))
    return np.where(x >= tau, 0.0, s * lz)


def _resample_weights(old_n, new_n, tau=2.0):
    """pbrt MIPMap::resampleWeights: 4-tap Lanczos weights per new texel."""
    origin = (np.arange(new_n) + 0.5) * old_n / new_n
    first = np.floor(origin - tau + 0.5).astype(np.int64)
    offs = first[:, None] + np.arange(4)[None, :]
    w = lanczos((offs + 0.5 - origin[:, None]) / tau)
    w = w / np.maximum(w.sum(1, keepdims=True), 1e-9)
    return np.clip(offs, 0, old_n - 1), w


def _next_pow2(n):
    return 1 << max(0, (n - 1).bit_length())


def build_pyramid(img):
    """(H,W,3) float image -> list of levels [finest .. 1x1], pow2 resampled."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    ph, pw = _next_pow2(h), _next_pow2(w)
    if (ph, pw) != (h, w):
        idx, wt = _resample_weights(w, pw)
        img = (img[:, idx] * wt[None, :, :, None]).sum(2)
        idx, wt = _resample_weights(h, ph)
        img = (img[idx] * wt[:, :, None, None]).sum(1)
    levels = [img.astype(np.float32)]
    while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
        cur = levels[-1]
        h, w = cur.shape[:2]
        fh, fw = (2 if h > 1 else 1), (2 if w > 1 else 1)
        nh, nw = h // fh, w // fw
        cur = cur[: nh * fh, : nw * fw]
        levels.append(cur.reshape(nh, fh, nw, fw, -1).mean((1, 3)))
    return levels


def pack_pyramid(levels):
    """All levels flattened into one (S,C) array with per-level offsets and
    sizes (numpy; n_levels a Python int)."""
    flat = np.concatenate([np.asarray(lv, np.float32).reshape(-1, lv.shape[-1])
                           for lv in levels])
    hs = np.asarray([lv.shape[0] for lv in levels], np.int32)
    ws = np.asarray([lv.shape[1] for lv in levels], np.int32)
    offs = np.concatenate([[0], np.cumsum(hs.astype(np.int64) * ws)[:-1]]).astype(np.int32)
    return {"flat": flat, "h": hs, "w": ws, "off": offs, "n_levels": len(levels)}


def _bilinear_level(pyr, l_idx, s, t):
    """Repeat-wrapped bilinear fetch at per-lane integer level l_idx."""
    l_idx = l_idx.to(torch.int64)
    h = pyr["h"][l_idx].to(torch.int64)
    w = pyr["w"][l_idx].to(torch.int64)
    off = pyr["off"][l_idx].to(torch.int64)
    x = s * w.to(torch.float32) - 0.5
    y = t * h.to(torch.float32) - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0m = torch.remainder(x0, w)
    x1m = torch.remainder(x0 + 1, w)
    y0m = torch.remainder(y0, h)
    y1m = torch.remainder(y0 + 1, h)
    flat = pyr["flat"]
    c00 = flat[off + y0m * w + x0m]
    c01 = flat[off + y0m * w + x1m]
    c10 = flat[off + y1m * w + x0m]
    c11 = flat[off + y1m * w + x1m]
    return ((1 - fy) * ((1 - fx) * c00 + fx * c01)
            + fy * ((1 - fx) * c10 + fx * c11))


def lookup_trilinear(pyr, s, t, width):
    """MIPMap::Lookup(s,t,width): level = nLevels-1 + log2(width), lerp
    between the two bracketing levels."""
    n_levels = pyr["n_levels"]
    s = torch.remainder(s, 1.0)
    t = torch.remainder(t, 1.0)
    lvl = (n_levels - 1) + torch.log2(torch.clamp_min(width, 1e-8))
    lvl = torch.clamp(lvl, 0.0, n_levels - 1)
    l0 = torch.floor(lvl)
    frac = (lvl - l0)[..., None]
    i0 = l0.to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, n_levels - 1)
    return ((1.0 - frac) * _bilinear_level(pyr, i0, s, t)
            + frac * _bilinear_level(pyr, i1, s, t))


_EWA_TAPS = 4      # fixed 4x4 tap grid over the ellipse bounding box


def lookup_ewa(pyr, s, t, ds0, dt0, ds1, dt1, maxaniso=8.0):
    """MIPMap::Lookup(s,t,ds0,dt0,ds1,dt1): EWA over a static tap grid. The
    level comes from the minor axis after the maxaniso clamp; weights are the
    Gaussian falloff (alpha 2), normalized."""
    n_levels = pyr["n_levels"]
    len0 = safe_sqrt(ds0 * ds0 + dt0 * dt0)
    len1 = safe_sqrt(ds1 * ds1 + dt1 * dt1)
    major = torch.maximum(len0, len1)
    minor = torch.minimum(len0, len1)
    scale = torch.where(minor * maxaniso < major,
                        major / torch.clamp_min(minor * maxaniso, 1e-12), 1.0)
    minor = minor * scale
    lvl = (n_levels - 1) + torch.log2(torch.clamp_min(minor, 1e-8))
    lvl = torch.clamp(lvl, 0.0, n_levels - 1)
    l0 = torch.floor(lvl)

    # ellipse implicit coefficients
    A = dt0 * dt0 + dt1 * dt1 + 1e-10
    B = -2.0 * (ds0 * dt0 + ds1 * dt1)
    C = ds0 * ds0 + ds1 * ds1 + 1e-10
    F = A * C - B * B * 0.25
    # a degenerate ellipse (1/F overflows: F is 0 by cancellation) has
    # infinite coefficients, so no tap weight, and would have a NaN gradient:
    # it takes the fallback with finite stand-in coefficients
    proper = torch.isfinite(1.0 / F.detach())
    invF = 1.0 / torch.where(proper, F, 1.0)
    A_, B_, C_ = A * invF, B * invF, C * invF
    det = -B_ * B_ + 4.0 * A_ * C_
    u_r = safe_sqrt(C_ * 4.0 / torch.clamp_min(det, 1e-12))
    v_r = safe_sqrt(A_ * 4.0 / torch.clamp_min(det, 1e-12))
    u_r = torch.clamp_max(u_r, 0.5)
    v_r = torch.clamp_max(v_r, 0.5)

    taps = [(k + 0.5) / _EWA_TAPS * 2.0 - 1.0 for k in range(_EWA_TAPS)]
    li = l0.to(torch.int64)
    acc = wsum = 0.0
    for tu in taps:
        for tv in taps:
            du = tu * u_r
            dv = tv * v_r
            r2 = A_ * du * du + B_ * du * dv + C_ * dv * dv
            w = torch.where(proper & (r2 < 1.0),
                            torch.exp(-2.0 * r2) - math.exp(-2.0), 0.0)
            val = _bilinear_level(pyr, li, torch.remainder(s + du, 1.0),
                                  torch.remainder(t + dv, 1.0))
            w = torch.clamp_min(w, 0.0)[..., None]
            acc = acc + val * w
            wsum = wsum + w
    fallback = lookup_trilinear(pyr, s, t, 2.0 ** (lvl - (n_levels - 1)))
    return torch.where(wsum > 1e-8, acc / torch.clamp_min(wsum, 1e-8), fallback)
