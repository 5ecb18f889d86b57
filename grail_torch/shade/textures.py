"""Texture table (port of grail/shade/textures.py): the kinds `const`,
`scale`, `mix`, `bilerp`, `uv`, `checkerboard` (2D and 3D), `dots`, `fbm`,
`wrinkled`, `windy`, `marble` and `image`, with the uv, spherical,
cylindrical and planar mappings and the 3D identity mapping (through each
row's world-to-texture matrix).

The table is in topological order (a row's inputs come before it), so one
pass evaluates it. Image rows read the MIP pyramid with EWA where the shade
point carries uv screen differentials (camera hits), at zero width for a
non-uv mapping, and the finest level bilinearly otherwise, as the reference
does. Perlin noise (pbrt texture.cpp) gathers from the doubled permutation
table, kept as one tensor a device; its eight lattice corners are computed
side by side, each with the reference's arithmetic.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .. import telemetry
from ..core import transform as tr
from ..core.vecmath import (INV_PI, INV_TWOPI, PI, normalize, spherical_phi,
                            spherical_theta)
from .mipmap import lookup_ewa, lookup_trilinear


@dataclasses.dataclass(frozen=True)
class TexSpec:
    """Static description of one texture table row (same fields as grail)."""
    kind: str
    inputs: Tuple[int, ...] = ()
    mapping: str = "uv"
    su: float = 1.0
    sv: float = 1.0
    du: float = 0.0
    dv: float = 0.0
    v1: Tuple[float, float, float] = (1.0, 0.0, 0.0)
    v2: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    octaves: int = 8
    omega: float = 0.5
    aa: str = "closedform"
    dim: int = 2
    image_id: int = -1
    scale: float = 1.0
    variation: float = 0.2
    gamma: bool = False
    filt: str = "ewa"
    maxaniso: float = 8.0


# ------------------------------------------------------------------ Perlin noise
# pbrt texture.cpp NoisePerm (Ken Perlin's permutation), doubled
_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225, 140, 36,
    103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148, 247, 120, 234, 75, 0,
    26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32, 57, 177, 33, 88, 237, 149, 56,
    87, 174, 20, 125, 136, 171, 168, 68, 175, 74, 165, 71, 134, 139, 48, 27, 166,
    77, 146, 158, 231, 83, 111, 229, 122, 60, 211, 133, 230, 220, 105, 92, 41, 55,
    46, 245, 40, 244, 102, 143, 54, 65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132,
    187, 208, 89, 18, 169, 200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109,
    198, 173, 186, 3, 64, 52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126,
    255, 82, 85, 212, 207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183,
    170, 213, 119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172,
    9, 129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241, 81,
    51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157, 184, 84,
    204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93, 222, 114, 67,
    29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180], dtype=np.int64)
NOISE_PERM = np.concatenate([_PERM, _PERM])
_CORNERS = np.stack([np.arange(8) & 1, (np.arange(8) >> 1) & 1, (np.arange(8) >> 2) & 1])
_DEVICE_TABLES = {}     # (device, name) -> tensor, built once a device


def _table(name, device):
    """A constant table on `device`: "perm" the doubled permutation,
    "corners" the 8 lattice corners' (ox, oy, oz) (corner k = ox + 2·oy +
    4·oz), "marble" the spline's control colours."""
    key = (str(device), name)
    if key not in _DEVICE_TABLES:
        arr = {"perm": NOISE_PERM, "corners": _CORNERS, "marble": _MARBLE_C}[name]
        _DEVICE_TABLES[key] = torch.tensor(arr, device=device)
    return _DEVICE_TABLES[key]


def _grad(h, dx, dy, dz):
    """pbrt texture.cpp Grad: the hash's low bits pick the gradient from
    {±x±y, ±x±z, ±y±z}."""
    h = h & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    u = torch.where((h & 1) != 0, -u, u)
    v = torch.where((h & 2) != 0, -v, v)
    return u + v


def _noise_weight(t):
    """pbrt NoiseWeight: 6t^5 - 15t^4 + 10t^3."""
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def _lerp_pairs(w, wt):
    """w[..., 2k] + wt·(w[..., 2k+1] - w[..., 2k]) for every k."""
    a, b = w[..., 0::2], w[..., 1::2]
    return a + wt[..., None] * (b - a)


@telemetry.spanned("noise")
def noise(p):
    """Perlin noise at points p (..., 3): pbrt texture.cpp Noise(x, y, z), in
    [-1, 1]."""
    perm, off = _table("perm", p.device), _table("corners", p.device)
    fl = torch.floor(p)
    cell = fl.to(torch.int32).to(torch.int64) & 255      # two's complement, as int32
    pf = p - fl
    c = cell[..., None] + off                            # (..., 3, 8)
    h = perm[perm[perm[c[..., 0, :]] + c[..., 1, :]] + c[..., 2, :]]
    offf = off.to(p.dtype)
    w = _grad(h, pf[..., 0, None] - offf[0], pf[..., 1, None] - offf[1],
              pf[..., 2, None] - offf[2])                # (..., 8)
    x = _lerp_pairs(w, _noise_weight(pf[..., 0]))       # x00 x10 x01 x11
    y = _lerp_pairs(x, _noise_weight(pf[..., 1]))       # y0 y1
    return _lerp_pairs(y, _noise_weight(pf[..., 2]))[..., 0]


def fbm(p, omega, max_octaves):
    """Fractional Brownian motion (pbrt texture.cpp FBm) over every octave
    (no differentials clamp the count, as in the reference). lam and o stay
    Python floats, folded into float32 at each multiply."""
    total = p.new_zeros(p.shape[:-1])
    lam, o = 1.0, 1.0
    for _ in range(max_octaves):
        total = total + o * noise(lam * p)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p, omega, max_octaves):
    """pbrt texture.cpp Turbulence: the sum of |noise| over the octaves."""
    total = p.new_zeros(p.shape[:-1])
    lam, o = 1.0, 1.0
    for _ in range(max_octaves):
        total = total + o * torch.abs(noise(lam * p))
        lam *= 1.99
        o *= omega
    return total


# ---------------------------------------------------------------------- mappings
def apply_mapping(spec: TexSpec, w2t, sg):
    """(s, t) texture coordinates of a row (pbrt's TextureMapping2D classes);
    w2t: the row's world-to-texture matrix."""
    if spec.mapping == "uv":
        return (spec.su * sg["uv"][..., 0] + spec.du,
                spec.sv * sg["uv"][..., 1] + spec.dv)
    if spec.mapping == "spherical":
        vec = normalize(tr.xform_p(w2t, sg["p"]))
        s = spherical_theta(vec) * INV_PI
        t = spherical_phi(vec) * INV_TWOPI
    elif spec.mapping == "cylindrical":
        vec = normalize(tr.xform_p(w2t, sg["p"]))
        s = (PI + torch.atan2(vec[..., 1], vec[..., 0])) * INV_TWOPI
        t = vec[..., 2]
    elif spec.mapping == "planar":
        p = sg["p"]
        v1, v2 = spec.v1, spec.v2
        return (spec.du + (p[..., 0] * v1[0] + p[..., 1] * v1[1] + p[..., 2] * v1[2]),
                spec.dv + (p[..., 0] * v2[0] + p[..., 1] * v2[1] + p[..., 2] * v2[2]))
    else:
        raise ValueError(f"unknown 2d mapping {spec.mapping}")
    return spec.su * s + spec.du, spec.sv * t + spec.dv


def mapped_p3(w2t, sg):
    """The 3D identity mapping: world -> texture point (IdentityMapping3D)."""
    return tr.xform_p(w2t, sg["p"])


# ----------------------------------------------------------------- evaluation
def rows_closure(tex_specs, rows):
    """The transitive input closure of texture rows (host side)."""
    needed = set()
    stack = [r for r in rows if r >= 0]
    while stack:
        r = stack.pop()
        if r in needed:
            continue
        needed.add(r)
        stack.extend(tex_specs[r].inputs)
    return frozenset(needed)


def _grey(x):
    return x[..., None].expand(*x.shape, 3)


def _eval_row(spec, w2t, const, vals, sg, images, mipmaps, n):
    """One row's (N, 3) value; vals holds the rows before it."""
    kind = spec.kind
    if kind == "const":
        return const.expand(n, 3)
    if kind == "scale":
        return vals[spec.inputs[0]] * vals[spec.inputs[1]]
    if kind == "mix":
        amt = vals[spec.inputs[2]][..., :1]     # the amount is a float texture
        return (1.0 - amt) * vals[spec.inputs[0]] + amt * vals[spec.inputs[1]]
    if kind == "bilerp":
        s, t = apply_mapping(spec, w2t, sg)
        v00, v01, v10, v11 = (vals[i] for i in spec.inputs)
        ss, tt = s[..., None], t[..., None]
        return ((1 - ss) * (1 - tt) * v00 + (1 - ss) * tt * v01
                + ss * (1 - tt) * v10 + ss * tt * v11)
    if kind == "uv":
        s, t = apply_mapping(spec, w2t, sg)
        return torch.stack([s - torch.floor(s), t - torch.floor(t),
                            torch.zeros_like(s)], dim=-1)
    if kind == "checkerboard":
        # float `%` is floor-mod in both packages (never fmod)
        if spec.dim == 2:
            s, t = apply_mapping(spec, w2t, sg)
            even = (torch.floor(s) + torch.floor(t)) % 2.0 == 0.0
        else:
            pl = mapped_p3(w2t, sg)
            even = (torch.floor(pl[..., 0]) + torch.floor(pl[..., 1])
                    + torch.floor(pl[..., 2])) % 2.0 == 0.0
        return torch.where(even[..., None], vals[spec.inputs[0]], vals[spec.inputs[1]])
    if kind == "dots":
        # pbrt dots.h: a dot's presence, centre and radius hashed a cell by Noise
        s, t = apply_mapping(spec, w2t, sg)
        scell = torch.floor(s + 0.5)
        tcell = torch.floor(t + 0.5)
        zero = torch.zeros_like(s)
        has_dot = noise(torch.stack([scell + 0.5, tcell + 0.5, zero], dim=-1)) > 0.0
        cs = scell + 0.35 * noise(torch.stack([scell + 1.5, tcell + 2.8, zero], dim=-1))
        ct = tcell + 0.35 * noise(torch.stack([scell + 4.5, tcell + 9.8, zero], dim=-1))
        inside = has_dot & (((s - cs) ** 2 + (t - ct) ** 2) < 0.35 * 0.35)
        return torch.where(inside[..., None], vals[spec.inputs[0]], vals[spec.inputs[1]])
    if kind == "fbm":
        return _grey(fbm(mapped_p3(w2t, sg), spec.omega, spec.octaves))
    if kind == "wrinkled":
        return _grey(turbulence(mapped_p3(w2t, sg), spec.omega, spec.octaves))
    if kind == "windy":
        pl = mapped_p3(w2t, sg)
        return _grey(torch.abs(fbm(0.1 * pl, 0.5, 3)) * fbm(pl, 0.5, 6))
    if kind == "marble":
        pl = mapped_p3(w2t, sg) * spec.scale
        marble = pl[..., 1] + spec.variation * fbm(pl, spec.omega, spec.octaves)
        return _marble_spline(0.5 + 0.5 * torch.sin(marble))
    if kind == "image":
        s, t = apply_mapping(spec, w2t, sg)
        return image_lookup(spec, images, mipmaps, sg, s, t)
    raise ValueError(f"unknown texture kind {kind}")


@telemetry.spanned("textures")
def eval_textures(tex_specs, tex_data, sg, images=(), mipmaps=()):
    """Evaluate the texture table at shade points: (NT, N, 3). Float
    textures use channel 0 (stored replicated)."""
    n = sg["p"].shape[0]
    vals = []
    for row, spec in enumerate(tex_specs):
        vals.append(_eval_row(spec, tex_data["w2t"][row], tex_data["const"][row],
                              vals, sg, images, mipmaps, n))
    if not vals:
        return sg["p"].new_zeros((0, n, 3))
    return torch.stack(vals, dim=0)


def eval_texture_rows(tex_specs, tex_data, sg, rows, images=(), mipmaps=()):
    """Evaluate `rows` and their inputs only: {row: (N, 3)} over the rows'
    closure, each row as eval_textures computes it. Without mipmaps (the
    reference's eval_texture_rows) image rows read bilinearly; with them
    (the reference's eval_textures(needed=, as_dict=True)) they filter as
    in eval_textures."""
    needed = rows_closure(tex_specs, rows)
    n = sg["p"].shape[0]
    vals = {}
    for row in sorted(needed):
        vals[row] = _eval_row(tex_specs[row], tex_data["w2t"][row],
                              tex_data["const"][row], vals, sg, images, mipmaps, n)
    return vals


# pbrt marble.h's agate spline control colours
_MARBLE_C = np.array([
    [0.58, 0.58, 0.6], [0.58, 0.58, 0.6], [0.58, 0.58, 0.6],
    [0.5, 0.5, 0.5], [0.6, 0.59, 0.58], [0.58, 0.58, 0.6],
    [0.58, 0.58, 0.6], [0.2, 0.2, 0.33], [0.58, 0.58, 0.6]], dtype=np.float32)


def _marble_spline(t):
    """pbrt marble's chain of cubic Bezier segments over the control colours,
    at t in [0, 1]."""
    c = _table("marble", t.device)
    nseg = _MARBLE_C.shape[0] - 3
    tt = torch.clamp(t, 0.0, 0.9999) * nseg
    first = torch.floor(tt).to(torch.int64)
    tloc = tt - first.to(torch.float32)
    c0, c1, c2, c3 = (c[first + k] for k in range(4))
    s0 = (1 - tloc)[..., None]
    s1 = tloc[..., None]
    a0 = s0 * c0 + s1 * c1
    a1 = s0 * c1 + s1 * c2
    a2 = s0 * c2 + s1 * c3
    b0 = s0 * a0 + s1 * a1
    b1 = s0 * a1 + s1 * a2
    return 1.5 * (s0 * b0 + s1 * b1)


def image_lookup(spec, images, mipmaps, sg, s, t):
    """ImageTexture::Evaluate: EWA (or trilinear) over the MIP pyramid where
    sg has uv differentials (through the uv mapping; a non-uv mapping at
    zero width), else finest-level bilinear."""
    duvdx = sg.get("duvdx")
    if (not (0 <= spec.image_id < len(mipmaps)) or duvdx is None
            or spec.filt == "bilinear"):
        return image_bilinear(images[spec.image_id], s, t)
    pyr = mipmaps[spec.image_id]
    if spec.mapping == "uv":
        # (s, t) derivatives through the uv mapping (UVMapping2D::Map)
        ds0 = spec.su * duvdx[:, 0]
        dt0 = spec.sv * duvdx[:, 1]
        ds1 = spec.su * sg["duvdy"][:, 0]
        dt1 = spec.sv * sg["duvdy"][:, 1]
    else:
        ds0 = dt0 = ds1 = dt1 = torch.zeros_like(s)
    if spec.filt == "trilinear":
        width = torch.maximum(torch.maximum(torch.abs(ds0), torch.abs(dt0)),
                              torch.maximum(torch.abs(ds1), torch.abs(dt1)))
        return lookup_trilinear(pyr, s, t, 2.0 * width)
    return lookup_ewa(pyr, s, t, ds0, dt0, ds1, dt1, spec.maxaniso)


def image_bilinear(img, s, t):
    """Bilinear image lookup with repeat wrap (the width-0 MIPMap lookup)."""
    h, w = img.shape[0], img.shape[1]
    x = s * w - 0.5
    y = t * h - 0.5
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = (x - x0.to(torch.float32))[..., None]
    fy = (y - y0.to(torch.float32))[..., None]
    x0 = x0 % w
    x1 = (x0 + 1) % w
    y0 = y0 % h
    y1 = (y0 + 1) % h
    flat = img.reshape(-1, img.shape[-1])
    v00 = flat[y0 * w + x0]
    v01 = flat[y1 * w + x0]
    v10 = flat[y0 * w + x1]
    v11 = flat[y1 * w + x1]
    return ((1 - fx) * (1 - fy) * v00 + (1 - fx) * fy * v01
            + fx * (1 - fy) * v10 + fx * fy * v11)
