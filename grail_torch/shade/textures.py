"""Texture table (port of grail/shade/textures.py: `const`, `scale` and
`mix` rows, and `image` rows with the `uv` mapping). The table is in
topological order (a row's inputs come before it), so one pass evaluates
it. Image rows read the MIP pyramid with EWA where
the shade point carries uv screen differentials (camera hits) and the finest
level bilinearly otherwise, as the reference does."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

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


def apply_mapping(spec: TexSpec, sg):
    """(s, t) texture coordinates of the `uv` mapping (UVMapping2D)."""
    if spec.mapping != "uv":
        raise NotImplementedError(f"texture mapping {spec.mapping!r} is not "
                                  "ported yet (uv only)")
    return (spec.su * sg["uv"][..., 0] + spec.du,
            spec.sv * sg["uv"][..., 1] + spec.dv)


def eval_textures(tex_specs, tex_data, sg, images=(), mipmaps=()):
    """Evaluate the texture table at shade points: (NT, N, 3). Float
    textures use channel 0 (stored replicated)."""
    n = sg["p"].shape[0]
    vals = []
    for row, spec in enumerate(tex_specs):
        if spec.kind == "const":
            vals.append(tex_data["const"][row].expand(n, 3))
        elif spec.kind == "scale":
            vals.append(vals[spec.inputs[0]] * vals[spec.inputs[1]])
        elif spec.kind == "mix":
            amt = vals[spec.inputs[2]][..., :1]     # the amount is a float texture
            vals.append((1.0 - amt) * vals[spec.inputs[0]] + amt * vals[spec.inputs[1]])
        elif spec.kind == "image":
            s, t = apply_mapping(spec, sg)
            vals.append(image_lookup(spec, images, mipmaps, sg, s, t))
        else:
            raise NotImplementedError(
                f"texture kind {spec.kind!r} is not ported yet "
                "(const, scale, mix, image)")
    if not vals:
        return sg["p"].new_zeros((0, n, 3))
    return torch.stack(vals, dim=0)


def image_lookup(spec, images, mipmaps, sg, s, t):
    """ImageTexture::Evaluate: EWA (or trilinear) over the MIP pyramid with
    the uv differentials where sg has them, else finest-level bilinear."""
    duvdx = sg.get("duvdx")
    if (not (0 <= spec.image_id < len(mipmaps)) or duvdx is None
            or spec.filt == "bilinear"):
        return image_bilinear(images[spec.image_id], s, t)
    pyr = mipmaps[spec.image_id]
    # (s, t) derivatives through the uv mapping (UVMapping2D::Map)
    ds0 = spec.su * duvdx[:, 0]
    dt0 = spec.sv * duvdx[:, 1]
    ds1 = spec.su * sg["duvdy"][:, 0]
    dt1 = spec.sv * sg["duvdy"][:, 1]
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
