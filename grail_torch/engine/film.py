"""Film accumulation and develop (port of grail/engine/film.py).

The film is a dict {rgb (H,W,3), weight (H,W), splat (H,W,3)}. Full-grid
waves accumulate with dense shifted adds (no scatter), wave by wave in sample
order, so the film is bitwise independent of how the samples are chunked.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import filters as flt

TILE_H, TILE_W = 8, 16   # lane-order pixel tile (the reference's 128-ray packet)


def new_film(xres, yres, device):
    return {
        "rgb": torch.zeros((yres, xres, 3), dtype=torch.float32, device=device),
        "weight": torch.zeros((yres, xres), dtype=torch.float32, device=device),
        "splat": torch.zeros((yres, xres, 3), dtype=torch.float32, device=device),
    }


def tiled_order(meta):
    """True when waves use the 8x16 tiled pixel order (see lane_pixel): only
    for resolutions that tile exactly."""
    return meta.xres % TILE_W == 0 and meta.yres % TILE_H == 0


def lane_pixel(lane, xres):
    """Tiled lane -> (px, py): lane i sits in tile i//128, offset i%128."""
    tiles_x = xres // TILE_W
    tile = lane // (TILE_H * TILE_W)
    within = lane % (TILE_H * TILE_W)
    ty = tile // tiles_x
    tx = tile % tiles_x
    py = ty * TILE_H + within // TILE_W
    px = tx * TILE_W + within % TILE_W
    return px.to(torch.int32), py.to(torch.int32)


def _untile(x, yres, xres):
    """Lane-ordered (H*W, ...) in tile order -> image-ordered (H, W, ...)."""
    rest = x.shape[1:]
    x = x.reshape(yres // TILE_H, xres // TILE_W, TILE_H, TILE_W, *rest)
    x = torch.swapaxes(x, 1, 2)
    return x.reshape(yres, xres, *rest)


def _add_shifted(acc, a, dy, dx):
    """acc[y, x] + a[y-dy, x-dx], with a zero where the source lies outside
    the image: the reference's add of a zero-padded shifted copy. Out of
    place, so gradients flow back through the film."""
    h, w = a.shape[0], a.shape[1]
    src = a[max(-dy, 0):h - max(dy, 0), max(-dx, 0):w - max(dx, 0)]
    pad = (0, 0) * (a.dim() - 2) + (max(dx, 0), max(-dx, 0), max(dy, 0), max(-dy, 0))
    return acc + F.pad(src, pad)


def add_samples_grid(film, fcfg: flt.FilterConfig, sx, sy, L, chunk,
                     weight=None, tiled=False):
    """AddSample for full-grid waves: lane i carries pixel i % (H*W), tiled
    `chunk` times (sample-major), in raster or 8x16 tile order. Each static
    tap offset around the lane's own pixel becomes a shifted dense add.
    Returns a new film; the one passed in is left as it was."""
    yres, xres = film["weight"].shape
    dimx = sx - 0.5
    dimy = sy - 0.5
    px = torch.floor(sx)
    py = torch.floor(sy)
    rx = int(math.floor(fcfg.xwidth + 0.5))
    ry = int(math.floor(fcfg.ywidth + 0.5))
    if weight is None:
        weight = torch.ones_like(sx)

    def to_image(x):
        if tiled:
            return _untile(x, yres, xres)
        return x.reshape(yres, xres, *x.shape[1:])

    rgb, wsum = film["rgb"], film["weight"]
    for c in range(chunk):
        sl = slice(c * yres * xres, (c + 1) * yres * xres)
        for dy in range(-ry, ry + 1):
            for dx in range(-rx, rx + 1):
                w = flt.evaluate(fcfg, px[sl] + dx - dimx[sl],
                                 py[sl] + dy - dimy[sl]) * weight[sl]
                rgb = _add_shifted(rgb, to_image(w[..., None] * L[sl]), dy, dx)
                wsum = _add_shifted(wsum, to_image(w), dy, dx)
    return {"rgb": rgb, "weight": wsum, "splat": film["splat"]}


def develop(film, splat_scale=1.0):
    """ImageFilm::WriteImage math: rgb/weight + splatScale*splat, clamp
    negatives."""
    w = torch.clamp_min(film["weight"], 1e-9)[..., None]
    img = film["rgb"] / w + splat_scale * film["splat"]
    return torch.clamp_min(img, 0.0)
