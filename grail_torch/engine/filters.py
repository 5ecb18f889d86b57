"""Reconstruction filters (port of grail/engine/filters.py)."""
from __future__ import annotations

import dataclasses

import torch

from ..core.vecmath import PI

BOX = 0
TRIANGLE = 1
GAUSSIAN = 2
MITCHELL = 3
SINC = 4

_NAMES = {"box": BOX, "triangle": TRIANGLE, "gaussian": GAUSSIAN,
          "mitchell": MITCHELL, "sinc": SINC}


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    kind: int = BOX
    xwidth: float = 0.5
    ywidth: float = 0.5
    alpha: float = 2.0        # gaussian
    b: float = 1.0 / 3.0      # mitchell B
    c: float = 1.0 / 3.0      # mitchell C
    tau: float = 3.0          # sinc

    @staticmethod
    def from_name(name, **kw):
        defaults = {"box": 0.5, "triangle": 2.0, "gaussian": 2.0,
                    "mitchell": 2.0, "sinc": 4.0}
        kind = _NAMES[name]
        w = defaults[name]
        kw.setdefault("xwidth", w)
        kw.setdefault("ywidth", w)
        return FilterConfig(kind=kind, **kw)


def _mitchell_1d(x, B, C):
    x = torch.abs(2.0 * x)
    big = ((-B - 6 * C) * x ** 3 + (6 * B + 30 * C) * x ** 2
           + (-12 * B - 48 * C) * x + (8 * B + 24 * C)) * (1.0 / 6.0)
    small = ((12 - 9 * B - 6 * C) * x ** 3 + (-18 + 12 * B + 6 * C) * x ** 2
             + (6 - 2 * B)) * (1.0 / 6.0)
    return torch.where(x > 1.0, torch.where(x < 2.0, big, 0.0), small)


def _sinc_1d(x, tau):
    x = torch.abs(x)
    s = torch.where(x < 1e-5, 1.0, torch.sin(PI * x * tau) / (PI * x * tau))
    lanc = torch.where(x < 1e-5, 1.0, torch.sin(PI * x) / (PI * x))
    return torch.where(x > 1.0, 0.0, s * lanc)


def evaluate(cfg: FilterConfig, dx, dy):
    """Filter::Evaluate at offsets (dx, dy) from the sample (pixels). The
    extent test is inclusive (|dx| <= xwidth), as the reference: a box-filter
    sample exactly on a pixel border also lands in the neighbour."""
    inside = (torch.abs(dx) <= cfg.xwidth) & (torch.abs(dy) <= cfg.ywidth)
    if cfg.kind == BOX:
        w = torch.ones_like(dx)
    elif cfg.kind == TRIANGLE:
        w = (torch.clamp_min(cfg.xwidth - torch.abs(dx), 0.0)
             * torch.clamp_min(cfg.ywidth - torch.abs(dy), 0.0))
    elif cfg.kind == GAUSSIAN:
        expx = torch.exp(torch.tensor(-cfg.alpha * cfg.xwidth * cfg.xwidth))
        expy = torch.exp(torch.tensor(-cfg.alpha * cfg.ywidth * cfg.ywidth))
        gx = torch.clamp_min(torch.exp(-cfg.alpha * dx * dx) - expx, 0.0)
        gy = torch.clamp_min(torch.exp(-cfg.alpha * dy * dy) - expy, 0.0)
        w = gx * gy
    elif cfg.kind == MITCHELL:
        w = (_mitchell_1d(dx / cfg.xwidth, cfg.b, cfg.c)
             * _mitchell_1d(dy / cfg.ywidth, cfg.b, cfg.c))
    elif cfg.kind == SINC:
        w = _sinc_1d(dx / cfg.xwidth, cfg.tau) * _sinc_1d(dy / cfg.ywidth, cfg.tau)
    else:
        raise ValueError(f"unknown filter {cfg.kind}")
    return torch.where(inside, w, 0.0)
