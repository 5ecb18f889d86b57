"""Texture table (port of grail/shade/textures.py, `const` rows only)."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


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


def eval_textures(tex_specs, tex_data, sg):
    """Evaluate the texture table at shade points: (NT, N, 3). Float
    textures use channel 0 (stored replicated)."""
    n = sg["p"].shape[0]
    vals = []
    for row, spec in enumerate(tex_specs):
        if spec.kind != "const":
            raise NotImplementedError(
                f"texture kind {spec.kind!r} is not ported yet (const only)")
        vals.append(tex_data["const"][row].expand(n, 3))
    if not vals:
        return sg["p"].new_zeros((0, n, 3))
    return torch.stack(vals, dim=0)
