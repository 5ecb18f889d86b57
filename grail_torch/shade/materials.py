"""Material table -> per-shade-point lobe stacks (port of
grail/shade/materials.py)."""
from __future__ import annotations

import torch

from .. import telemetry

CONV_ID = 0
CONV_INV = 1        # exponent = 1/roughness
CONV_RADIANS = 2    # sigma degrees -> radians

MAT_FIELDS = ("lobe_type", "fr", "s0", "s1", "s2", "f0", "f1", "f2",
              "f0_conv", "f1_conv")


@telemetry.spanned("textures_lobes")
def gather_lobes(scene, sg, tex_values):
    """Materialize per-shade-point lobe stacks from the material table.
    tex_values (NT, N, 3) from eval_textures. The reference picks each lane's
    texture row by a one-hot contraction; a gather reads the same value."""
    mats = scene["materials"]
    mid = torch.clamp_min(sg["mat"], 0)

    def row(key):
        return mats[key][mid]                              # (N,K)

    tvt = torch.swapaxes(tex_values, 0, 1)                  # (N,NT,3)
    lane = torch.arange(tvt.shape[0], device=tvt.device)[:, None]

    def spec_tex(key):
        return tvt[lane, torch.clamp_min(row(key), 0)]      # (N,K,3)

    def float_tex(key):
        return tvt[..., 0][lane, torch.clamp_min(row(key), 0)]   # (N,K)

    def convert(x, conv):
        inv = 1.0 / torch.clamp_min(x, 1e-5)
        rad = x * (3.14159265 / 180.0)
        return torch.where(conv == CONV_INV, inv,
                           torch.where(conv == CONV_RADIANS, rad, x))

    return {
        "type": row("lobe_type"),
        "fr": row("fr"),
        "R": spec_tex("s0"),
        "S1": spec_tex("s1"),
        "S2": spec_tex("s2"),
        "f0": convert(float_tex("f0"), row("f0_conv")),
        "f1": convert(float_tex("f1"), row("f1_conv")),
        "f2": float_tex("f2"),
    }
