"""RGB helpers the path integrator reads (port of grail/core/spectrum.py)."""
from __future__ import annotations


def luminance(rgb):
    """y() — the Russian-roulette weight (pbrt RGBSpectrum::y)."""
    return 0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1] + 0.072169 * rgb[..., 2]
