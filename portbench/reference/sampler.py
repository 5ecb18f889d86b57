"""The (0,2)-sequence sampler of pbrt's "lowdiscrepancy" sampler, worked out
again in plain PyTorch: a counter-based draw u = f(pixel, sample, dimension).

The scramble of a (pixel, dimension) pair is a PCG hash of the pair and the
seed; dimension 0 of a 2D slot is the base-2 radical inverse of the sample
index, dimension 1 the second Sobol' dimension, each XOR-scrambled. All
32-bit values are carried in int64 and masked after every multiply, add and
shift. `dt` is the float type the draws are handed out in.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
ONE_MINUS_EPS = 1.0 - 2.0 ** -24
SCRAMBLE_0 = 0xA511E9B3
SCRAMBLE_1 = 0x63D83595


def _u32(x):
    return x & M32


def pcg(x):
    state = _u32(_u32(x) * 747796405 + 2891336453)
    word = _u32(((state >> ((state >> 28) + 4)) ^ state) * 277803737)
    return (word >> 22) ^ word


def combine(a, b):
    a = _u32(a)
    b = _u32(b)
    return pcg(a ^ _u32(b + 0x9E3779B9 + _u32(a << 6) + (a >> 2)))


def to_unit(u, dt):
    """uint32 -> [0, 1), rounded as a float32 conversion, then cast to dt."""
    v = torch.clamp_max(u.to(torch.float32) * 2.0 ** -32, ONE_MINUS_EPS)
    return v.to(dt)


def _reverse(n):
    n = _u32(n)
    n = _u32(n << 16) | (n >> 16)
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)
    return n


def _sobol(n, scramble):
    """pbrt Sobol2: the direction numbers v_0 = 2^31, v_{i+1} = v_i ^ v_i >> 1,
    XORed over the set bits of n, bit by bit."""
    v = 1 << 31
    out = _u32(scramble)
    for i in range(32):
        out = torch.where(((n >> i) & 1) == 1, out ^ v, out)
        v = v ^ (v >> 1)
    return out


class Sampler:
    """Draws for lanes (pixel ids, sample indices), both int64 tensors."""

    def __init__(self, seed, dt=torch.float32):
        self.seed = int(seed) & M32
        self.dt = dt

    def _key(self, pix, dim, salt):
        return combine(combine(_u32(pix) ^ self.seed, dim), salt)

    def get1d(self, pix, samp, dim):
        return to_unit(_reverse(samp) ^ self._key(pix, dim, SCRAMBLE_0), self.dt)

    def get2d(self, pix, samp, dim):
        u0 = to_unit(_reverse(samp) ^ self._key(pix, dim, SCRAMBLE_0), self.dt)
        u1 = to_unit(_sobol(_u32(samp), self._key(pix, dim, SCRAMBLE_1)), self.dt)
        return u0, u1
