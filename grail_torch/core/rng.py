"""Counter-based, stateless sample generation (port of grail/core/rng.py).

Every draw is a pure function u = f(pixel_id, sample_idx, dim) and must be
bitwise equal to the JAX reference. PyTorch's uint32 coverage is thin, so the
32-bit values are carried in int64 and masked back to 32 bits after every
multiply, add and left shift (a product of two values below 2^32 fits in
int64). Conversion to float starts from the non-negative int64, which rounds
exactly as uint32 -> float32 does.

Arguments may be tensors or Python ints; a Python int stays a Python int
until it meets a tensor.

sample_1d and sample_2d choose their route from the input alone: CUDA
tensors take one launch of the card's kernel (kernels/sampler.py,
csrc/sampler.cu), which gives the plain version's bits; CPU tensors and
Python ints take sample_1d_plain / sample_2d_plain, the tests' baseline.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import telemetry
from ..kernels import sampler as ksampler

RANDOM = 0
STRATIFIED = 1
ZERO_TWO = 2
HALTON = 3

_M32 = 0xFFFFFFFF
_INV_U32 = 2.3283064365386963e-10  # 1/2^32
ONE_MINUS_EPS = 1.0 - 2**-24


def _u32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return int(x) & _M32


def pcg_hash(x):
    """PCG output permutation over a LCG-advanced state."""
    x = _u32(x)
    state = (x * 747796405 + 2891336453) & _M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def hash_combine(a, b):
    """Mix two u32 streams (boost-style)."""
    a = _u32(a)
    b = _u32(b)
    return pcg_hash(a ^ ((b + 0x9E3779B9 + ((a << 6) & _M32) + (a >> 2)) & _M32))


def hash3(a, b, c):
    return hash_combine(hash_combine(a, b), c)


def u32_to_float(u):
    """uint32 -> [0,1) float32."""
    u = torch.as_tensor(_u32(u))
    return torch.clamp_max(u.to(torch.float32) * _INV_U32, ONE_MINUS_EPS)


# --------------------------------------------------------------------- low discrepancy
def reverse_bits32(n):
    n = _u32(n)
    n = ((n << 16) & _M32) | (n >> 16)
    n = ((n & 0x00FF00FF) << 8) | ((n & 0xFF00FF00) >> 8)
    n = ((n & 0x0F0F0F0F) << 4) | ((n & 0xF0F0F0F0) >> 4)
    n = ((n & 0x33333333) << 2) | ((n & 0xCCCCCCCC) >> 2)
    n = ((n & 0x55555555) << 1) | ((n & 0xAAAAAAAA) >> 1)
    return n


def van_der_corput(n, scramble):
    """Base-2 radical inverse with XOR scramble (pbrt VanDerCorput)."""
    return u32_to_float(reverse_bits32(n) ^ _u32(scramble))


def _sobol2_tables():
    """(4, 256) XOR tables: entry [k, b] is the XOR of the Sobol direction
    numbers v_i (v_0 = 1<<31, v_{i+1} = v_i ^ v_i>>1) over the set bits of
    byte b in byte position k."""
    v = [1 << 31]
    for _ in range(31):
        v.append(v[-1] ^ (v[-1] >> 1))
    tab = np.zeros((4, 256), np.int64)
    for k in range(4):
        for b in range(256):
            acc = 0
            for i in range(8):
                if b >> i & 1:
                    acc ^= v[8 * k + i]
            tab[k, b] = acc
    return tab


_SOBOL2 = _sobol2_tables()


def sobol2(n, scramble):
    """Second Sobol dimension with XOR scramble (pbrt Sobol2). The reference's
    32-step bit loop is evaluated a byte at a time through XOR tables; XOR is
    associative, so the bits are identical."""
    n = torch.as_tensor(_u32(n))
    tab = telemetry.sync("sobol_table", torch.as_tensor, _SOBOL2, device=n.device)
    result = _u32(scramble)
    for k in range(4):
        result = result ^ tab[k][(n >> (8 * k)) & 0xFF]
    return u32_to_float(result)


def sample02(n, scramble0, scramble1):
    return van_der_corput(n, scramble0), sobol2(n, scramble1)


_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71,
           73, 79, 83, 89, 97, 101, 103, 107, 109, 113, 127, 131)


def _digits(base):
    """radical_inverse's digit count in `base`."""
    return max(2, int(33 / math.log2(base)) + 1) if base > 2 else 33


def radical_inverse(n, base):
    """Radical inverse in a static base over int32 n (pbrt RadicalInverse).
    n arrives as the reference's int32 view of the sample index: values at
    or above 2^31 are negative, and `%`/`//` follow floor semantics there."""
    n = torch.as_tensor(n)
    inv_base = 1.0 / base
    ndigits = _digits(base)
    val = torch.zeros(n.shape, dtype=torch.float32, device=n.device)
    inv_bi = torch.full(n.shape, inv_base, dtype=torch.float32, device=n.device)
    for _ in range(ndigits):
        d = n % base
        # the reference's compiled loop fuses val + d*inv_bi into one
        # multiply-add; float64 holds the product exactly, so the sum rounds
        # to float32 once, as the fused operation does
        val = (val.to(torch.float64)
               + d.to(torch.float64) * inv_bi.to(torch.float64)).to(torch.float32)
        n = n // base
        inv_bi = inv_bi * inv_base
    return torch.clamp_max(val, ONE_MINUS_EPS)


def _as_i32(u):
    """uint32 (in int64) -> the int32 value with the same bits."""
    u = torch.as_tensor(u)
    return torch.where(u >= 2**31, u - 2**32, u)


# ------------------------------------------------------------------------- sampler API
@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    kind: int = ZERO_TWO
    spp: int = 16
    seed: int = 0


def _halton_base(dim, traced):
    """HALTON's base, as the reference: a static dim picks its prime; a
    traced or per-lane dim falls back to base 2."""
    if traced or isinstance(dim, torch.Tensor):
        return 2
    return _PRIMES[int(dim) % len(_PRIMES)]


@functools.lru_cache(maxsize=256)
def _kernel_params(cfg: SamplerConfig, two, base):
    """csrc/sampler.cu's Params of a call, after the kind: (kind, seed, m0,
    m1, f0, f1). STRATIFIED's reciprocals are those PyTorch multiplies by on
    the card when it divides a float32 tensor by a Python number (taken in
    double, rounded to float32); HALTON's 1/base is the float32 the plain
    version starts its digit weights from."""
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    seed = cfg.seed & _M32
    if cfg.kind == STRATIFIED:
        if two:
            sx = max(int(math.sqrt(cfg.spp)), 1)
            sy = max(cfg.spp // sx, 1)
            return (cfg.kind, seed, sx, sy, f32(1.0 / sx), f32(1.0 / sy))
        return (cfg.kind, seed, cfg.spp, 0, f32(1.0 / cfg.spp), 0.0)
    if cfg.kind == HALTON:
        return (cfg.kind, seed, base, _digits(base), f32(1.0 / base), 0.0)
    if cfg.kind in (RANDOM, ZERO_TWO):
        return (cfg.kind, seed, 0, 0, 0.0, 0.0)
    raise ValueError(f"unknown sampler kind {cfg.kind}")


def sample_1d(cfg: SamplerConfig, pixel_id, samp_idx, dim, traced=False):
    """One uniform in [0,1) for (pixel, sample index, dimension).

    traced: the reference computes this dimension as a traced value (inside
    lax.fori_loop, or by array arithmetic), where HALTON cannot pick the
    dimension's prime and takes base 2. A per-lane tensor dim does the same.
    One `rng` span a call, with its lanes."""
    operands = (pixel_id, samp_idx, dim)
    with telemetry.span("rng") as span:
        on_card, shape = ksampler.plan(operands)
        if span is not None:
            span.lanes = math.prod(shape)
        if on_card:
            base = _halton_base(dim, traced) if cfg.kind == HALTON else 0
            return ksampler.draw("sample_1d", _kernel_params(cfg, False, base), shape,
                                 operands)
        return sample_1d_plain(cfg, pixel_id, samp_idx, dim, traced)


def sample_2d(cfg: SamplerConfig, pixel_id, samp_idx, dim):
    """A 2D uniform sample; `dim` identifies the 2D slot. One `rng` span a
    call, with its lanes."""
    operands = (pixel_id, samp_idx, dim)
    with telemetry.span("rng") as span:
        on_card, shape = ksampler.plan(operands)
        if span is not None:
            span.lanes = math.prod(shape)
        if on_card:
            out = ksampler.draw("sample_2d", _kernel_params(cfg, True, 2), shape, operands)
            return out[0], out[1]
        return sample_2d_plain(cfg, pixel_id, samp_idx, dim)


def sample_1d_plain(cfg: SamplerConfig, pixel_id, samp_idx, dim, traced=False):
    """sample_1d in PyTorch, on any device."""
    pixel_id = _u32(pixel_id)
    samp_idx = _u32(samp_idx)
    dim_u = _u32(dim)
    seed = cfg.seed & _M32
    if cfg.kind == RANDOM:
        return u32_to_float(hash3(pixel_id ^ seed, samp_idx, dim_u))
    if cfg.kind == STRATIFIED:
        jitter = u32_to_float(hash3(pixel_id ^ seed, samp_idx, dim_u))
        perm = ((samp_idx + hash_combine(pixel_id ^ seed, dim_u)) & _M32) % cfg.spp
        perm = torch.as_tensor(perm)
        return torch.clamp_max((perm.to(torch.float32) + jitter) / cfg.spp,
                               ONE_MINUS_EPS)
    if cfg.kind == ZERO_TWO:
        scramble = hash3(pixel_id ^ seed, dim_u, 0xA511E9B3)
        return van_der_corput(samp_idx, scramble)
    if cfg.kind == HALTON:
        base = _halton_base(dim, traced)
        v = radical_inverse(_as_i32(samp_idx), base)
        rot = u32_to_float(hash_combine(pixel_id ^ seed, dim_u))
        v = v + rot
        return torch.where(v >= 1.0, v - 1.0, v)
    raise ValueError(f"unknown sampler kind {cfg.kind}")


def sample_2d_plain(cfg: SamplerConfig, pixel_id, samp_idx, dim):
    """sample_2d in PyTorch, on any device."""
    pixel_id = _u32(pixel_id)
    samp_idx = _u32(samp_idx)
    dim_u = _u32(dim)
    seed = cfg.seed & _M32
    if cfg.kind == ZERO_TWO:
        s0 = hash3(pixel_id ^ seed, dim_u, 0xA511E9B3)
        s1 = hash3(pixel_id ^ seed, dim_u, 0x63D83595)
        return sample02(samp_idx, s0, s1)
    if cfg.kind == STRATIFIED:
        sx = max(int(math.sqrt(cfg.spp)), 1)
        sy = max(cfg.spp // sx, 1)
        n = sx * sy
        perm = torch.as_tensor(
            ((samp_idx + hash_combine(pixel_id ^ seed, dim_u)) & _M32) % n)
        px = (perm % sx).to(torch.float32)
        py = (perm // sx).to(torch.float32)
        d2 = (dim_u * 2) & _M32
        jx = u32_to_float(hash3(pixel_id ^ seed, samp_idx, d2))
        jy = u32_to_float(hash3(pixel_id ^ seed, samp_idx, (d2 + 1) & _M32))
        return (torch.clamp_max((px + jx) / sx, ONE_MINUS_EPS),
                torch.clamp_max((py + jy) / sy, ONE_MINUS_EPS))
    # the reference derives these dims as arrays, so HALTON sees base 2 here
    d0 = (dim_u * 2 + 1000003) & _M32
    d1 = (dim_u * 2 + 1000033) & _M32
    return (sample_1d_plain(cfg, pixel_id, samp_idx, d0, traced=True),
            sample_1d_plain(cfg, pixel_id, samp_idx, d1, traced=True))
