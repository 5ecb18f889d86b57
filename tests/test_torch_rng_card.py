"""The sampler kernel (grail_torch/kernels/csrc/sampler.cu, bound in
kernels/sampler.py) against its plain version (core/rng.py::
sample_1d_plain, sample_2d_plain), both on the card. Every test is marked
`card` and skips without a CUDA card. This file imports no JAX, so it runs
on a machine without it; there, skip the JAX-loading conftest:

    python -m pytest tests/test_torch_rng_card.py --noconftest -q -p no:cacheprovider

Every draw is the plain version's bit for bit, one launch a call: each
sampler kind in 1D and 2D; static dims (HALTON's primes), traced dims and
per-lane dims (HALTON's base 2); pixel ids near 2^32 and sample indices at
and above 2^31 (negative in HALTON's int32 view); Python-int, int64, int32,
expanded and strided operands; STRATIFIED at 12 and 48 samples a pixel,
whose strata widths are not powers of two; Metropolis's (N, 1) x (1, K)
broadcast; zero lanes. A CUDA call the kernel cannot take (past 2-D,
another dtype, two devices) raises instead of running the plain version.
Then a render at cornell.path's traffic: one launch a sampler call and no
Sobol-table copy.
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grail_torch import telemetry
from grail_torch.core import rng
from grail_torch.engine.integrator import IntegratorConfig
from grail_torch.engine.render import render
from grail_torch.kernels import sampler as ksampler
from grail_torch.scene.presets import cornell_box

KINDS = {"random": rng.RANDOM, "stratified": rng.STRATIFIED, "zero_two": rng.ZERO_TWO,
         "halton": rng.HALTON}
SEED = 0x9E3779B97F4A7C15 & 0xFFFFFFFF
N = 4099     # lanes: not a multiple of a block
EDGE = [0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the sampler kernel runs only on the card")
    return torch.device("cuda", 0)


def _lanes(dev, dtype=torch.int64, seed=3):
    """(pix, samp, dim) of N lanes: pixel ids up to 2^32 - 1, sample indices
    up to 2^32 - 1 (the first 3/4 below 2^31), dims below 200, the edge
    values at the front."""
    r = np.random.default_rng(seed)
    pix = r.integers(0, 2**32, N, dtype=np.int64)
    samp = np.where(np.arange(N) < 3 * N // 4, r.integers(0, 64, N),
                    r.integers(2**31, 2**32, N))
    dim = r.integers(0, 200, N, dtype=np.int64)
    k = len(EDGE)
    pix[:k] = samp[k:2 * k] = dim[2 * k:3 * k] = EDGE
    out = []
    for a in (pix, samp, dim):
        t = torch.tensor(a.astype(np.int64))
        if dtype == torch.int32:
            t = torch.tensor(a.astype(np.uint32).view(np.int32))
        out.append(t.to(dev))
    return out


def _differing(got, ref):
    """The elements that differ in their bits."""
    return int((got.view(torch.int32) != ref.view(torch.int32)).sum())


def _same_draws(cfg, pix, samp, dim, traced=False, two=None, launches=1):
    """sample_1d and sample_2d against their plain versions: bitwise, of the
    plain version's shape, in `launches` launches each."""
    calls = (("sample_1d", lambda f: f(cfg, pix, samp, dim, traced)),
             ("sample_2d", lambda f: f(cfg, pix, samp, dim)))
    for name, call in calls:
        if two is not None and two != (name == "sample_2d"):
            continue
        n0 = dict(ksampler.LAUNCHES)
        got = call(getattr(rng, name))
        torch.cuda.synchronize()
        assert ksampler.LAUNCHES[name] == n0[name] + launches, name
        ref = call(getattr(rng, name + "_plain"))
        got, ref = (got, ref) if name == "sample_2d" else ((got,), (ref,))
        for g, r in zip(got, ref):
            assert g.dtype == r.dtype == torch.float32
            assert g.shape == r.shape and g.device == r.device, (g.shape, r.shape)
            assert _differing(g, r) == 0, (name, (g - r).abs().max())


@pytest.mark.card
@pytest.mark.parametrize("spp", [16, 12, 48])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_per_lane_dims(kind, spp, card):
    cfg = rng.SamplerConfig(kind=KINDS[kind], spp=spp, seed=SEED)
    _same_draws(cfg, *_lanes(card))


@pytest.mark.card
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_static_and_traced_dims(kind, card):
    """Python-int dims: HALTON's prime for a static one (dims 0..45 reach
    every one of the 32 primes), base 2 when traced."""
    cfg = rng.SamplerConfig(kind=KINDS[kind], spp=12, seed=SEED)
    pix, samp, _ = _lanes(card)
    for dim in list(range(0, 46, 3)) + [31, 32, 2**31 + 5, 2**32 - 1]:
        _same_draws(cfg, pix, samp, dim)
        _same_draws(cfg, pix, samp, dim, traced=True, two=False)


@pytest.mark.card
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_int_and_int32_operands(kind, card):
    """Python-int pixel ids and sample indices (near 2^32, at and above
    2^31), int32 tensors (negative where the value is 2^31 or more), an
    expanded sample index (stride 0) and a strided pixel id."""
    cfg = rng.SamplerConfig(kind=KINDS[kind], spp=48, seed=SEED)
    pix, samp, dim = _lanes(card)
    for p, s in ((2**32 - 3, samp), (pix, 2**31), (pix, 2**32 - 1)):
        _same_draws(cfg, p, s, dim)
        _same_draws(cfg, p, s, 5)
    _same_draws(cfg, 2**32 - 1, 2**31 + 7, dim)
    _same_draws(cfg, *_lanes(card, torch.int32))
    p32, s32, d32 = _lanes(card, torch.int32)
    _same_draws(cfg, p32, samp, d32)
    _same_draws(cfg, pix, s32[:1].expand(N), 9)
    wide = torch.stack([pix, pix ^ 0x5555], 1)
    _same_draws(cfg, wide[:, 1], samp, dim)


@pytest.mark.card
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_broadcasts_zero_lanes_and_past_2d(kind, card):
    """Metropolis's (N, 1) x (1, K) draws and its (N, 1) against an int;
    zero lanes (no launch); a 3-D broadcast raises, launching nothing."""
    cfg = rng.SamplerConfig(kind=KINDS[kind], spp=16, seed=SEED)
    pix, samp, _ = _lanes(card)
    dims = 2 * torch.arange(24, dtype=torch.int64, device=card)[None, :]
    _same_draws(cfg, pix[:, None], samp[:, None], dims)
    _same_draws(cfg, pix[:, None], samp[:, None], 999999)
    _same_draws(cfg, pix[:, None], 3, dims)
    _same_draws(cfg, pix[:0], samp[:0], 4, launches=0)
    _same_draws(cfg, pix[:0, None], samp[:0, None], dims, launches=0)
    n0 = dict(ksampler.LAUNCHES)
    with pytest.raises(ValueError, match="at most 2-D"):
        rng.sample_1d(cfg, pix[:8, None, None], samp[:8, None, None], dims[:, None])
    with pytest.raises(ValueError, match="at most 2-D"):
        rng.sample_2d(cfg, pix[:8, None, None], samp[:8, None, None], dims[:, None])
    assert ksampler.LAUNCHES == n0


@pytest.mark.card
def test_routes(card):
    """The kernel takes int64 and int32 CUDA operands up to 2-D; any other
    CUDA call is an error; CPU operands take the plain version."""
    pix, samp, dim = _lanes(card)
    assert ksampler.plan((pix, samp, 3)) == (True, (N,))
    assert ksampler.plan((pix[:, None], 0, dim[None, :])) == (True, (N, N))
    for operands in ((pix[:, None, None], samp, 3), (pix.float(), samp, 3),
                     (pix, samp.cpu()[0], 3)):
        with pytest.raises(ValueError, match="sampler kernel takes"):
            ksampler.plan(operands)
    assert ksampler.plan((pix.cpu(), samp.cpu(), 3)) == (False, (N,))


@pytest.mark.card
def test_a_render_at_the_cells_traffic_launches_one_a_call(card):
    """cornell.path's traffic: 256x256, 64 spp, path depth 5, four megawaves
    of 16 samples, each of 39 sampler calls."""
    scene, meta, _ = cornell_box(256, 256, 64, device=card)
    cfg = IntegratorConfig(kind="path", max_depth=5)
    render(scene, meta, cfg, spp=64, device=card)
    n0 = dict(ksampler.LAUNCHES)
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        render(scene, meta, cfg, spp=64, device=card)
        torch.cuda.synchronize()
    spans = collections.Counter(s.name for s in telemetry.SPANS)
    telemetry.reset()
    launches = sum(ksampler.LAUNCHES[k] - n0[k] for k in ksampler.ROUTES)
    assert spans["megawave"] == 4
    assert launches == spans["rng"] == 156
    assert spans["sync/sobol_table"] == 0
