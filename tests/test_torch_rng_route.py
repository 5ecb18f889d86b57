"""core/rng.py's choice of route, on the CPU: CPU tensors and Python ints
take the plain version and launch nothing; kernels/sampler.py's plan and
layout (plain Python over shapes and strides) give what their docstrings
say; one `rng` span a call, with its lanes. tests/test_torch_rng_card.py
holds the kernel to the plain version's bits on the card, and
tests/test_torch_rng.py the plain version to the JAX reference's."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grail_torch import telemetry
from grail_torch.core import rng
from grail_torch.kernels import sampler as ksampler

torch.set_num_threads(2)

KINDS = {"random": rng.RANDOM, "stratified": rng.STRATIFIED, "zero_two": rng.ZERO_TWO,
         "halton": rng.HALTON}
N = 300


def _bits(x):
    return torch.as_tensor(x).view(torch.int32)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_cpu_operands_take_the_plain_version(kind):
    """Bitwise the plain version, and no launch:
    pixel ids near 2^32, sample indices across 2^31, per-lane, static and
    traced dims, a (N, 1) x (1, K) broadcast, and Python ints alone."""
    cfg = rng.SamplerConfig(kind=KINDS[kind], spp=12, seed=0xDEADBEEF)
    pix = torch.arange(2**32 - N, 2**32, dtype=torch.int64)
    samp = torch.arange(2**31 - N // 2, 2**31 + N // 2, dtype=torch.int64)
    n0 = dict(ksampler.LAUNCHES)
    cases = [(pix, samp, torch.arange(N) % 50), (pix, samp, 7), (pix, samp, 2**32 - 1),
             (pix[:8, None], samp[:8, None], torch.arange(5)[None, :]), (2**32 - 1, 2**31, 3)]
    for p, s, d in cases:
        for traced in (False, True):
            assert torch.equal(_bits(rng.sample_1d(cfg, p, s, d, traced)),
                               _bits(rng.sample_1d_plain(cfg, p, s, d, traced)))
        for got, ref in zip(rng.sample_2d(cfg, p, s, d), rng.sample_2d_plain(cfg, p, s, d)):
            assert torch.equal(_bits(got), _bits(ref))
    assert ksampler.LAUNCHES == n0


def test_unknown_kind_raises():
    cfg = rng.SamplerConfig(kind=9)
    with pytest.raises(ValueError, match="unknown sampler kind"):
        rng.sample_1d(cfg, torch.arange(4), 0, 1)
    with pytest.raises(ValueError, match="unknown sampler kind"):
        rng._kernel_params(cfg, False, 0)


def test_kernel_params():
    """STRATIFIED's strata and their float32 reciprocals, HALTON's digits
    as radical_inverse counts them."""
    cfg = rng.SamplerConfig(kind=rng.STRATIFIED, spp=12, seed=2**32 + 5)
    assert rng._kernel_params(cfg, False, 0) == (rng.STRATIFIED, 5, 12, 0,
                                                 float(torch.tensor(1 / 12)), 0.0)
    assert rng._kernel_params(cfg, True, 2) == (rng.STRATIFIED, 5, 3, 4,
                                                float(torch.tensor(1 / 3)), 0.25)
    cfg = rng.SamplerConfig(kind=rng.HALTON, spp=16, seed=1)
    for base, digits in ((2, 33), (3, 21), (131, 5)):
        assert rng._kernel_params(cfg, False, base) == (
            rng.HALTON, 1, base, digits, float(torch.tensor(1 / base)), 0.0)
    assert rng._kernel_params(rng.SamplerConfig(), True, 2) == (rng.ZERO_TWO, 0, 0, 0, 0.0, 0.0)


_PIX = torch.arange(6, dtype=torch.int64)
# (id, operands, broadcast shape, layout)
LAYOUTS = [
    ("scalar", (5, 2**32 + 6, 7), (), (1, [None, None, None])),
    ("1d", (_PIX, _PIX, 3), (6,), (6, [(0, 1), (0, 1), None])),
    ("1d_expanded", (_PIX, torch.tensor([4]).expand(6), 3), (6,),
     (6, [(0, 1), (0, 0), None])),
    ("1d_strided", (torch.arange(12)[::2], 0, _PIX), (6,), (6, [(0, 2), None, (0, 1)])),
    ("1d_against_0d", (_PIX, torch.tensor(9), 1), (6,), (6, [(0, 1), (0, 0), None])),
    ("2d_broadcast", (_PIX[:, None], _PIX[:, None], 2 * torch.arange(4)[None, :]), (6, 4),
     (4, [(1, 0), (1, 0), (0, 1)])),
    ("2d_row_and_int", (_PIX[:, None], 3, torch.arange(4)), (6, 4),
     (4, [(1, 0), None, (0, 1)])),
    ("2d_transposed", (torch.arange(24).view(4, 6).t(), 0, 1), (6, 4),
     (4, [(1, 6), None, None])),
    ("2d_empty", (_PIX[:0, None], 0, torch.arange(4)[None, :]), (0, 4),
     (4, [(1, 0), None, (0, 1)])),
    ("3d", (_PIX[:, None, None], 0, torch.arange(4)[None, :]), (6, 1, 4), None),
]


@pytest.mark.parametrize("case", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_plan_and_layout(case):
    """CPU operands route to the plain version whatever their shape; the
    kernel's view of them, up to 2-D, is a row-and-column stride each."""
    _, operands, shape, want = case
    on_card, got_shape = ksampler.plan(operands)
    assert not on_card and tuple(got_shape) == shape
    if len(shape) <= 2:
        assert ksampler.layout(got_shape, operands) == want


@pytest.mark.parametrize("kind", [rng.ZERO_TWO, rng.HALTON], ids=["zero_two", "halton"])
def test_one_rng_span_a_call_with_its_lanes(kind):
    """One span a call, the plain route's 2D draws included (HALTON's are
    two 1D draws inside it), its lanes the broadcast's."""
    cfg = rng.SamplerConfig(kind=kind)
    pix = torch.arange(N)
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        rng.sample_2d(cfg, pix, 3, 8)
        rng.sample_1d(cfg, pix[:, None], 3, torch.arange(4)[None, :])
        rng.sample_1d(cfg, 1, 2, 3)
    spans = [s for s in telemetry.SPANS if s.name == "rng"]
    telemetry.reset()
    assert [s.lanes for s in spans] == [N, N * 4, 1]
    assert all(s.parent is None or s.parent not in {t.id for t in spans} for s in spans)
