"""shade/bsdf.py's choice of version, on the CPU: CPU tensors take the plain
version and launch nothing; kernels/bsdf.py's plan (plain Python over
devices, dtypes and shapes) sends every other call to the kernel, one that
records a gradient and one that shades a MEASURED lobe from its tables
included, and raises for a CUDA call the kernel cannot take. CUDA operands are FakeTensorMode's: they carry a CUDA
device and shapes without a card, and the plain version runs on them as
shapes alone. tests/test_torch_bsdf_card.py holds the kernel to the plain
version's bits on the card, tests/test_torch_goldens.py and
test_torch_lobes.py the plain version to the JAX reference."""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from grail_torch import telemetry
from grail_torch.kernels import bsdf as kbsdf
from grail_torch.shade import bsdf as bx

torch.set_num_threads(2)

N, K = 40, 3
TYPES = (bx.LAMBERT, bx.OREN_NAYAR, bx.BLINN, bx.ANISO, bx.SPEC_REFL, bx.SPEC_TRANS,
         bx.FRESNEL_BLEND, bx.LAMBERT_T, bx.BLINN_T)


def _stack(device="cpu", present=TYPES, n=N):
    """(lobes, wo, wi, [u1, u2, uc]) of n lanes of K slots drawn from
    `present` and NONE; on "cuda" (under FakeTensorMode) shapes and dtypes
    alone."""
    if device == "cuda":
        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="cuda")
        lobes = {"type": empty(n, K, dtype=torch.int32), "fr": empty(n, K, dtype=torch.int32)}
        lobes.update({key: empty(n, K) for key in ("f0", "f1", "f2")})
        lobes.update({key: empty(n, K, 3) for key in ("R", "S1", "S2")})
        return lobes, empty(n, 3), empty(n, 3), [empty(n) for _ in range(3)]
    r = np.random.default_rng(5)
    pool = np.array(present + (bx.NONE,), np.int32)

    def t(x, dtype=torch.float32):
        return torch.tensor(x, dtype=dtype)

    lobes = {"type": t(pool[r.integers(0, len(pool), (n, K))], torch.int32),
             "fr": t(r.integers(0, 3, (n, K)), torch.int32),
             "f0": t(r.uniform(1, 50, (n, K))), "f1": t(r.uniform(1, 50, (n, K))),
             "f2": t(r.uniform(1.1, 2.0, (n, K)))}
    for key in ("R", "S1", "S2"):
        lobes[key] = t(r.uniform(0.1, 1, (n, K, 3)))
    d = r.normal(size=(2, n, 3))
    wo, wi = t(d / np.linalg.norm(d, axis=-1, keepdims=True))
    u = [t(x) for x in r.uniform(0, 1, (3, n))]
    return lobes, wo, wi, u


def _counts():
    return dict(kbsdf.LAUNCHES), dict(kbsdf.BACKWARD)


def _fields(lobes, keys=("type", "fr", "R", "S1", "S2", "f0", "f1", "f2")):
    return {key: lobes[key] for key in keys}


@pytest.mark.parametrize("spec", [True, False])
def test_cpu_operands_take_the_plain_version(spec):
    """Bitwise the plain version, with nothing launched or counted."""
    lobes, wo, wi, u = _stack()
    before = _counts()
    assert torch.equal(bx.bsdf_f(lobes, wo, wi, TYPES, spec),
                       bx.bsdf_f_plain(lobes, wo, wi, TYPES, spec))
    assert torch.equal(bx.bsdf_pdf(lobes, wo, wi, TYPES, spec),
                       bx.bsdf_pdf_plain(lobes, wo, wi, TYPES, spec))
    got = bx.bsdf_sample(lobes, wo, *u, TYPES, spec)
    ref = bx.bsdf_sample_plain(lobes, wo, *u, TYPES, spec)
    assert all(torch.equal(got[key], ref[key]) for key in ref)
    assert _counts() == before
    assert kbsdf.plan(_fields(lobes), (wo,), u) == "cpu"


def test_the_kernel_gets_the_fields_the_stack_reads(monkeypatch):
    """The kernel is handed the slot fields the present lobe types read and
    no other (a field no present type reads gets no gradient, as in the
    plain version): bsdf_pdf only exponents; f1 only for ANISO,
    FRESNEL_BLEND and MEASURED; the Fresnel fields only for the types that
    take a Fresnel term; a delta lobe's fields only in bsdf_sample."""
    seen = []
    monkeypatch.setattr(kbsdf, "launch", lambda route, fields, *a, **k: seen.append(
        (route, set(fields))))
    cases = {(bx.LAMBERT,): ({"R"}, set(), {"R"}),
             (bx.LAMBERT, bx.BLINN): ({"R", "f0", "fr", "S1", "S2", "f2"}, {"f0"},
                                      {"R", "f0", "fr", "S1", "S2", "f2"}),
             (bx.FRESNEL_BLEND,): ({"R", "S1", "f0", "f1"}, {"f0", "f1"},
                                   {"R", "S1", "f0", "f1"}),
             (bx.MEASURED, bx.SPEC_TRANS): ({"R", "S1", "f1"}, set(),
                                            {"R", "S1", "f1", "f2"})}
    with FakeTensorMode():
        lobes, wo, wi, u = _stack("cuda")
        for present in cases:
            _call_each(lobes, wo, wi, u, present)
    want = [(route, {"type"} | keys) for reads in cases.values()
            for route, keys in zip(("f", "pdf", "sample"), reads)]
    assert seen == want


def _empty(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="cuda")


@pytest.mark.parametrize("route", ["f", "pdf", "sample"])
def test_cuda_calls_plan_the_kernel(route):
    """mesh100k's (LAMBERT, BLINN) stack and every kernel type, int32 and
    int64 tags, strided and expanded operands, a slot field that requires a
    gradient, and measured tables."""
    with FakeTensorMode():
        for present in ((bx.LAMBERT, bx.BLINN), TYPES):
            lobes, wo, wi, u = _stack("cuda", present)
            dirs, uni = ((wo,), u) if route == "sample" else ((wo, wi), ())
            assert kbsdf.plan(_fields(lobes), dirs, uni) == "kernel"
            wide = dict(lobes, type=lobes["type"].long(), fr=lobes["fr"].long())
            assert kbsdf.plan(_fields(wide), dirs, uni) == "kernel"
            strided = torch.empty_strided((N, 3), (6, 2), device="cuda")
            expanded = {key: _empty(1, *v.shape[1:], dtype=v.dtype).expand(v.shape)
                        for key, v in lobes.items()}
            dirs = (strided,) + tuple(_empty(1, 3).expand(N, 3) for _ in dirs[1:])
            assert kbsdf.plan(_fields(expanded), dirs, uni) == "kernel"
            grad = dict(lobes, R=lobes["R"].clone().requires_grad_())
            assert kbsdf.plan(_fields(grad), dirs, uni) == "kernel"
            tables = (_empty(8, 4, 6, 3), _empty(3, 2, 5, 3))
            assert kbsdf.plan(_fields(lobes), dirs, uni, tables) == "kernel"


@pytest.fixture
def routed(monkeypatch):
    """The entry points' calls into each version, recorded in place of the
    versions themselves (a fake tensor cannot run either)."""
    calls = []

    def record(name):
        def fn(*args, **kwargs):
            calls.append(name)
            return name
        return fn

    for name in ("bsdf_f_plain", "bsdf_pdf_plain", "bsdf_sample_plain"):
        monkeypatch.setattr(bx, name, record(name))
    monkeypatch.setattr(kbsdf, "launch", lambda route, *a, **k: calls.append(route) or route)
    return calls


def _call_each(lobes, wo, wi, u, present):
    return [bx.bsdf_f(lobes, wo, wi, present), bx.bsdf_pdf(lobes, wo, wi, present),
            bx.bsdf_sample(lobes, wo, *u, present)]


def test_cuda_calls_take_the_kernel(routed):
    with FakeTensorMode():
        before = _counts()
        assert _call_each(*_stack("cuda"), TYPES) == ["f", "pdf", "sample"]
    assert routed == ["f", "pdf", "sample"] and _counts() == before


def test_a_call_recording_a_gradient_takes_the_kernel(routed):
    """A gradient on wo, on a slot field the call reads or on a uniform
    leaves the call on the kernel (its backward is the kernel's too), as
    does no_grad; nothing takes the plain version."""
    with FakeTensorMode():
        lobes, wo, wi, u = _stack("cuda")
        grad_lobes = dict(lobes, R=lobes["R"].clone().requires_grad_())
        assert _call_each(grad_lobes, wo, wi, u, TYPES) == ["f", "pdf", "sample"]
        wo_g = wo.clone().requires_grad_()
        assert bx.bsdf_pdf(lobes, wo_g, wi, TYPES) == "pdf"
        u_g = [u[0].clone().requires_grad_(), *u[1:]]
        assert bx.bsdf_sample(lobes, wo, *u_g, TYPES) == "sample"
        with torch.no_grad():
            assert _call_each(grad_lobes, wo, wi, u, TYPES) == ["f", "pdf", "sample"]
    assert routed == ["f", "pdf", "sample", "pdf", "sample", "f", "pdf", "sample"]


def test_measured_takes_the_kernel(routed, monkeypatch):
    """A stack with MEASURED is the kernel's, its tables passed to bsdf_f
    and bsdf_sample (bsdf_pdf reads none)."""
    present = (bx.LAMBERT, bx.MEASURED)
    passed = []
    monkeypatch.setattr(kbsdf, "launch", lambda route, *a, tables=(), **k: passed.append(
        (route, len(tables))) or route)
    with FakeTensorMode():
        lobes, wo, wi, u = _stack("cuda", present)
        tables = (_empty(8, 4, 6, 3),)
        assert [bx.bsdf_f(lobes, wo, wi, present, tables=tables),
                bx.bsdf_pdf(lobes, wo, wi, present),
                bx.bsdf_sample(lobes, wo, *u, present, tables=tables)] == [
                    "f", "pdf", "sample"]
    assert passed == [("f", 1), ("pdf", 0), ("sample", 1)] and routed == []


CANNOT = [
    ("float64_slot", lambda l, d: (dict(l, f2=l["f2"].double()), d), "BSDF kernel takes"),
    ("float_tags", lambda l, d: (dict(l, type=l["type"].float()), d), "BSDF kernel takes"),
    ("int16_fresnel", lambda l, d: (dict(l, fr=l["fr"].short()), d), "BSDF kernel takes"),
    ("two_channel_colour", lambda l, d: (dict(l, S2=_empty(N, K, 2)), d),
     "BSDF kernel takes"),
    ("flat_tags", lambda l, d: (dict(l, type=_empty(N, dtype=torch.int32)), d),
     "BSDF kernel takes"),
    ("lane_mismatch", lambda l, d: (l, (_empty(N - 1, 3), d[1])), "BSDF kernel takes"),
    ("float64_direction", lambda l, d: (l, (d[0].double(), d[1])), "BSDF kernel takes"),
    ("cpu_direction", lambda l, d: (l, (torch.empty(N, 3), d[1])), "one CUDA device"),
    ("too_many_tables", lambda l, d: (l, d, (_empty(2, 2, 2, 3),) * 17), "measured tables"),
    ("two_channel_table", lambda l, d: (l, d, (_empty(2, 2, 2, 2),)), "measured tables"),
    ("table_requiring_grad", lambda l, d: (l, d, (_empty(2, 2, 2, 3).requires_grad_(),)),
     "no gradient in the measured tables"),
]


@pytest.mark.parametrize("case", CANNOT, ids=[c[0] for c in CANNOT])
def test_a_cuda_call_the_kernel_cannot_take_raises(case, routed):
    """The error comes from the plan: no launch, no plain version."""
    _, alter, match = case
    with FakeTensorMode(allow_non_fake_inputs=True):
        lobes, wo, wi, u = _stack("cuda")
        bad, dirs, *tables = alter(lobes, (wo, wi))
        tables = tables[0] if tables else ()
        counts = _counts()
        with pytest.raises(ValueError, match=match):
            bx.bsdf_f(bad, dirs[0], dirs[1], TYPES, tables=tables)
        with pytest.raises(ValueError, match=match):
            bx.bsdf_sample(bad, dirs[0], *u, TYPES, tables=tables)
        with pytest.raises(ValueError, match="BSDF kernel takes"):
            bx.bsdf_sample(lobes, wo, _empty(N, 1), *u[1:], TYPES)
    assert _counts() == counts and routed == []


def test_spans_on_the_entry_points():
    """One bsdf_eval span an f or pdf call, one bsdf_sample span a sample
    call; on the plain route the sample's own f and pdf nest in it as
    bsdf_eval spans."""
    lobes, wo, wi, u = _stack()
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        bx.bsdf_f(lobes, wo, wi, TYPES)
        bx.bsdf_pdf(lobes, wo, wi, TYPES)
        bx.bsdf_sample(lobes, wo, *u, TYPES)
    spans = list(telemetry.SPANS)
    telemetry.reset()
    sample = [s for s in spans if s.name == "bsdf_sample"]
    evals = [s for s in spans if s.name == "bsdf_eval"]
    assert len(sample) == 1 and len(evals) == 4
    assert sum(s.parent == sample[0].id for s in evals) == 2


@pytest.fixture
def stub_kernel(monkeypatch):
    """kernels/bsdf.py's launches recorded in place of the card's kernel, to
    hold the wrapper's argument blocks and autograd wiring on CPU tensors
    (the outputs stay as allocated)."""
    runs = []
    monkeypatch.setattr(kbsdf, "_run", lambda route, backward, block, device: runs.append(
        (route, backward, list(block))))
    return runs


def test_sampled_directions_carry_no_gradient_of_a_colour(stub_kernel):
    """bsdf_sample's wi and pdf depend on no colour: where only R requires a
    gradient they carry none (the next bounce's graph stays out of the
    backward, as in the plain version); a gradient on wo reaches them."""
    lobes, wo, wi, u = _stack()
    fields = {"type": lobes["type"], "R": lobes["R"].clone().requires_grad_()}
    out = kbsdf.launch("sample", fields, (bx.LAMBERT,), wo, uniforms=u)
    assert out["f"].requires_grad
    assert not any(out[key].requires_grad for key in ("wi", "pdf", "specular", "valid"))
    out = kbsdf.launch("sample", fields, (bx.LAMBERT,), wo.clone().requires_grad_(),
                       uniforms=u)
    assert out["wi"].requires_grad and out["pdf"].requires_grad
    assert [(route, backward) for route, backward, _ in stub_kernel] == [
        ("sample", False)] * 2


def test_a_backward_is_one_launch_with_the_wanted_gradients(stub_kernel):
    """A call that records a gradient: one forward launch, one backward
    launch whose block names f's cotangent through its strides and a dense
    gradient for each operand that requires one, and no other."""
    lobes, wo, wi, u = _stack()
    fields = {"type": lobes["type"], "R": lobes["R"].clone().requires_grad_(),
              "f0": lobes["f0"]}
    before = dict(kbsdf.BACKWARD)
    f = kbsdf.launch("f", fields, (bx.LAMBERT, bx.OREN_NAYAR), wo, wi=wi)
    cot = torch.ones(N, 3)
    f.backward(cot)
    assert [(route, backward) for route, backward, _ in stub_kernel] == [
        ("f", False), ("f", True)]
    assert kbsdf.BACKWARD == dict(before, f=before["f"] + 1)
    assert fields["R"].grad.shape == (N, K, 3) and fields["R"].grad.is_contiguous()
    block = stub_kernel[1][2]
    assert len(block) == kbsdf._ARGS_LEN
    grads = block[-len(kbsdf.OPERANDS):]
    assert [g != 0 for g in grads] == [name == "R" for name in kbsdf.OPERANDS]
    cots = block[-len(kbsdf.OPERANDS) - 12:-len(kbsdf.OPERANDS)]
    assert cots == [cot.data_ptr(), 3, 0, 1] + [0] * 8
