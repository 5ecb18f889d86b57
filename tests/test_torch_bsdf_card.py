"""The BSDF kernel (grail_torch/kernels/csrc/bsdf.cu, bound in
kernels/bsdf.py) against its plain version (shade/bsdf.py::bsdf_f_plain,
bsdf_pdf_plain, bsdf_sample_plain), both on the card. Every test is marked
`card` and skips without a CUDA card. This file imports no JAX, so it runs
on a machine without it; there, skip the JAX-loading conftest:

    python -m pytest tests/test_torch_bsdf_card.py --noconftest -q -p no:cacheprovider

f, pdf and the sampled wi are the plain version's bit for bit, and the
sampled slot, `specular` and `valid` the same on every lane, one launch a
call: every lobe type, alone and mixed in one stack of K = 1 to 4 slots
with NONE padding; MEASURED with the scene's tables (a row past them
included) and without; all three Fresnel kinds; include_specular both
ways; int32 and int64 tags; strided and expanded wo and wi; lanes not a
multiple of a block, and zero lanes. Directions cover both hemispheres,
the horizon, the pole, wi = -wo (no half vector) and the mirror of wo;
uniforms include 0 and the last float below 1. A call that records a
gradient is one launch more in backward, and its gradients in every float
operand are the plain version's within rounding. Then a render of the
mesh100k configuration at a small size: one launch a BSDF call and no
lobe-slot scan on the card; and a gradient step of the Cornell box: every
BSDF call of it on the kernel, forward and backward.
"""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from grail_torch import telemetry
from grail_torch.engine.integrator import IntegratorConfig
from grail_torch.engine import film as flm
from grail_torch.engine.render import render, render_wave
from grail_torch.kernels import bsdf as kbsdf
from grail_torch.scene.presets import cornell_box, mesh_scene
from grail_torch.shade import bsdf as bx

N = 4099     # lanes: not a multiple of a block
KERNEL_TYPES = (bx.LAMBERT, bx.OREN_NAYAR, bx.BLINN, bx.ANISO, bx.SPEC_REFL,
                bx.SPEC_TRANS, bx.FRESNEL_BLEND, bx.LAMBERT_T, bx.BLINN_T, bx.MEASURED)
NAMES = {bx.LAMBERT: "lambert", bx.OREN_NAYAR: "oren_nayar", bx.BLINN: "blinn",
         bx.ANISO: "aniso", bx.SPEC_REFL: "spec_refl", bx.SPEC_TRANS: "spec_trans",
         bx.FRESNEL_BLEND: "fresnel_blend", bx.LAMBERT_T: "lambert_t",
         bx.BLINN_T: "blinn_t", bx.MEASURED: "measured"}
# measured tables of two grids (a MERL-like fine one and a baked coarse one)
TABLE_SHAPES = ((90, 45, 90), (32, 16, 32))
ONE_MINUS = float(np.float32(1.0) - np.float32(2.0**-24))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the BSDF kernel runs only on the card")
    return torch.device("cuda", 0)


def _directions(r, n):
    """Unit directions over the sphere, the edge cases at the front: the
    pole, the horizon, grazing, straight down."""
    v = r.normal(size=(n, 3))
    edges = [[0, 0, 1], [1, 0, 0], [0.6, 0.8, 0], [0.3, 0.2, 1e-7], [0, 0, -1],
             [0.1, -0.2, -0.97]]
    v[:len(edges)] = edges[:n]
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _stack(r, n, types, k, pad=True):
    """(N, K) lobe stacks: each slot a type drawn from `types` or (pad) NONE,
    every Fresnel kind, and fields in each type's range (exponents 1-1000
    and 1-200, sigma in radians, iors 1.1-2.5, conductor eta and k, a
    MEASURED slot's table row 0-2 of TABLE_SHAPES' two)."""
    pool = np.array(list(types) + ([bx.NONE] if pad else []), np.int32)
    t = pool[r.integers(0, len(pool), (n, k))]
    f0 = np.where(np.isin(t, (bx.BLINN, bx.BLINN_T)), np.exp(r.uniform(0, np.log(1000), (n, k))),
                  np.where(t == bx.OREN_NAYAR, r.uniform(0, 0.6, (n, k)),
                           r.uniform(1, 200, (n, k))))
    return {
        "type": t,
        "fr": r.integers(0, 3, (n, k)).astype(np.int32),
        "R": r.uniform(0, 1, (n, k, 3)),
        "S1": r.uniform(0.05, 1.5, (n, k, 3)),
        "S2": r.uniform(0, 4, (n, k, 3)),
        "f0": f0,
        "f1": np.where(t == bx.MEASURED, r.integers(0, 3, (n, k)), r.uniform(1, 200, (n, k))),
        "f2": r.uniform(1.1, 2.5, (n, k)),
    }


def _on(stack, dev, tags=torch.int32):
    return {key: torch.tensor(v, device=dev, dtype=tags if key in ("type", "fr")
                              else torch.float32) for key, v in stack.items()}


def _tables(r, dev):
    return tuple(torch.tensor(r.uniform(0, 3, shape + (3,)), dtype=torch.float32, device=dev)
                 for shape in TABLE_SHAPES)


def _uniforms(r, n, dev):
    u = r.uniform(0, 1, (3, n)).astype(np.float32)
    u[:, :4] = [[0.0] * 4, [0.5] * 4, [ONE_MINUS] * 4]
    u[0, 4:8], u[2, 4:8] = [0.25, 0.75, 0.4999, ONE_MINUS], [0.0, 0.49, 0.5, ONE_MINUS]
    return [torch.tensor(x, device=dev) for x in u]


def _bits(x):
    return x.contiguous().view(torch.int32)


def _same(got, ref, what):
    assert got.dtype == ref.dtype and got.shape == ref.shape, (what, got.shape, ref.shape)
    if got.dtype == torch.bool:
        bad = got != ref
    else:
        bad = (_bits(got) != _bits(ref)) & ~(torch.isnan(got) & torch.isnan(ref))
    assert int(bad.sum()) == 0, (what, int(bad.sum()), (got - ref)[bad][:8] if got.dtype
                                 != torch.bool else None)


def _check(lobes, wo, wi, u, present, include_specular=True, tables=()):
    """Each route against its plain version on the same operands, bitwise,
    one launch a call."""
    present = tuple(sorted(present))
    n0 = dict(kbsdf.LAUNCHES)
    lanes = wo.shape[0]
    _same(bx.bsdf_f(lobes, wo, wi, present, include_specular, tables),
          bx.bsdf_f_plain(lobes, wo, wi, present, include_specular, tables), "f")
    for spec in (include_specular, not include_specular):
        _same(bx.bsdf_pdf(lobes, wo, wi, present, spec),
              bx.bsdf_pdf_plain(lobes, wo, wi, present, spec), f"pdf {spec}")
    got = bx.bsdf_sample(lobes, wo, *u, present, include_specular, tables)
    ref = bx.bsdf_sample_plain(lobes, wo, *u, present, include_specular, tables)
    assert set(got) == set(ref)
    for key in ref:
        _same(got[key], ref[key], f"sample {key}")
    torch.cuda.synchronize()
    want = 1 if lanes else 0
    assert kbsdf.LAUNCHES == {"f": n0["f"] + want, "pdf": n0["pdf"] + 2 * want,
                              "sample": n0["sample"] + want}


@pytest.mark.card
@pytest.mark.parametrize("ltype", KERNEL_TYPES, ids=[NAMES[t] for t in KERNEL_TYPES])
def test_each_lobe_type_alone(ltype, card):
    """One slot of one type (and NONE) under each Fresnel kind, both
    include_specular, wi random and at the sampled directions; MEASURED
    with and without tables."""
    r = np.random.default_rng(ltype)
    lobes = _on(_stack(r, N, (ltype,), 1), card)
    wo = torch.tensor(_directions(r, N), device=card)
    wi = torch.tensor(_directions(r, N)[::-1].copy(), device=card)
    wi[6:12] = -wo[6:12]
    wi[12:18] = wo[12:18] * torch.tensor([-1.0, -1.0, 1.0], device=card)
    u = _uniforms(r, N, card)
    for tables in ((), _tables(r, card)) if ltype == bx.MEASURED else ((),):
        for spec in (True, False):
            _check(lobes, wo, wi, u, (ltype,), spec, tables)
            # f and pdf where the plain version samples
            wi_s = bx.bsdf_sample_plain(lobes, wo, *u, (ltype,), spec, tables)["wi"]
            _check(lobes, wo, wi_s, u, (ltype,), spec, tables)


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_mixed_stacks(k, card):
    """Every kernel type mixed in stacks of K slots with NONE padding, and
    mesh100k's (LAMBERT, BLINN) pair; int64 tags."""
    r = np.random.default_rng(100 + k)
    wo = torch.tensor(_directions(r, N), device=card)
    wi = torch.tensor(_directions(r, N), device=card)
    u = _uniforms(r, N, card)
    tables = _tables(r, card)
    for types in (KERNEL_TYPES, (bx.LAMBERT, bx.BLINN),
                  (bx.LAMBERT, bx.SPEC_REFL, bx.SPEC_TRANS)):
        stack = _stack(r, N, types, k)
        for tags in (torch.int32, torch.int64):
            lobes = _on(stack, card, tags)
            for spec in (True, False):
                _check(lobes, wo, wi, u, types, spec, tables)
    # present narrower than the slots' types: the others give nothing
    lobes = _on(_stack(r, N, KERNEL_TYPES, k), card)
    _check(lobes, wo, wi, u, (bx.LAMBERT, bx.BLINN, bx.SPEC_TRANS))


@pytest.mark.card
def test_slot_choice(card):
    """The sampled slot is the `which`-th matching one (the plain version's
    cumsum pick): Blinn slots of distinct exponents between NONE slots, each
    lane's wi equal to its picked slot's sample and to no other slot's."""
    r = np.random.default_rng(7)
    k = 4
    stack = _stack(r, N, (bx.BLINN,), k)
    stack["f0"] = np.broadcast_to(np.array([3.0, 30.0, 300.0, 3000.0]), (N, k)).copy()
    lobes = _on(stack, card)
    wo = torch.tensor(_directions(r, N), device=card)
    u = _uniforms(r, N, card)
    got = bx.bsdf_sample(lobes, wo, *u, (bx.BLINN,))
    match = stack["type"] != bx.NONE
    n_match = match.sum(1)
    which = np.minimum((u[2].cpu().numpy() * n_match.astype(np.float32)).astype(np.int32),
                       np.maximum(n_match - 1, 0))
    want = np.where(n_match > 0,
                    np.argmax(match & (np.cumsum(match, 1) == (which + 1)[:, None]), 1), 0)
    cand = torch.stack([bx.lobe_sample_wi(lobes["type"][:, j], wo, u[0], u[1],
                                          lobes["f0"][:, j], None, (bx.BLINN,))[0]
                        for j in range(k)], 1)
    hit = (_bits(cand) == _bits(got["wi"])[:, None]).all(-1).cpu().numpy()
    live = n_match > 0
    assert hit[np.arange(N), want][live].all()
    # where the matching slots' samples differ, no other slot's is the same
    keys = _bits(cand).cpu().numpy()
    distinct = np.array([len({tuple(keys[i, j]) for j in range(k) if match[i, j]})
                         == n_match[i] for i in range(N)])
    assert distinct[live].mean() > 0.99
    assert (hit.sum(1)[live & distinct] == 1).all()
    _check(lobes, wo, wo.flip(0), u, (bx.BLINN,))


@pytest.mark.card
def test_strided_expanded_and_empty_operands(card):
    """wo and wi as column views of wider tensors and expanded from one
    direction, slot fields expanded across lanes (megabatch's constant
    tags, bsdftest's columns); zero lanes launch nothing."""
    r = np.random.default_rng(11)
    types = (bx.LAMBERT, bx.BLINN, bx.FRESNEL_BLEND, bx.SPEC_TRANS)
    lobes = _on(_stack(r, N, types, 3), card)
    wide = torch.tensor(r.normal(size=(N, 7)).astype(np.float32), device=card)
    wo = torch.nn.functional.normalize(wide[:, 1:4], dim=1)
    wo_strided = torch.empty((N, 6), device=card)[:, ::2]
    wo_strided.copy_(wo)
    wi = torch.tensor(_directions(r, 1), device=card).expand(N, 3)
    u = _uniforms(r, N, card)
    u_strided = [x for x in torch.stack(u, 1).unbind(1)]
    _check(lobes, wo_strided, wi, u_strided, types)
    _check(lobes, wi, wo_strided, u, types)
    row = {key: v[:1].expand(N, *v.shape[1:]) for key, v in lobes.items()}
    _check(row, wo, wi, u, types)
    _check({key: v[:0] for key, v in lobes.items()}, wo[:0], wi[:0], [x[:0] for x in u],
           types)


@pytest.mark.card
def test_routes(card):
    """Every CUDA call is the kernel's: one that records a gradient launches
    once more in backward, MEASURED reads its tables on the card; any other
    call the kernel cannot take raises, launching nothing."""
    r = np.random.default_rng(3)
    lobes = _on(_stack(r, 64, (bx.LAMBERT, bx.BLINN), 2), card)
    wo = torch.tensor(_directions(r, 64), device=card)
    u = _uniforms(r, 64, card)
    present = (bx.LAMBERT, bx.BLINN)
    tables = _tables(r, card)
    assert kbsdf.plan({"type": lobes["type"]}, (wo, wo), (), tables) == "kernel"
    assert kbsdf.plan({"type": lobes["type"].cpu()}, (wo.cpu(),)) == "cpu"
    n0, b0 = dict(kbsdf.LAUNCHES), dict(kbsdf.BACKWARD)
    grad = dict(lobes, R=lobes["R"].clone().requires_grad_())
    bx.bsdf_f(grad, wo, wo, present).sum().backward()
    assert grad["R"].grad is not None
    with torch.no_grad():
        bx.bsdf_f(grad, wo, wo, present)
    bx.bsdf_f(lobes, wo, wo, present + (bx.MEASURED,), tables=tables)
    assert kbsdf.LAUNCHES == dict(n0, f=n0["f"] + 3)
    assert kbsdf.BACKWARD == dict(b0, f=b0["f"] + 1)
    for bad in (dict(lobes, f0=lobes["f0"].double()), dict(lobes, type=lobes["type"].float()),
                dict(lobes, R=lobes["R"][:, :, :2])):
        with pytest.raises(ValueError, match="BSDF kernel takes"):
            bx.bsdf_f(bad, wo, wo, present)
    with pytest.raises(ValueError, match="BSDF kernel takes"):
        bx.bsdf_sample(lobes, wo, u[0][:, None], u[1], u[2], present)
    with pytest.raises(ValueError, match="one CUDA device"):
        bx.bsdf_pdf(lobes, wo.cpu(), wo, present)
    with pytest.raises(ValueError, match="measured tables"):
        bx.bsdf_f(lobes, wo, wo, present, tables=(tables[0][..., :2],))
    with pytest.raises(ValueError, match="measured tables"):
        bx.bsdf_f(lobes, wo, wo, present, tables=(tables[0].clone().requires_grad_(),))
    assert kbsdf.LAUNCHES == dict(n0, f=n0["f"] + 3)


FLOAT_FIELDS = ("R", "S1", "S2", "f0", "f1", "f2")


def _grads(route, lobes, wo, wi, u, present, tables, kernel, dtype=torch.float32):
    """The gradients of random cotangents on a route's outputs in each float
    operand it reads, through the kernel or through the plain version (in
    `dtype`: float64 gives the exact gradient to compare with)."""
    def leaf(x):
        return x.to(dtype).requires_grad_()
    leaves = {key: leaf(v) for key, v in lobes.items()
              if key in FLOAT_FIELDS and not (key == "f1" and bx.MEASURED in present)}
    ops = dict(lobes, **leaves)
    wo, wi = leaf(wo), leaf(wi)
    u = [leaf(x) for x in u[:2]] + [u[2].to(dtype)]
    if route == "f":
        fn = bx.bsdf_f if kernel else bx.bsdf_f_plain
        outs = [fn(ops, wo, wi, present, True, tables)]
    elif route == "pdf":
        fn = bx.bsdf_pdf if kernel else bx.bsdf_pdf_plain
        outs = [fn(ops, wo, wi, present, False)]
        leaves = {key: leaves[key] for key in ("f0", "f1") if key in leaves}
    else:
        fn = bx.bsdf_sample if kernel else bx.bsdf_sample_plain
        got = fn(ops, wo, *u, present, True, tables)
        outs = [got["wi"], got["f"], got["pdf"]]
    ins = dict(leaves, wo=wo, **({"u1": u[0], "u2": u[1]} if route == "sample" else {"wi": wi}))
    gen = torch.Generator(device=wo.device).manual_seed(9)
    pairs = [(x, torch.randn(x.shape, generator=gen, device=x.device).to(dtype))
             for x in outs]
    pairs = [(x, c) for x, c in pairs if x.requires_grad]
    got = torch.autograd.grad([x for x, _ in pairs], list(ins.values()),
                              [c for _, c in pairs], allow_unused=True)
    return {key: (torch.zeros_like(ins[key]) if g is None else g).float()
            for key, g in zip(ins, got)}


@pytest.mark.card
@pytest.mark.parametrize("route", ["f", "pdf", "sample"])
def test_gradients(route, card):
    """Each float operand's gradient through the kernel's backward against
    the plain version's autograd, every lobe type alone and mixed, K = 1
    and 2, MEASURED with tables: finite wherever the plain version's is,
    and each entry within 1e-3 of it for bsdf_f and bsdf_pdf, 1e-4 for
    bsdf_sample (or 1e-5 of the largest entry), or else within twice the
    plain version's own error, plus 1e-3, of the exact gradient (the plain
    version in float64), with all but one entry in a thousand within the
    first bound. The second bound is float32's where a derivative cancels:
    bsdf_sample's wi carries the slope of tan, pow and the refraction near
    their poles; the conductor's Fresnel term near grazing is a quotient of
    two nearly equal sums; and on the horizon lanes (wo.z = 0) a delta
    lobe's value divides by the 1e-6 floor of |cos|, where the plain
    version's last-bit residue in a derivative that is exactly 0 becomes
    ~1e-2 and the kernel's is 0. One backward launch a call."""
    r = np.random.default_rng(40 + ["f", "pdf", "sample"].index(route))
    n = 2053
    cases = [(t,) for t in KERNEL_TYPES] + [KERNEL_TYPES, (bx.LAMBERT, bx.BLINN)]
    for types in cases:
        for k in (1, 2):
            lobes = _on(_stack(r, n, types, k), card)
            wo = torch.tensor(_directions(r, n), device=card)
            wi = torch.tensor(_directions(r, n), device=card)
            u = [x.clamp(0.01, 0.99) for x in _uniforms(r, n, card)]
            present = tuple(sorted(types))
            tables = _tables(r, card) if bx.MEASURED in types else ()
            b0 = dict(kbsdf.BACKWARD)
            got = _grads(route, lobes, wo, wi, u, present, tables, True)
            assert kbsdf.BACKWARD == dict(b0, **{route: b0[route] + 1})
            ref = _grads(route, lobes, wo, wi, u, present, tables, False)
            exact = _grads(route, lobes, wo, wi, u, present, tables, False, torch.float64)
            for key, want in ref.items():
                have = got[key]
                finite = torch.isfinite(want)
                assert bool(torch.isfinite(have[finite]).all()), (types, k, key)
                scale = float(want[finite].abs().max()) if bool(finite.any()) else 0.0
                close = torch.isclose(have, want, rtol=1e-3 if route != "sample" else 1e-4,
                                      atol=1e-5 * scale) | ~finite
                rounding = ((have - exact[key]).abs()
                            <= 2.0 * (want - exact[key]).abs() + 1e-3 * exact[key].abs())
                what = (NAMES.get(types[0]) if len(types) == 1 else types, k, key,
                        have[~close][:4], want[~close][:4], exact[key][~close][:4])
                assert bool((close | rounding).all()), what
                assert float(close.float().mean()) >= 0.999, what


@pytest.mark.card
def test_a_cornell_gradient_step_runs_on_the_kernel(card):
    """One 1-spp wave of the Cornell box at 32x32, path depth 5,
    differentiated in its constant albedos (cornell.train's leaves) and its
    vertices (which reach wo and wi): every BSDF call launches the kernel,
    the backward its vector-Jacobian product, and the gradients are the
    plain version's within 1e-3 (1e-4 of the largest entry below that)."""
    scene, meta, _ = cornell_box(32, 32, 1, device=card)
    cfg = IntegratorConfig(kind="path", max_depth=5)

    def grads():
        const = scene["tex_data"]["const"].clone().requires_grad_()
        verts = scene["verts"].clone().requires_grad_()
        s = dict(scene, verts=verts, tex_data=dict(scene["tex_data"], const=const))
        film = render_wave(s, meta, cfg, flm.new_film(meta.xres, meta.yres, card), 0,
                           device=card)
        flm.develop(film).mean().backward()
        return {"const": const.grad, "verts": verts.grad}

    n0, b0 = dict(kbsdf.LAUNCHES), dict(kbsdf.BACKWARD)
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = grads()
    spans = collections.Counter(s.name for s in telemetry.SPANS)
    telemetry.reset()
    launches = {key: kbsdf.LAUNCHES[key] - n0[key] for key in kbsdf.ROUTES}
    backward = {key: kbsdf.BACKWARD[key] - b0[key] for key in kbsdf.ROUTES}
    assert launches["sample"] == spans["bsdf_sample"] > 0
    assert launches["f"] + launches["pdf"] == spans["bsdf_eval"] > 0
    assert backward["sample"] > 0 and backward["f"] > 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kbsdf, "plan", lambda *a, **k: "cpu")
        want = grads()
    for key in want:
        scale = float(want[key].abs().max())
        assert scale > 0, key
        torch.testing.assert_close(got[key], want[key], rtol=1e-3, atol=1e-4 * scale)


@pytest.mark.card
def test_a_mesh100k_render_launches_one_a_call(card):
    """mesh100k at 64x64, 4 spp, path depth 5 (the cells' LAMBERT and BLINN
    stack): every bsdf_f, bsdf_pdf and bsdf_sample call is one launch of
    the kernel, and no lobe-slot scan runs."""
    scene, meta, _ = mesh_scene(64, 64, 4, device=card)
    cfg = IntegratorConfig(kind="path", max_depth=5)
    render(scene, meta, cfg, spp=4, device=card)
    n0 = dict(kbsdf.LAUNCHES)
    telemetry.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        render(scene, meta, cfg, spp=4, device=card)
        torch.cuda.synchronize()
    spans = collections.Counter(s.name for s in telemetry.SPANS)
    telemetry.reset()
    events = prof.events()
    names = {e.name for e in events} | {kern.name for e in events
                                        for kern in getattr(e, "kernels", ())}
    launches = {key: kbsdf.LAUNCHES[key] - n0[key] for key in kbsdf.ROUTES}
    assert launches["sample"] == spans["bsdf_sample"] > 0
    assert launches["f"] + launches["pdf"] == spans["bsdf_eval"] > 0
    assert any("bsdf_kernel" in name for name in names)
    assert not any("scan_innermost" in name for name in names)
