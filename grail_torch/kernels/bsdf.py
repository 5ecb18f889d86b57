"""The BSDF lobe stack on the card: the CUDA kernel in csrc/bsdf.cu behind
shade/bsdf.py::bsdf_f, bsdf_pdf and bsdf_sample, whose CUDA tensors it
takes. The plain version is shade/bsdf.py's bsdf_f_plain, bsdf_pdf_plain
and bsdf_sample_plain; the kernel repeats their arithmetic in their order,
so f, pdf, wi and the sampled slot are their bits.

Replaces no TPU kernel (the reference's BSDF stack is XLA-fused
elementwise code). The plain version makes ~50-260 small launches a call
on a two-slot stack (the Blinn lobe's Fresnel term computes the dielectric
and the conductor for every lane; bsdf_sample's slot pick is an int64
`cumsum` over the slots); the kernel does a call in one launch, one thread
a lane, bound by the ~80-100 B a lane it moves. Every lobe type is the
kernel's, MEASURED's table lookup included.

A call that records a gradient is one launch forward and one backward
(_Vjp): the backward runs the lane's forward over dual numbers once a
float operand that wants a gradient, with autograd's derivative for each
operation, so its gradients are the plain version's up to rounding. The
tags, the uniform that picks the slot and the measured tables take none.

`plan` decides from the operands alone (devices, dtypes, shapes: plain
Python, no launch) whether a call is the kernel's or the CPU's, and the
wrapper reads every operand through its strides, so it launches nothing
but the kernel: no cast, no copy, no gather. A CUDA call the kernel cannot
take is an error, never a silent fall back to the plain version.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

ROUTES = ("f", "pdf", "sample")

# Kernel launches by route in this process: the calls, and their backwards.
LAUNCHES = dict.fromkeys(ROUTES, 0)
BACKWARD = dict.fromkeys(ROUTES, 0)

# csrc/bsdf.cu's operands in its order (the slot fields, the directions,
# bsdf_sample's uniforms) and its outputs
OPERANDS = ("type", "fr", "R", "S1", "S2", "f0", "f1", "f2", "wo", "wi", "u1", "u2", "uc")
_OUTPUTS = ("f", "pdf", "wi", "specular", "valid")
_RETURNS = {"f": ("f",), "pdf": ("pdf",), "sample": ("wi", "f", "pdf", "specular", "valid")}
_TAGS = ("type", "fr")
# the operands bsdf_sample's wi and pdf depend on (a colour enters only f)
_STEERING = ("wo", "u1", "u2", "f0", "f1", "f2")
_COLOURS = ("R", "S1", "S2")
_INT_TYPES = (torch.int32, torch.int64)
MAX_TABLES = 16
# csrc/bsdf.cu's struct Args: six header words, four an operand and a
# table, the five outputs, three cotangents and one gradient an operand
_ARGS_LEN = 6 + 4 * len(OPERANDS) + 4 * MAX_TABLES + len(_OUTPUTS) + 4 * 3 + len(OPERANDS)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The built library's C entry, with its signature declared."""
    fn = build.load("bsdf").grail_bsdf
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(fields, directions, uniforms=(), tables=()):
    """The version that takes a call on the slot fields it reads (`fields`,
    "type" among them), the (N, 3) `directions` (wo, and wi for f and pdf),
    the (N,) `uniforms` (bsdf_sample's three) and the measured `tables`:
    "cpu" where no tensor is on a CUDA device (the plain version), else
    "kernel". Raises ValueError for a CUDA call the kernel cannot take:
    tensors on two devices, a float operand not float32, a tag tensor not
    int32 or int64, other shapes than (N, K) slots, (N, K, 3) colours,
    (N, 3) directions and (N,) uniforms, more than MAX_TABLES tables or one
    not a contiguous float32 (nh, nd, npd, 3) tensor, or a table that
    requires a gradient where autograd records."""
    tensors = [*fields.values(), *directions, *uniforms, *tables]
    if not any(t.is_cuda for t in tensors):
        return "cpu"
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError("the BSDF kernel takes operands on one CUDA device; got "
                         f"{sorted({str(t.device) for t in tensors})}")
    tags = fields["type"]
    n, k = tags.shape if tags.dim() == 2 else (-1, -1)
    got = {**fields, **{f"direction {i}": t for i, t in enumerate(directions)},
           **{f"uniform {i}": t for i, t in enumerate(uniforms)}}

    def wanted(key):
        if key in fields:
            return ((n, k, 3) if key in _COLOURS else (n, k),
                    _INT_TYPES if key in _TAGS else (torch.float32,))
        return ((n, 3) if key.startswith("direction") else (n,)), (torch.float32,)
    bad = [f"{key} {tuple(t.shape)} {t.dtype}" for key, t in got.items()
           if tuple(t.shape) != wanted(key)[0] or t.dtype not in wanted(key)[1]]
    if n < 0 or bad:
        raise ValueError("the BSDF kernel takes (N, K) int32/int64 tags, (N, K[, 3]) "
                         "float32 slots, (N, 3) float32 directions and (N,) float32 "
                         f"uniforms; got {', '.join(bad) or f'tags {tuple(tags.shape)}'}")
    bad = [f"{tuple(t.shape)} {t.dtype}" for t in tables
           if t.dim() != 4 or t.shape[-1] != 3 or t.dtype != torch.float32
           or not t.is_contiguous()]
    if len(tables) > MAX_TABLES or bad:
        raise ValueError(f"the BSDF kernel takes up to {MAX_TABLES} contiguous float32 "
                         f"(nh, nd, npd, 3) measured tables; got {len(tables)}: {bad}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tables):
        raise ValueError("the BSDF kernel takes no gradient in the measured tables")
    return "kernel"


def _operand(t, channel_last=False):
    """(pointer, lane, slot, channel strides) of an (N, K, 3) colour, an
    (N, K) slot field, an (N,) uniform or, with channel_last, an (N, 3)
    direction; zeros for None."""
    if t is None:
        return (0, 0, 0, 0)
    st = (*t.stride(), 0, 0)
    return (t.data_ptr(), st[0], 0, st[1]) if channel_last else (t.data_ptr(), *st[:3])


def _block(static, operands, outs=None, cots=None, grads=None):
    """The argument block (struct Args) of a launch: the call's `static`
    part (route, present's bit mask, include_specular, tables), its
    operands in OPERANDS order, and the outputs of a forward launch or the
    outputs' cotangents and the operands' gradients of a backward one."""
    _, mask, include_specular, tables = static
    n, k = operands[0].shape
    wide = sum(1 << i for i, t in enumerate(operands[:2])
               if t is not None and t.dtype == torch.int64)
    words = [n, k, mask, int(include_specular), wide, len(tables)]
    for name, t in zip(OPERANDS, operands):
        words += _operand(t, name in ("wo", "wi"))
    for i in range(MAX_TABLES):
        words += ([tables[i].data_ptr(), *tables[i].shape[:3]] if i < len(tables)
                  else [0, 0, 0, 0])
    outs, cots = outs or {}, cots or {}
    words += [outs[key].data_ptr() if key in outs else 0 for key in _OUTPUTS]
    for key in ("f", "pdf", "wi"):
        words += _operand(cots.get(key), key != "pdf")
    words += [g.data_ptr() if g is not None else 0 for g in (grads or [None] * len(OPERANDS))]
    return (ctypes.c_longlong * _ARGS_LEN)(*words)


def _run(route, backward, block, device):
    """One launch of the kernel on `device`'s current stream."""
    with torch.cuda.device(device):
        err = _launcher()(ROUTES.index(route), int(backward), block, _ARGS_LEN,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"BSDF kernel launch failed (CUDA error {err})")


def _forward(static, operands):
    """The call's outputs, in _RETURNS order: one launch, none for no lanes."""
    route = static[0]
    n = operands[0].shape[0]
    dev = operands[0].device
    shapes = {"f": (n, 3), "pdf": (n,), "wi": (n, 3), "specular": (n,), "valid": (n,)}
    outs = {key: torch.empty(shapes[key], device=dev,
                             dtype=torch.bool if key in ("specular", "valid") else torch.float32)
            for key in _RETURNS[route]}
    if n > 0:
        _run(route, False, _block(static, operands, outs=outs), dev)
        LAUNCHES[route] += 1
    return tuple(outs[key] for key in _RETURNS[route])


class _Vjp(torch.autograd.Function):
    """A call that records a gradient: forward as _forward, backward one
    launch of the kernel's vector-Jacobian product, which writes a dense
    gradient of each float operand that needs one. Use:
    _Vjp.apply(static, *operands)."""

    @staticmethod
    def forward(ctx, static, *operands):
        outs = _forward(static, operands)
        ctx.static = static
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*operands)
        if static[0] == "sample":
            # wi, and pdf through it, depend on no colour: where only colours
            # require a gradient, they carry none, as in the plain version
            wanted = {name for name, t in zip(OPERANDS, operands)
                      if t is not None and t.requires_grad}
            steers = not wanted.isdisjoint(_STEERING)
            ctx.mark_non_differentiable(*outs[3:], *(() if steers else (outs[0], outs[2])))
        return outs

    @staticmethod
    def backward(ctx, *cots):
        route = ctx.static[0]
        operands = ctx.saved_tensors
        want = ctx.needs_input_grad[1:]
        grads = [torch.empty(t.shape, dtype=torch.float32, device=t.device) if w else None
                 for t, w in zip(operands, want)]
        n = operands[0].shape[0]
        if n > 0 and any(want):
            cots = {key: c for key, c in zip(_RETURNS[route], cots)
                    if key in ("f", "pdf", "wi")}
            _run(route, True, _block(ctx.static, operands, cots=cots, grads=grads),
                 operands[0].device)
            BACKWARD[route] += 1
        return (None, *grads)


def launch(route, fields, present, wo, wi=None, uniforms=(), include_specular=True,
           tables=()):
    """The kernel for `route` on a call that `plan` sent to it: the slot
    `fields` the present lobe types read (the kernel reads no other), the
    stack's lobe types `present`, wo, and wi
    (f, pdf) or the three uniforms (sample). Returns bsdf_f's (N, 3) f,
    bsdf_pdf's (N,) pdf, or bsdf_sample's dict (wi, f, pdf, specular,
    valid); where autograd records and an operand requires a gradient, the
    outputs carry the kernel's backward."""
    ops = dict(fields, wo=wo, wi=wi, **dict(zip(("u1", "u2", "uc"), uniforms)))
    operands = [ops.get(name) for name in OPERANDS]
    static = (route, sum(1 << t for t in set(present)), bool(include_specular), tuple(tables))
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in operands):
        outs = _Vjp.apply(static, *operands)
    else:
        outs = _forward(static, operands)
    return dict(zip(_RETURNS[route], outs)) if route == "sample" else outs[0]
