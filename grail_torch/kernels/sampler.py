"""The sampler's draws on the card: the CUDA kernel in csrc/sampler.cu
behind core/rng.py::sample_1d and sample_2d, whose CUDA tensors it takes.
The plain version is core/rng.py::sample_1d_plain and sample_2d_plain; the
kernel repeats their arithmetic and their rounding, so every draw is their
bits.

Replaces no TPU kernel (the reference's draws are XLA-fused elementwise).
The plain version issues about 74 small int64 kernels a 1D ZERO_TWO draw
and 137 a 2D one, which also copies the Sobol XOR table to the card in a
host wait; the kernel does a call in one launch, bound by the ~24 B a lane
it moves.

`plan` and `layout` decide from the operands alone (their devices, dtypes,
shapes and strides: plain Python, no launch) whether a call takes the
kernel and how the kernel reads each operand, so the wrapper launches
nothing but the kernel: no cast, no mask, no copy. A call on CUDA tensors
that the kernel cannot take is an error, never a silent fall back to the
plain version's ~74-137 launches.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build

ROUTES = ("sample_1d", "sample_2d")

# Kernel launches from each function in this process.
LAUNCHES = dict.fromkeys(ROUTES, 0)

_M32 = 0xFFFFFFFF
_INT_TYPES = (torch.int64, torch.int32)


@functools.lru_cache(maxsize=None)
def _launcher():
    """The built library's C entry, with its signature declared."""
    fn = build.load("sampler").grail_sampler
    operand = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint32]
    fn.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_float] + operand * 3
                   + [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def plan(operands):
    """(on_card, shape) of a draw on `operands` (pixel id, sample index,
    dimension: tensors or Python ints). shape is their broadcast shape (()
    for ints alone). on_card is False where no operand is a CUDA tensor (CPU
    tensors and Python ints take the plain version) and True where the
    kernel takes the call. Raises ValueError for a CUDA call the kernel
    cannot take: a broadcast past 2-D, another dtype than int64 or int32,
    or tensors on two devices."""
    tensors = [x for x in operands if isinstance(x, torch.Tensor)]
    shapes = [t.shape for t in tensors]
    if shapes and all(s == shapes[0] for s in shapes):
        shape = shapes[0]
    else:
        shape = torch.broadcast_shapes(*shapes)
    if not any(t.is_cuda for t in tensors):
        return False, shape
    device = tensors[0].device
    if len(shape) > 2 or any(t.device != device or t.dtype not in _INT_TYPES
                             for t in tensors):
        raise ValueError(
            "the sampler kernel takes int64 or int32 operands on one CUDA device, "
            f"broadcast to at most 2-D; got shape {tuple(shape)}, "
            f"{[(t.dtype, str(t.device)) for t in tensors]}")
    return True, shape


def layout(shape, operands):
    """The kernel's 2-D view of `operands` broadcast to `shape` (at most
    2-D): (cols, strides), a 0-d or 1-D shape being one row of cols lanes.
    strides holds each operand's (row, column) element strides, 0 along an
    axis it is broadcast on (a missing or size-1 dim), and None for a Python
    int."""
    strides = []
    for x in operands:
        if not isinstance(x, torch.Tensor):
            strides.append(None)
            continue
        st = [0, 0]
        for k in range(1, x.dim() + 1):
            if x.shape[-k] != 1:
                st[-k] = x.stride(-k)
        strides.append(tuple(st))
    return (shape[-1] if shape else 1), strides


def draw(name, params, shape, operands):
    """One launch of the kernel for `name` ("sample_1d" or "sample_2d") on
    operands that `plan` sent to it: a float32 tensor of `shape`, or for
    sample_2d one (2, *shape) buffer. params: (kind, seed, m0, m1, f0, f1),
    core/rng.py::_kernel_params."""
    two = name == "sample_2d"
    device = next(x.device for x in operands if isinstance(x, torch.Tensor))
    out = torch.empty(((2,) if two else ()) + tuple(shape), dtype=torch.float32,
                      device=device)
    n = math.prod(shape)
    if n == 0:
        return out
    cols, strides = layout(shape, operands)
    args, wide = [], 0
    for k, (x, st) in enumerate(zip(operands, strides)):
        if st is None:
            args += (None, 0, 0, int(x) & _M32)
        else:
            args += (x.data_ptr(), st[0], st[1], 0)
            wide |= (x.dtype == torch.int64) << k
    kind, *rest = params
    with torch.cuda.device(device):
        err = _launcher()(kind, int(two), *rest, *args, wide, cols, n, out.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"sampler kernel launch failed (CUDA error {err})")
    LAUNCHES[name] += 1
    return out
