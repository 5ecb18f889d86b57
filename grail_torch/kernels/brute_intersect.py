"""Brute-force closest-hit / any-hit over a packed triangle table: the CUDA
kernel in csrc/brute_intersect.cu and its plain PyTorch version.

Replaces grail/kernels/pallas_intersect.py::_kernel (TPU). The kernel is
bound by instruction issue on the card (about 55 FP32 operations per
ray-triangle pair against 48 bytes of ray I/O per ray, and no multiply-add
contracted); see the note in the CUDA source for the bound and what the
design does about it. It stages the (T,9) table in shared memory as 48-byte
rows.

`brute_intersect` takes the plain version only for tensors that lie on the
CPU. For CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import telemetry
from . import build

MAX_TRIS = 1024        # 48-byte rows staged in shared memory: 48 KB at the cap

KERNELS = ("brute_intersect", "brute_intersect_any_hit")

# Launches of each CUDA kernel in this process (plain-version calls excluded).
LAUNCHES = dict.fromkeys(KERNELS, 0)


def _launcher(lib=None):
    """The C entry point of the built library (or of `lib`, a ctypes library
    of the same interface), with its signature declared (pointers and the
    stream as c_void_p, so none is cut to 32 bits)."""
    fn = (lib or build.load("brute_intersect")).grail_brute_intersect
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def brute_intersect_plain(tris9, o, d, tmin, tmax, any_hit=False, counts=False):
    """The kernel's arithmetic over all (ray, triangle) pairs, component by
    component. Closest hit takes the first minimum t (argmin returns the
    lowest index among ties, as the kernel's strict compare); any-hit takes
    the first hit in index order, where the kernel stops.

    tris9 (T,9) [v0|e1|e2]; o, d (N,3); tmin, tmax (N,).
    Returns (t, prim, b1, b2): t = tmax, prim = -1, b1 = b2 = 0 on a miss.
    counts=True appends, per ray, the pairs the function needs (a live ray's
    every triangle; for any hit, up to its first hit) that reach each stage
    of the hit predicate, a conjunction: the b1 stage (all of them), the
    s2/b2 stage (those that pass the b1 tests) and the t stage (those that
    pass the b2 tests)."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tris9.unbind(-1)   # (T,)
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))                   # (N,1)
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    s1x = dy * e2z - dz * e2y
    s1y = dz * e2x - dx * e2z
    s1z = dx * e2y - dy * e2x
    divisor = s1x * e1x + s1y * e1y + s1z * e1z
    inv = torch.reciprocal(torch.where(divisor == 0.0, 1.0, divisor))
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    b1 = (sx * s1x + sy * s1y + sz * s1z) * inv
    s2x = sy * e1z - sz * e1y
    s2y = sz * e1x - sx * e1z
    s2z = sx * e1y - sy * e1x
    b2 = (dx * s2x + dy * s2y + dz * s2z) * inv
    t = (e2x * s2x + e2y * s2y + e2z * s2z) * inv
    on_b1 = (divisor != 0.0) & (b1 >= 0.0) & (b1 <= 1.0)
    on_b2 = on_b1 & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    hit = on_b2 & (t > tmin[:, None]) & (t < tmax[:, None])
    if any_hit:
        k = torch.argmax(hit.to(torch.uint8), dim=1)
    else:
        k = torch.argmin(torch.where(hit, t, torch.inf), dim=1)

    def take(a):
        return torch.gather(a, 1, k[:, None])[:, 0]

    found = take(hit)
    out = (torch.where(found, take(t), tmax),
           torch.where(found, k.to(torch.int32), -1),
           torch.where(found, take(b1), 0.0),
           torch.where(found, take(b2), 0.0))
    if not counts:
        return out
    need = (tmax > tmin)[:, None].expand_as(hit)
    if any_hit:
        last = torch.where(found, k, tris9.shape[0] - 1)
        need = need & (torch.arange(tris9.shape[0], device=o.device) <= last[:, None])
    return out + tuple((need & m).sum(1) for m in (need, on_b1, on_b2))


def _check(tris9, o, d, tmin, tmax):
    n = o.shape[0]
    build.check_operands({"tris9": (tris9, (tris9.shape[0], 9)), "o": (o, (n, 3)),
                          "d": (d, (n, 3)), "tmin": (tmin, (n,)),
                          "tmax": (tmax, (n,))}, o.device)
    if tris9.shape[0] > MAX_TRIS:
        raise ValueError(f"{tris9.shape[0]} triangles exceed the kernel's "
                         f"shared-memory table ({MAX_TRIS})")
    if n >= 2**31:
        raise ValueError("too many rays for one launch")


@telemetry.spanned("launch/brute_intersect")
def brute_intersect(tris9, o, d, tmin, tmax, any_hit=False):
    """Closest hit (or first hit, any_hit=True) of each ray over the table.
    Returns (t, prim, b1, b2) as brute_intersect_plain."""
    if o.device.type == "cpu":
        return brute_intersect_plain(tris9, o, d, tmin, tmax, any_hit)
    if o.device.type != "cuda":
        raise ValueError(f"brute_intersect runs on cuda or cpu, not {o.device}")
    _check(tris9, o, d, tmin, tmax)
    out = _launch(_launcher(), tris9, o, d, tmin, tmax, any_hit)
    if o.shape[0]:
        LAUNCHES[KERNELS[int(any_hit)]] += 1
    return out


def _launch(fn, tris9, o, d, tmin, tmax, any_hit):
    """Launch C entry `fn` on checked CUDA operands; returns (t, prim, b1, b2)."""
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    b1 = torch.empty_like(t)
    b2 = torch.empty_like(t)
    if n == 0:
        return t, prim, b1, b2
    with torch.cuda.device(o.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(tris9.data_ptr(), tris9.shape[0], o.data_ptr(), d.data_ptr(),
                 tmin.data_ptr(), tmax.data_ptr(), t.data_ptr(), prim.data_ptr(),
                 b1.data_ptr(), b2.data_ptr(), n, int(any_hit), stream)
    if err != 0:
        raise RuntimeError(f"brute_intersect kernel launch failed (CUDA error {err})")
    return t, prim, b1, b2
