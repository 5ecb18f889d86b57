"""Ray binning before traversal (port of grail/kernels/binning.py).

Rays are sorted into coherence buckets (octant | coarse origin Morton code)
with a stable counting sort, traversed in that order, and their results
gathered back. `rank[i]` is the sorted slot of lane i: the same permutation
as the reference's counting sort, computed here as the inverse of a stable
`torch.sort` of the keys.
"""
from __future__ import annotations

import torch

from .. import telemetry


@telemetry.spanned("binning")
def bucket_rank(key, n_buckets):
    """Stable counting-sort slot per lane: key int in [0, n_buckets).
    Returns rank (N,) int64, a permutation."""
    order = torch.sort(key, stable=True).indices
    rank = torch.empty_like(order)
    rank[order] = torch.arange(key.shape[0], device=key.device)
    return rank


@telemetry.spanned("binning")
def sort_by_rank(rank, *arrays):
    """Scatter each array into bucket-sorted order (rank is a permutation);
    out of place, so gradients flow back through it."""
    return tuple(torch.empty_like(a).index_put((rank,), a) for a in arrays)


@telemetry.spanned("binning")
def unsort(rank, *arrays):
    """Gather sorted-order results back to the original lane order."""
    return tuple(a[rank] for a in arrays)


def _morton3_bits(x, bits):
    """Interleave `bits` bits per axis of points in [0,1)^3."""
    q = torch.clamp(x * (1 << bits), 0.0, (1 << bits) - 1).to(torch.int64)

    def spread(v):
        out = torch.zeros_like(v)
        for i in range(bits):
            out = out | (((v >> i) & 1) << (3 * i))
        return out
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


@telemetry.spanned("binning")
def bin_rays_key(o, d, bmin, bmax, origin_bits=1, dir_bits=0):
    """Coherence key: [octant:3 | origin Morton:3*origin_bits | direction
    Morton:3*dir_bits] (int64). The octant is the high field, so rays of one
    bucket share their near-child order."""
    tn = (o - bmin) / torch.clamp_min(bmax - bmin, 1e-9)
    key = (((d[:, 0] >= 0).to(torch.int64) << 2)
           | ((d[:, 1] >= 0).to(torch.int64) << 1)
           | (d[:, 2] >= 0).to(torch.int64))
    if origin_bits:
        key = (key << (3 * origin_bits)) | _morton3_bits(tn, origin_bits)
    if dir_bits:
        key = (key << (3 * dir_bits)) | _morton3_bits(d * 0.5 + 0.5, dir_bits)
    return key


N_RAY_BUCKETS = 1 << (3 + 3)   # octant x coarse origin Morton
