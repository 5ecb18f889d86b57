"""Ray-scene intersection (port of grail/kernels/intersect.py, brute route).

Hit record (dict of (N,) tensors): t, prim (int32, -1 = miss), b1, b2.
Scenes with a BVH or instances take routes that are not ported yet: the
dispatch raises for them rather than picking something else.
"""
from __future__ import annotations

import torch

from ..core.vecmath import cross, dot
from ..device import check_on, resolve_device
from .brute_intersect import brute_intersect

BIG_T = 3.0e37


def moller_trumbore(o, d, v0, e1, e2, tmin, tmax):
    """Batched Möller-Trumbore over broadcastable (...,3) operands. Returns
    (hit, t, b1, b2): divisor == 0 is a miss, b1, b2 in [0,1], b1+b2 <= 1,
    t in (tmin, tmax)."""
    s1 = cross(d, e2)
    divisor = dot(s1, e1)
    inv = 1.0 / torch.where(divisor == 0.0, 1.0, divisor)
    s = o - v0
    b1 = dot(s, s1) * inv
    s2 = cross(s, e1)
    b2 = dot(d, s2) * inv
    t = dot(e2, s2) * inv
    hit = ((divisor != 0.0) & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0)
           & (b1 + b2 <= 1.0) & (t > tmin) & (t < tmax))
    return hit, t, b1, b2


def _tri_edges(scene):
    idx = scene["tri_idx"]
    v0 = scene["verts"][idx[:, 0]]
    return v0, scene["verts"][idx[:, 1]] - v0, scene["verts"][idx[:, 2]] - v0


def pack_tris(scene):
    """(T,9) [v0|e1|e2] table from the scene SoA."""
    return torch.cat(_tri_edges(scene), dim=-1).contiguous()


def intersect_brute(scene, o, d, tmax, tmin=None):
    """All-pairs rays x triangles with moller_trumbore (the reference's
    small-scene oracle). Memory O(N*T)."""
    v0, e1, e2 = _tri_edges(scene)
    if tmin is None:
        tmin = torch.zeros_like(tmax)
    hit, t, b1, b2 = moller_trumbore(o[:, None], d[:, None], v0[None], e1[None],
                                     e2[None], tmin[:, None], tmax[:, None])
    t_masked = torch.where(hit, t, BIG_T)
    best = torch.argmin(t_masked, dim=1)[:, None]
    best_t = torch.gather(t_masked, 1, best)[:, 0]
    any_hit = best_t < BIG_T
    return {"t": torch.where(any_hit, best_t, BIG_T),
            "prim": torch.where(any_hit, best[:, 0].to(torch.int32), -1),
            "b1": torch.gather(b1, 1, best)[:, 0],
            "b2": torch.gather(b2, 1, best)[:, 0]}


def intersect_p_brute(scene, o, d, tmax, tmin=None):
    """Shadow-ray occlusion by the all-pairs oracle: occluded (N,) bool."""
    v0, e1, e2 = _tri_edges(scene)
    if tmin is None:
        tmin = torch.zeros_like(tmax)
    hit, _, _, _ = moller_trumbore(o[:, None], d[:, None], v0[None], e1[None],
                                   e2[None], tmin[:, None], tmax[:, None])
    return torch.any(hit, dim=1)


def _brute_args(scene, o, d, tmax, tmin, device):
    check_on(o, resolve_device(device), "the rays")
    for key in ("bvh", "inst", "ring"):
        if scene.get(key) is not None:
            raise NotImplementedError(
                f"scene has a {key!r} table: that intersection route is not "
                "ported yet (brute force only)")
    if tmin is None:
        tmin = torch.zeros_like(tmax)
    return (pack_tris(scene), o.contiguous(), d.contiguous(), tmin.contiguous(),
            tmax.contiguous())


def intersect(scene, o, d, tmax, tmin=None, device=None):
    """Closest hit (Scene::Intersect analog). The kernel returns t = tmax on a
    miss; the dispatch then sets t = BIG_T."""
    t, prim, b1, b2 = brute_intersect(*_brute_args(scene, o, d, tmax, tmin, device))
    return {"t": torch.where(prim >= 0, t, BIG_T), "prim": prim, "b1": b1, "b2": b2}


def intersect_p(scene, o, d, tmax, tmin=None, device=None):
    """Occlusion test (Scene::IntersectP analog): occluded (N,) bool."""
    _, prim, _, _ = brute_intersect(*_brute_args(scene, o, d, tmax, tmin, device),
                                    any_hit=True)
    return prim >= 0
