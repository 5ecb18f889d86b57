"""Ray-scene intersection (port of grail/kernels/intersect.py): the brute
route for scenes without a BVH and, for scenes with one, the 4-wide BVH
route on every wave; scenes with instances add the instanced sweep
(kernels/instanced.py) after the base geometry.

Hit record (dict of (N,) tensors): t, prim (int32, -1 = miss), b1, b2, and
on instanced scenes inst (int32, -1 = not an instance hit). Closest hit is
differentiable on both base routes (ClosestHit: the traversal finds the hit,
the backward differentiates Möller-Trumbore at the hit triangle) and, to
the rays, on instance hits (the same backward in the instance's object
space); any hit returns booleans and has no gradient. Gradients to the
instanced geometry or the instance transforms are not ported: the sweep
raises where one is asked of it. A scene-sharded scene (its "ring", a
rank's shard: dist/scene_shard.py) takes the ring route: every rank's rays
pass around the ring of shards, and the hit carries its triangle's record
(hit["tri"]), since no rank holds the mesh.
"""
from __future__ import annotations

import torch

from .. import telemetry
from ..core.vecmath import cross, dot
from ..device import check_on, resolve_device
from .binning import N_RAY_BUCKETS, bin_rays_key, bucket_rank, sort_by_rank, unsort
from .brute_intersect import brute_intersect
from .bvh4 import bvh4_traverse
from .instanced import gather_pack, instances_intersect, w2o_ray
from ..dist.scene_shard import ring_intersect

BIG_T = 3.0e37
SORT_MIN = 8192     # waves of at least this many rays are binned first

# Closest-hit waves that the dispatch hands to the 4-wide walk, by route:
# binned (sorted first) and unbinned (the tile-ordered camera wave). One
# kernel takes both; chip_smoke.py splits its launches by these counts.
CLOSEST_WAVES = {"binned": 0, "unbinned": 0}


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


class ClosestHit(torch.autograd.Function):
    """Closest hit with the reference's frozen-prim backward (the custom VJPs
    of grail/kernels/bvh_stream.py `_make_intersect` and pallas_intersect.py
    `brute_intersect_pallas`). Forward: `traverse(o, d, tmin, tmax)`, a
    kernel on the card or its plain version on the CPU, gives (t, prim, b1,
    b2). Backward: with each ray's hit triangle held fixed, (t, b1, b2) are
    Möller-Trumbore's closed form at prim, from the rows of the unordered
    (T,9) table pack_tris(scene) (gathered here at prim, so gradients reach
    `verts`); a miss gives t = tmax and b1 = b2 = 0, and no gradient to
    its ray or the triangles. prim gets no cotangent. Use:
    ClosestHit.apply(traverse, verts, tri_idx, o, d, tmin, tmax)."""

    @staticmethod
    def forward(ctx, traverse, verts, tri_idx, o, d, tmin, tmax):
        t, prim, b1, b2 = traverse(o, d, tmin, tmax)
        ctx.mark_non_differentiable(prim)
        ctx.save_for_backward(verts, tri_idx, o, d, tmin, tmax, prim)
        return t, prim, b1, b2

    @staticmethod
    def backward(ctx, g_t, _g_prim, g_b1, g_b2):
        verts, tri_idx, o, d, tmin, tmax, prim = ctx.saved_tensors
        wanted = ctx.needs_input_grad[1:2] + ctx.needs_input_grad[3:]
        ok = prim >= 0
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(w)
                      for a, w in zip((verts, o, d, tmin, tmax), wanted)]
            v, o, d, tmin, tmax = leaves
            idx = tri_idx[prim.clamp_min(0).long()]
            v0 = v[idx[:, 0]]
            # a miss tests triangle 0 with a zero direction: its divisor is
            # exactly 0, so the safe divide keeps every slope finite (a tiny
            # divisor would make the masked lane's zero cotangent a NaN)
            _, t, b1, b2 = moller_trumbore(o, torch.where(ok[:, None], d, 0.0), v0,
                                           v[idx[:, 1]] - v0, v[idx[:, 2]] - v0,
                                           tmin, tmax)
            outs = (torch.where(ok, t, tmax), torch.where(ok, b1, 0.0),
                    torch.where(ok, b2, 0.0))
            need = [a for a in leaves if a.requires_grad]
            got = iter(torch.autograd.grad(outs, need, (g_t, g_b1, g_b2),
                                           allow_unused=True))
        g_v, g_o, g_d, g_tmin, g_tmax = (next(got) if w else None for w in wanted)
        return None, g_v, None, g_o, g_d, g_tmin, g_tmax


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


def _check_routes(scene, o, device):
    """The route of a trace: "ring", the scene's BVH (the 4-wide route) or
    None (brute force)."""
    check_on(o, resolve_device(device), "the rays")
    ring = scene.get("ring")
    if ring is not None:
        if "mesh" not in ring:
            raise ValueError("the scene holds a whole partition, not a rank's shard: "
                             "render it through dist.sharding.render_scene_sharded")
        if scene.get("inst") is not None:
            raise NotImplementedError("the ring route has no instances")
        return "ring"
    bvh = scene.get("bvh")
    if bvh is not None and "bvh4_nodes" not in bvh:
        raise NotImplementedError("a BVH scene needs its 4-wide tables "
                                  "(bvh4_nodes): the only BVH route ported")
    return bvh


def _stream_bvh(scene, o, d, tmax, tmin, any_hit=False, sort=None):
    """BVH traversal with ray binning (the reference's _stream_bvh without
    clustered tables). Waves of SORT_MIN rays or more are counting-sorted
    into coherence buckets first and their results gathered back;
    sort=False marks a tile-ordered camera wave. Every wave, sorted or not,
    closest or any hit, takes the 4-wide walk. Dead lanes (tmax <= tmin, the
    integrator's mask) are made inert and sorted last."""
    bvh = scene["bvh"]
    if sort is None:
        sort = o.shape[0] >= SORT_MIN
    if tmin is None:
        tmin = torch.zeros_like(tmax)
    dead = tmax <= tmin
    tmin = torch.where(dead, BIG_T, tmin)
    tmax = torch.where(dead, -BIG_T, tmax)
    if sort:
        # an instanced scene's verts hold object-space rows (and maybe a
        # far sentinel): it carries its world bounds
        if "world_bounds" in scene:
            lo, hi = scene["world_bounds"]
        else:
            lo, hi = torch.amin(scene["verts"], dim=0), torch.amax(scene["verts"], dim=0)
        key = bin_rays_key(o, d, lo, hi)
        key = torch.where(dead, N_RAY_BUCKETS, key)          # dead lanes last
        rank = bucket_rank(key, N_RAY_BUCKETS + 1)
        o, d, tmin, tmax = sort_by_rank(rank, o, d, tmin, tmax)
    rays = (o.contiguous(), d.contiguous(), tmin.contiguous(), tmax.contiguous())
    if any_hit:
        with torch.no_grad():
            occ = bvh4_traverse(bvh["bvh4_nodes"], bvh["bvh4_tris"], *rays,
                                any_hit=True, stack=bvh["bvh4_stack"])[1] >= 0
        return unsort(rank, occ)[0] if sort else occ

    def traverse(*rays):
        return bvh4_traverse(bvh["bvh4_nodes"], bvh["bvh4_tris"], *rays,
                             stack=bvh["bvh4_stack"])

    t, prim, b1, b2 = ClosestHit.apply(traverse, scene["verts"], scene["tri_idx"],
                                       *rays)
    if o.shape[0]:
        CLOSEST_WAVES["binned" if sort else "unbinned"] += 1
    if sort:
        t, prim, b1, b2 = unsort(rank, t, prim, b1, b2)
    return {"t": torch.where(prim >= 0, t, BIG_T), "prim": prim, "b1": b1, "b2": b2}


def _brute_rays(o, d, tmax, tmin):
    if tmin is None:
        tmin = torch.zeros_like(tmax)
    return o.contiguous(), d.contiguous(), tmin.contiguous(), tmax.contiguous()


@telemetry.spanned("intersect")
def intersect(scene, o, d, tmax, tmin=None, device=None, sort=None, time=None):
    """Closest hit (Scene::Intersect analog). A miss has t = BIG_T.
    sort: ray-binning hint for the stream route (False for camera waves,
    which arrive in tile order). time (N,): the rays' times, which pick the
    animated instance transforms (None: shutter open)."""
    route = _check_routes(scene, o, device)
    if route == "ring":
        return ring_intersect(scene["ring"], o, d, tmax, tmin)
    if route is not None:
        hit = _stream_bvh(scene, o, d, tmax, tmin, sort=sort)
    else:
        t, prim, b1, b2 = ClosestHit.apply(
            lambda *rays: brute_intersect(pack_tris(scene), *rays), scene["verts"],
            scene["tri_idx"], *_brute_rays(o, d, tmax, tmin))
        hit = {"t": torch.where(prim >= 0, t, BIG_T), "prim": prim, "b1": b1, "b2": b2}
    if scene.get("inst") is None:
        return hit
    # an instanced hit strictly inside the base hit's t wins
    ih = _instance_hit(scene, o, d, torch.minimum(tmax, hit["t"]), tmin, time)
    closer = ih["prim"] >= 0
    out = {k: torch.where(closer, ih[k], hit[k]) for k in ("t", "prim", "b1", "b2")}
    out["inst"] = torch.where(closer, ih["inst"], -1)
    return out


@telemetry.spanned("intersect")
def intersect_p(scene, o, d, tmax, tmin=None, device=None, time=None):
    """Occlusion test (Scene::IntersectP analog): occluded (N,) bool."""
    route = _check_routes(scene, o, device)
    if route == "ring":
        return ring_intersect(scene["ring"], o, d, tmax, tmin, any_hit=True)["occluded"]
    if route is not None:
        occ = _stream_bvh(scene, o, d, tmax, tmin, any_hit=True)
    else:
        with torch.no_grad():
            _, prim, _, _ = brute_intersect(pack_tris(scene),
                                            *_brute_rays(o, d, tmax, tmin), any_hit=True)
        occ = prim >= 0
    if scene.get("inst") is None:
        return occ
    # rays the base geometry occludes need no instanced walk
    rays = _detached(o, d, torch.where(occ, -BIG_T, tmax), tmin)
    return occ | instances_intersect(scene, *rays, time, any_hit=True)["occluded"]


def _detached(*tensors):
    return tuple(None if a is None else a.detach() for a in tensors)


def _instance_hit(scene, o, d, tmax, tmin, time):
    """The instanced closest hit, with ClosestHit's backward for the rays:
    the sweep finds each ray's instance and triangle on the detached rays;
    the backward differentiates Möller-Trumbore at that triangle on the ray
    taken to the instance's object space (w2o_ray at the ray's time), whose
    t is the world t. The values are the sweep's."""
    ih = instances_intersect(scene, *_detached(o, d, tmax, tmin), time)
    if not (torch.is_grad_enabled() and (o.requires_grad or d.requires_grad)):
        return ih
    zeros = torch.zeros_like(tmax)
    o_obj, d_obj = w2o_ray(gather_pack(scene["inst"], ih["inst"].clamp_min(0)),
                           zeros if time is None else time, o, d)
    found = [ih[k] for k in ("t", "prim", "b1", "b2")]
    t, _, b1, b2 = ClosestHit.apply(lambda *_: tuple(a.clone() for a in found),
                                    scene["verts"], scene["tri_idx"], o_obj, d_obj,
                                    zeros if tmin is None else tmin.detach(),
                                    tmax.detach())
    return dict(ih, t=t, b1=b1, b2=b2)
