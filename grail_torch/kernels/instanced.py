"""Two-level (TLAS/BLAS) instanced intersection (port of
grail/kernels/instanced.py): pbrt's TransformedPrimitive. Each instance
interpolates its animated object-to-world transform at the ray's time, the
ray goes to object space, the shared object geometry is walked, and the hit
comes back to world space.

The top level is a dense cull, plain PyTorch as in the reference (XLA
there, not Pallas): every ray slab-tests every instance's motion-bound world
box, (N, I) entry distances a round, and visits its candidates in
lexicographic (near, id) order with t-culling. Each sweep round every live
ray picks its next candidate and transforms its ray with w2o_ray; one
launch of the 4-wide walk (bvh4.bvh4_traverse) then takes all rays, each
starting at its instance's object root in the one table of every object's
BLAS (scene["inst"]["bvh4_nodes"], bvh4.build_bvh4_blas). That per-ray root
replaces the reference's object-grouped 128-ray streams with a start record
each (counting sort by object, lane masking). Rays without a candidate this
round get tmax = -BIG_T and find nothing. The loop ends when no ray has a
candidate left: one host sync a round, which reads the count of rays with a
candidate. LAST_SWEEPS records each call's rounds. Under a profiler the
call is a span `instanced` with the rays handed in as its lanes, and each
round a span `sweep/closest` or `sweep/any`, opened after the round's sync,
with the rays that have a candidate as its lanes.

t parameterization: the object-space ray keeps the unnormalized transformed
direction, so t, tmin and tmax carry over between spaces unchanged.

Transforms ride as per-instance decomposed pairs (T, R quaternion, S),
interpolated per ray like AnimatedTransform::Interpolate (lerp T, slerp R,
lerp S); a still instance applies its matrix m0. World to object is the
closed affine inverse S^-1 R^T (p - T). The sweep takes rays without
gradients; kernels/intersect.py gives its closest hits the rays' gradients.
No gradient reaches the instanced geometry or the instance transforms: a
call that would need one raises.
"""
from __future__ import annotations

import collections

import torch

from .. import telemetry
from ..core.transform import quat_rotate, slerp
from ..core.vecmath import cross
from .bvh4 import bvh4_traverse

BIG_T = 3.0e37

# (kind, rays, rounds) of the latest calls of instances_intersect
LAST_SWEEPS = collections.deque(maxlen=256)


def _lerp_keys(a, time):
    """a (N,2,...) per-ray key pair interpolated at time (N,)."""
    t = time.reshape(time.shape + (1,) * (a.dim() - 2))
    return (1.0 - t) * a[:, 0] + t * a[:, 1]


def _inv3x3(m):
    """Batched closed-form 3x3 inverse (adjugate over determinant)."""
    a, b, c = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    r0, r1, r2 = cross(b, c), cross(c, a), cross(a, b)
    det = (a[..., 0] * r0[..., 0] + a[..., 1] * r0[..., 1]
           + a[..., 2] * r0[..., 2])[..., None]
    det = torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    return torch.stack([r0, r1, r2], dim=-2) / det[..., None]


def _mv(m, v):
    """Batched m (N,3,3) @ v (N,3), written out."""
    return torch.stack([m[:, j, 0] * v[:, 0] + m[:, j, 1] * v[:, 1] + m[:, j, 2] * v[:, 2]
                        for j in range(3)], dim=-1)


def _mtv(m, v):
    """Batched m (N,3,3)^T @ v (N,3), written out."""
    return torch.stack([m[:, 0, j] * v[:, 0] + m[:, 1, j] * v[:, 1] + m[:, 2, j] * v[:, 2]
                        for j in range(3)], dim=-1)


def gather_pack(inst, ids):
    """Per-ray transform pack rows for instance ids (N,)."""
    return {k: inst[k][ids] for k in ("t", "q", "s", "anim", "m0", "m0_inv")}


def _interp(pk, time):
    T = _lerp_keys(pk["t"], time)
    q = slerp(time, pk["q"][:, 0], pk["q"][:, 1])
    S = _lerp_keys(pk["s"], time)
    return T, q, S


def o2w_point(pk, time, p):
    T, q, S = _interp(pk, time)
    out = quat_rotate(q, _mv(S, p)) + T
    m0 = pk["m0"]
    fixed = _mv(m0[:, :3, :3], p) + m0[:, :3, 3]
    return torch.where(pk["anim"][:, None], out, fixed)


def o2w_normal(pk, time, nrm):
    """Normals transform by (M^-1)^T = R S^-1 (S symmetric)."""
    _, q, S = _interp(pk, time)
    out = quat_rotate(q, _mv(_inv3x3(S), nrm))
    fixed = _mtv(pk["m0_inv"][:, :3, :3], nrm)
    return torch.where(pk["anim"][:, None], out, fixed)


@telemetry.spanned("to_object_space")
def w2o_ray(pk, time, o, d):
    """The ray in object space; d is not normalized (t carries over)."""
    T, q, S = _interp(pk, time)
    qc = torch.cat([-q[..., :3], q[..., 3:]], dim=-1)       # the conjugate
    s_inv = _inv3x3(S)
    o_r = _mv(s_inv, quat_rotate(qc, o - T))
    d_r = _mv(s_inv, quat_rotate(qc, d))
    mi = pk["m0_inv"]
    o_f = _mv(mi[:, :3, :3], o) + mi[:, :3, 3]
    d_f = _mv(mi[:, :3, :3], d)
    anim = pk["anim"][:, None]
    return torch.where(anim, o_r, o_f), torch.where(anim, d_r, d_f)


@telemetry.spanned("tlas_cull")
def _instance_nears(inst, o, d, tmin, tcur):
    """(N,I) slab-entry t of each ray into each instance's motion-bound world
    box, or BIG_T where culled (a miss, behind tmin, or past the current
    best t). One axis at a time, so the temporaries are (N,I). A ray whose
    interval is empty (tcur <= tmin: a dead lane) is culled too: the walk
    could find no hit for it, so the result is the reference's, which
    visits its candidates all the same."""
    inv_d = 1.0 / torch.where(torch.abs(d) < 1e-20,
                              torch.where(d < 0, -1e-20, 1e-20), d)
    near = far = None
    for a in range(3):
        o_a, inv_a = o[:, a:a + 1], inv_d[:, a:a + 1]
        t0 = (inst["wmin"][None, :, a] - o_a) * inv_a
        t1 = (inst["wmax"][None, :, a] - o_a) * inv_a
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        near = lo if near is None else torch.maximum(near, lo)
        far = hi if far is None else torch.minimum(far, hi)
    far = far * 1.0000004
    ok = ((near <= far) & (far > tmin[:, None]) & (near < tcur[:, None])
          & (tcur > tmin)[:, None])
    return torch.where(ok, torch.maximum(near, tmin[:, None]), BIG_T)


def next_candidates(inst, o, d, tmin, t, last_near, last_id, occ=None):
    """Each ray's next instance in lexicographic (near, id) order, strictly
    after the last pair visited: (sel, its near, active). occ (any hit):
    occluded rays take none."""
    nr = _instance_nears(inst, o, d, tmin, t)
    ids = torch.arange(nr.shape[1], device=nr.device, dtype=torch.int32)
    elig = ((nr > last_near[:, None])
            | ((nr == last_near[:, None]) & (ids[None] > last_id[:, None])))
    if occ is not None:
        elig = elig & ~occ[:, None]
    nrm = torch.where(elig, nr, BIG_T)
    selnear, sel = torch.min(nrm, dim=1)       # the first minimum: lowest id
    return sel.to(torch.int32), selnear, selnear < BIG_T


def object_rays(inst, sel, act, o, d, time, t):
    """The BLAS walk's inputs for candidates sel: (o, d) in object space,
    tmax (t on active rays, -BIG_T elsewhere) and each ray's root."""
    o_obj, d_obj = w2o_ray(gather_pack(inst, sel), time, o, d)
    sub_tmax = torch.where(act, t, -BIG_T)
    return (o_obj.contiguous(), d_obj.contiguous(), sub_tmax.contiguous(),
            inst["root"][sel].contiguous())


def instances_intersect(scene, o, d, tmax, tmin=None, time=None, any_hit=False):
    """Closest hit (or occlusion) against all instanced geometry.

    Returns {t, prim (global triangle id), b1, b2, inst}, prim = inst = -1 on
    a miss; any_hit=True returns {occluded}. time (N,) in [0,1] picks the
    animated transforms (None: shutter open)."""
    with telemetry.span("instanced", o.shape[0]):
        return _sweep(scene, o, d, tmax, tmin, time, any_hit)


def _sweep(scene, o, d, tmax, tmin, time, any_hit):
    inst = scene["inst"]
    n = o.shape[0]
    dev = o.device
    if tmin is None:
        tmin = torch.zeros_like(tmax)
    if time is None:
        time = torch.zeros_like(tmax)
    if torch.is_grad_enabled():
        if scene["verts"].requires_grad or any(
                torch.is_tensor(v) and v.requires_grad for v in inst.values()):
            raise NotImplementedError("gradients through instanced geometry are not "
                                      "ported yet")
        if any(x.requires_grad for x in (o, d, tmax)):
            raise ValueError("instances_intersect takes rays without gradients: "
                             "kernels.intersect.intersect carries them")
    tmin = tmin.contiguous()
    t = tmax.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    b1 = torch.zeros(n, dtype=torch.float32, device=dev)
    b2 = torch.zeros_like(b1)
    hit_inst = torch.full_like(prim, -1)
    last_near = torch.full((n,), -BIG_T, dtype=torch.float32, device=dev)
    last_id = torch.full_like(prim, -1)
    occ = torch.zeros(n, dtype=torch.bool, device=dev) if any_hit else None
    rounds = 0
    round_span = "sweep/any" if any_hit else "sweep/closest"
    while True:
        sel, selnear, act = next_candidates(inst, o, d, tmin, t, last_near, last_id,
                                            occ)
        lanes = telemetry.sync("sweep_round", int, act.sum())
        if not lanes:
            break
        rounds += 1
        with telemetry.span(round_span, lanes):
            o_obj, d_obj, sub_tmax, roots = object_rays(inst, sel, act, o, d, time, t)
            t_r, prim_r, b1_r, b2_r = bvh4_traverse(
                inst["bvh4_nodes"], inst["bvh4_tris"], o_obj, d_obj, tmin, sub_tmax,
                any_hit, stack=inst["bvh4_stack"], roots=roots)
            closer = prim_r >= 0
            if any_hit:
                occ = occ | closer
            else:
                t = torch.where(closer, t_r, t)
                prim = torch.where(closer, prim_r, prim)
                b1 = torch.where(closer, b1_r, b1)
                b2 = torch.where(closer, b2_r, b2)
                hit_inst = torch.where(closer, sel, hit_inst)
            last_near = torch.where(act, selnear, last_near)
            last_id = torch.where(act, sel, last_id)
    LAST_SWEEPS.append(("any_hit" if any_hit else "closest", n, rounds))
    if any_hit:
        return {"occluded": occ}
    return {"t": torch.where(prim >= 0, t, BIG_T), "prim": prim, "b1": b1, "b2": b2,
            "inst": hit_inst}
