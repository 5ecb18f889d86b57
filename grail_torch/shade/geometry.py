"""Differential geometry at hit points (port of grail/shade/geometry.py),
and the uv screen derivatives that texture filtering reads at camera hits.
A hit of the scene-sharded ring (dist/scene_shard.py) carries its
triangle's record (hit["tri"]), which is read in place of the mesh
leaves: a ring scene has none."""
from __future__ import annotations

import torch

from .. import telemetry
from ..core.vecmath import cross, dot, normalize, face_forward, coordinate_system
from ..kernels.instanced import gather_pack, o2w_normal, o2w_point

# tri_flags bits
HAS_NS = 1
HAS_UV = 2
HAS_TAN = 4
REVERSE_ORIENTATION = 8
XFORM_SWAPS_HANDEDNESS = 16


@telemetry.spanned("shading_geometry")
def shading_geometry(scene, hit, ray_o, ray_d, time=None):
    """Shading record for a batch of hits. Misses (prim<0) produce
    garbage-but-finite entries; callers mask by hit. An instance hit
    (hit["inst"] >= 0) takes its object-space triangle to world space with
    the instance's transform at the ray's time (None: shutter open), as
    pbrt's TransformedPrimitive::Intersect does."""
    inst = scene.get("inst")
    on_inst = None
    if "tri" in hit:
        tri = hit["tri"]
        e1, e2 = tri["e1"], tri["e2"]
        n0, n1, n2 = tri["n0"], tri["n1"], tri["n2"]
        uv0, uv1, uv2 = tri["uv0"], tri["uv1"], tri["uv2"]
        flags, mat_id, light_id = tri["flags"], tri["mat"], tri["light"]
    else:
        prim = torch.clamp_min(hit["prim"], 0)
        idx = scene["tri_idx"][prim]                    # (N,3)
        v0 = scene["verts"][idx[..., 0]]
        v1 = scene["verts"][idx[..., 1]]
        v2 = scene["verts"][idx[..., 2]]
        n0 = scene["vnorm"][idx[..., 0]]
        n1 = scene["vnorm"][idx[..., 1]]
        n2 = scene["vnorm"][idx[..., 2]]
        if inst is not None and "inst" in hit:
            on_inst = hit["inst"] >= 0
            pk = gather_pack(inst, torch.clamp_min(hit["inst"], 0))
            t_lane = time if time is not None else torch.zeros_like(hit["t"])
            m = on_inst[..., None]
            v0, v1, v2 = (torch.where(m, o2w_point(pk, t_lane, v), v) for v in (v0, v1, v2))
            n0, n1, n2 = (torch.where(m, o2w_normal(pk, t_lane, v), v) for v in (n0, n1, n2))
        e1 = v1 - v0
        e2 = v2 - v0
        uv0 = scene["vuv"][idx[..., 0]]
        uv1 = scene["vuv"][idx[..., 1]]
        uv2 = scene["vuv"][idx[..., 2]]
        flags = scene["tri_flags"][prim]
        mat_id = scene["tri_mat"][prim]
        light_id = scene["tri_light"][prim]

    b1 = hit["b1"][..., None]
    b2 = hit["b2"][..., None]
    b0 = 1.0 - b1 - b2

    # clamp the miss sentinel (t = 3e37) before forming p: a hit always has
    # t < 1e7 (the dispatch tmax)
    t_safe = torch.clamp_max(hit["t"], 1.0e7)
    p = ray_o + t_safe[..., None] * ray_d
    ng = normalize(cross(e1, e2))

    rev = (flags & REVERSE_ORIENTATION) != 0
    swap = (flags & XFORM_SWAPS_HANDEDNESS) != 0
    if on_inst is not None:
        swap = swap ^ (on_inst & inst["swap"][torch.clamp_min(hit["inst"], 0)])
    ng = torch.where((rev ^ swap)[..., None], -ng, ng)

    # uv: default parameterization (0,0),(1,0),(1,1) as pbrt TriangleMesh::GetUVs
    has_uv1 = (flags & HAS_UV) != 0
    has_uv = has_uv1[..., None]
    uv_default = torch.cat([b1 + b2, b2], dim=-1)
    uv = torch.where(has_uv, b0 * uv0 + b1 * uv1 + b2 * uv2, uv_default)

    # dpdu/dpdv from uv deltas (pbrt Triangle::Intersect 2x2 solve)
    du1 = torch.where(has_uv1, uv1[..., 0] - uv0[..., 0], 1.0)
    du2 = torch.where(has_uv1, uv2[..., 0] - uv0[..., 0], 1.0)
    dv1 = torch.where(has_uv1, uv1[..., 1] - uv0[..., 1], 0.0)
    dv2 = torch.where(has_uv1, uv2[..., 1] - uv0[..., 1], 1.0)
    det = du1 * dv2 - dv1 * du2
    degen = torch.abs(det) < 1e-12
    invdet = 1.0 / torch.where(degen, 1.0, det)
    dpdu = (dv2[..., None] * e1 - dv1[..., None] * e2) * invdet[..., None]
    dpdv = (-du2[..., None] * e1 + du1[..., None] * e2) * invdet[..., None]
    t1, t2 = coordinate_system(ng)
    dpdu = torch.where(degen[..., None], t1, dpdu)
    dpdv = torch.where(degen[..., None], t2, dpdv)

    # shading normal: interpolate vertex normals if present
    has_ns = ((flags & HAS_NS) != 0)[..., None]
    n_sum = b0 * n0 + b1 * n1 + b2 * n2
    n_sum = torch.where(has_ns, n_sum,
                        telemetry.sync("default_normal", n_sum.new_tensor, [0.0, 0.0, 1.0]))
    ns_interp = normalize(n_sum)
    ns_interp = torch.where(rev[..., None], -ns_interp, ns_interp)
    ns = torch.where(has_ns, ns_interp, ng)
    ng = face_forward(ng, ns)

    # shading frame (ss, ts, ns): orthonormalize dpdu against ns
    ss = normalize(dpdu - ns * dot(ns, dpdu)[..., None])
    abs_ss = torch.abs(ss)
    bad_ss = (abs_ss[..., 0] + abs_ss[..., 1] + abs_ss[..., 2]) < 1e-9
    ss_fb, _ = coordinate_system(ns)
    ss = torch.where(bad_ss[..., None], ss_fb, ss)
    ts = cross(ns, ss)

    return {
        "p": p,
        "ng": ng,
        "ns": ns,
        "ss": ss,
        "ts": ts,
        "uv": uv,
        "dpdu": dpdu,
        "dpdv": dpdv,
        "mat": mat_id,
        "light": light_id,
        "ray_eps": 1e-3 * t_safe,   # pbrt Triangle::Intersect rayEpsilon policy
    }


def hit_geometric(scene, hit):
    """Lean hit record: orientation-corrected geometric normal + light id."""
    if "tri" in hit:
        tri = hit["tri"]
        ng = normalize(cross(tri["e1"], tri["e2"]))
        flags, light = tri["flags"], tri["light"]
    else:
        prim = torch.clamp_min(hit["prim"], 0)
        idx = scene["tri_idx"][prim]
        v0 = scene["verts"][idx[..., 0]]
        v1 = scene["verts"][idx[..., 1]]
        v2 = scene["verts"][idx[..., 2]]
        ng = normalize(cross(v1 - v0, v2 - v0))
        flags = scene["tri_flags"][prim]
        light = scene["tri_light"][prim]
    flip = (((flags & REVERSE_ORIENTATION) != 0)
            ^ ((flags & XFORM_SWAPS_HANDEDNESS) != 0))
    ng = torch.where(flip[..., None], -ng, ng)
    return {"ng": ng, "light": light}


def world_to_local(sg, w):
    """World direction -> shading frame (pbrt BSDF::WorldToLocal)."""
    return torch.stack([dot(w, sg["ss"]), dot(w, sg["ts"]), dot(w, sg["ns"])], dim=-1)


def local_to_world(sg, w):
    return w[..., 0:1] * sg["ss"] + w[..., 1:2] * sg["ts"] + w[..., 2:3] * sg["ns"]


@telemetry.spanned("uv_differentials")
def uv_differentials(sg, rx_o, rx_d, ry_o, ry_d):
    """DifferentialGeometry::ComputeDifferentials: intersect the x/y offset
    rays with the tangent plane at p, then solve dpdx = dudx*dpdu + dvdx*dpdv
    over the two axes where the normal is smallest. Returns (duvdx, duvdy),
    each (N,2); a degenerate configuration gives zeros."""
    p, ng = sg["p"], sg["ng"]
    dist = dot(ng, p)

    def plane_hit(o, d):
        denom = dot(ng, d)
        ok = torch.abs(denom) >= 1e-9
        tt = (dist - dot(ng, o)) / torch.where(ok, denom, 1.0)
        return o + tt[..., None] * d, ok

    px, okx = plane_hit(rx_o, rx_d)
    py, oky = plane_hit(ry_o, ry_d)
    dpdx = px - p
    dpdy = py - p

    drop = torch.argmax(torch.abs(ng), dim=-1)       # the largest-|n| axis
    ax0 = torch.where(drop == 0, 1, 0)[..., None]
    ax1 = torch.where(drop == 2, 1, 2)[..., None]

    def pick(v, a):
        return torch.gather(v, -1, a)[..., 0]

    A00 = pick(sg["dpdu"], ax0)
    A01 = pick(sg["dpdv"], ax0)
    A10 = pick(sg["dpdu"], ax1)
    A11 = pick(sg["dpdv"], ax1)
    det = A00 * A11 - A01 * A10
    solvable = torch.abs(det) >= 1e-12
    inv = 1.0 / torch.where(solvable, det, 1.0)

    def solve(b):
        b0 = pick(b, ax0)
        b1 = pick(b, ax1)
        return (A11 * b0 - A01 * b1) * inv, (A00 * b1 - A10 * b0) * inv

    dudx, dvdx = solve(dpdx)
    dudy, dvdy = solve(dpdy)
    okx = okx & solvable
    oky = oky & solvable
    duvdx = torch.stack([torch.where(okx, dudx, 0.0), torch.where(okx, dvdx, 0.0)], dim=-1)
    duvdy = torch.stack([torch.where(oky, dudy, 0.0), torch.where(oky, dvdy, 0.0)], dim=-1)
    return duvdx, duvdy
