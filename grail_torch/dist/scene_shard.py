"""Scene sharding: the triangles partitioned over the ranks, rays passed
around the ring (port of grail/dist/scene_shard.py).

partition_scene cuts the triangle soup on the host into n_shards spatially
compact shards (a Morton order of the centroids, cut into equal runs), each
sorted by global id and padded with triangles parked far away (gid 2^30).
Every shard carries each triangle's full record (v0, e1, e2, the vertex
normals and uvs, material, light and flags), so no rank needs the mesh
leaves. With stream=True each shard also gets a 4-wide table built by the
port's own SAH code (scene/bvh.py, then kernels/bvh4.py's collapse), whose
prim ids are local slots into the shard.

ring_intersect runs world_size steps: a rank intersects the rays in hand
against its shard (the brute-force kernel, csrc/brute_intersect.cu, on its
(v0, e1, e2); or the 4-wide walk, csrc/bvh4.cu, on its table), merges the
hit on (t, gid) (the closer t, then the lower global id) into the state the
rays carry, and passes the state to the next rank. After world_size steps
every ray has met every shard and is back home. The local step's range
ends just past the best t so far, so ties across shards resolve to the
lowest global id, as the replicated brute force resolves them; the state
(rays, best hit, the winning triangle's record) travels as one float32
and one int32 buffer. A lone rank makes one local step and no transfer.
The image of a ring render with the brute-force step is the replicated
render's, bitwise; the 4-wide walk may pick another triangle among exactly
equal t within a shard.

STATS counts the ring's transfers and the bytes this rank sends.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.brute_intersect import brute_intersect
from ..kernels.bvh4 import build_bvh4_tables, bvh4_traverse
from ..scene.bvh import build_bvh_auto
from ..scene.buffers import to_torch

BIG_T = 3.0e37
PAD_GID = 2 ** 30
PAD_FAR = 2.0e30       # where the pad triangles' v0 is parked

# the carried triangle record: float fields (3 or 2 floats a triangle) and
# int fields
TRI_FIELDS = ("v0", "e1", "e2", "n0", "n1", "n2", "uv0", "uv1", "uv2")
TRI_IFIELDS = ("mat", "light", "flags")
_WIDTH = {"uv0": 2, "uv1": 2, "uv2": 2}
# float buffer columns: o, d, tmin, tmax, t, b1, b2, then the record
_REC = 11

STATS = {"passes": 0, "bytes": 0}


def _morton(c, bits=10):
    q = np.clip(c * (1 << bits), 0, (1 << bits) - 1).astype(np.uint64)

    def spread(v):
        out = np.zeros_like(v)
        for i in range(bits):
            out |= ((v >> np.uint64(i)) & np.uint64(1)) << np.uint64(3 * i)
        return out
    return ((spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1))
            | spread(q[:, 2]))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def shard_table(verts, tri_idx, members):
    """The 4-wide tables of one shard: {"nodes", "tris", "stack"} numpy,
    built from the shard's triangles (rows `members` of tri_idx, in slot
    order) with max_prims=4, force_leaf=4, as the reference builds its
    per-shard trees; the prim ids are local slots."""
    sub_idx = np.asarray(tri_idx, np.int64)[members]
    b = build_bvh_auto(verts, sub_idx, max_prims=4, force_leaf=4)
    nodes, tris, stack = build_bvh4_tables(b, verts, sub_idx)
    return {"nodes": nodes, "tris": tris, "stack": int(stack)}


def partition_scene(scene, n_shards, stream=False):
    """The host partition of the scene's triangles into n_shards (tensors on
    the scene's device, each with a leading shard axis): the record fields,
    gid (global ids, PAD_GID for padding) and, with stream=True, "bvh4": a
    tuple of each shard's tables (shard_table)."""
    verts = _np(scene["verts"]).astype(np.float32)
    idx = _np(scene["tri_idx"]).astype(np.int64)
    vnorm = _np(scene["vnorm"]).astype(np.float32)
    vuv = _np(scene["vuv"]).astype(np.float32)
    n_tris = idx.shape[0]
    v0, v1, v2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    cen = (v0 + v1 + v2) / 3.0
    lo, hi = cen.min(0), cen.max(0)
    order = np.argsort(_morton((cen - lo) / np.maximum(hi - lo, 1e-9)), kind="stable")
    per = -(-n_tris // n_shards)
    fields = {
        "v0": v0, "e1": v1 - v0, "e2": v2 - v0,
        "n0": vnorm[idx[:, 0]], "n1": vnorm[idx[:, 1]], "n2": vnorm[idx[:, 2]],
        "uv0": vuv[idx[:, 0]], "uv1": vuv[idx[:, 1]], "uv2": vuv[idx[:, 2]],
        "mat": _np(scene["tri_mat"]).astype(np.int32),
        "light": _np(scene["tri_light"]).astype(np.int32),
        "flags": _np(scene["tri_flags"]).astype(np.int32),
    }
    out = {k: [] for k in list(fields) + ["gid"]}
    tables = []
    for s in range(n_shards):
        members = np.sort(order[s * per:(s + 1) * per])     # ascending global id
        pad = per - len(members)
        for k, arr in fields.items():
            z = np.zeros((pad,) + arr.shape[1:], arr.dtype)
            if k == "v0":
                z += np.float32(PAD_FAR)
            out[k].append(np.concatenate([arr[members], z]))
        out["gid"].append(np.concatenate([members.astype(np.int32),
                                          np.full(pad, PAD_GID, np.int32)]))
        if stream:
            if not len(members):
                raise ValueError(f"shard {s} of {n_shards} holds no triangle to build "
                                 "a table for")
            tables.append(shard_table(verts, idx, members))
    ring = {k: np.stack(v) for k, v in out.items()}
    if stream:
        ring["bvh4"] = tuple(tables)
    return to_torch(ring, scene["verts"].device)


def local_ring(ring, mesh):
    """This rank's shard of a partition, as the intersect dispatch reads it
    ("ring" of a scene): the packed record, the brute-force table, the
    shard's 4-wide tables where the partition has them, and the mesh."""
    k = mesh.rank
    if ring["gid"].shape[0] != mesh.world_size:
        raise ValueError(f"a partition into {ring['gid'].shape[0]} shards cannot run on "
                         f"{mesh.world_size} ranks")
    rec = torch.cat([ring[f][k] for f in TRI_FIELDS], dim=1)
    out = {"mesh": mesh,
           "rec_f": rec.to(mesh.device).contiguous(),
           "rec_i": torch.stack([ring["gid"][k]] + [ring[f][k] for f in TRI_IFIELDS],
                                dim=1).to(mesh.device).contiguous(),
           "tris9": rec[:, :9].to(mesh.device).contiguous()}
    if "bvh4" in ring:
        tab = ring["bvh4"][k]
        out["bvh4"] = {"nodes": tab["nodes"].to(mesh.device).contiguous(),
                       "tris": tab["tris"].to(mesh.device).contiguous(),
                       "stack": int(tab["stack"])}
    return out


def _local_hit(shard, o, d, tmin, tmax, any_hit=False):
    """(t, slot, b1, b2) of the rays against the local shard: the 4-wide
    walk on its table, or brute force on its (v0, e1, e2); slot -1 misses."""
    if "bvh4" in shard:
        tab = shard["bvh4"]
        dead = tmax <= tmin
        tmin = torch.where(dead, BIG_T, tmin)
        tmax = torch.where(dead, -BIG_T, tmax)
        return bvh4_traverse(tab["nodes"], tab["tris"], o, d, tmin, tmax, any_hit,
                             stack=tab["stack"])
    return brute_intersect(shard["tris9"], o, d, tmin, tmax, any_hit)


def _pass(mesh, *bufs):
    if mesh.world_size > 1:
        STATS["passes"] += 1
        STATS["bytes"] += sum(b.numel() * b.element_size() for b in bufs)
    return mesh.ring_pass(*bufs)


def _rays(fbuf):
    """(o, d, tmin, tmax) of the state's float buffer, contiguous."""
    return (fbuf[:, 0:3].contiguous(), fbuf[:, 3:6].contiguous(),
            fbuf[:, 6].contiguous(), fbuf[:, 7].contiguous())


def ring_intersect(shard, o, d, tmax, tmin=None, any_hit=False):
    """Closest hit (or occlusion) of this rank's rays over every shard of
    the ring. shard: local_ring's record, with the mesh; every rank calls it
    with its own rays in step. Returns the hit record {t, prim (global id,
    -1 a miss), b1, b2, tri: the winning triangle's record} or
    {"occluded"}. No gradient."""
    if torch.is_grad_enabled() and (o.requires_grad or d.requires_grad):
        raise NotImplementedError("the ring route has no gradient")
    mesh = shard["mesh"]
    n = o.shape[0]
    if tmin is None:
        tmin = torch.zeros_like(tmax)
    rays = torch.cat([o, d, tmin[:, None], tmax[:, None]], dim=1)
    with torch.no_grad():
        if any_hit:
            fbuf = torch.cat([rays, rays.new_zeros((n, 1))], dim=1)
            for _ in range(mesh.world_size):
                o_s, d_s, tmin_s, tmax_s = _rays(fbuf)
                occ = fbuf[:, 8] > 0
                prim = _local_hit(shard, o_s, d_s, tmin_s, torch.where(occ, -BIG_T, tmax_s),
                                  any_hit=True)[1]
                fbuf = torch.cat([fbuf[:, :8], (occ | (prim >= 0)).to(fbuf.dtype)[:, None]],
                                 dim=1)
                (fbuf,) = _pass(mesh, fbuf)
            return {"occluded": fbuf[:, 8] > 0}

        n_rec = shard["rec_f"].shape[1]
        fbuf = torch.cat([rays, rays.new_full((n, 1), BIG_T), rays.new_zeros((n, 2 + n_rec))],
                         dim=1)
        # a miss: no triangle, material 0, no light
        ibuf = torch.zeros((n, 1 + len(TRI_IFIELDS)), dtype=torch.int32, device=o.device)
        ibuf[:, 0] = PAD_GID
        ibuf[:, 1 + TRI_IFIELDS.index("light")] = -1
        for _ in range(mesh.world_size):
            o_s, d_s, tmin_s, tmax_s = _rays(fbuf)
            t_best, gid_best = fbuf[:, 8], ibuf[:, 0]
            # up to and including the best t: a tie goes to the lower gid
            cap = torch.minimum(tmax_s, torch.nextafter(t_best, t_best.new_tensor(np.inf)))
            t, slot, b1, b2 = _local_hit(shard, o_s, d_s, tmin_s, cap)
            ok = slot >= 0
            row = slot.clamp_min(0).to(torch.int64)
            rec_i = shard["rec_i"][row]
            closer = ok & ((t < t_best) | ((t == t_best) & (rec_i[:, 0] < gid_best)))
            c = closer[:, None]
            fbuf = torch.cat([fbuf[:, :8],
                              torch.where(c, torch.stack([t, b1, b2], dim=1), fbuf[:, 8:_REC]),
                              torch.where(c, shard["rec_f"][row], fbuf[:, _REC:])], dim=1)
            ibuf = torch.where(c, rec_i, ibuf)
            fbuf, ibuf = _pass(mesh, fbuf, ibuf)
    found = fbuf[:, 8] < BIG_T
    tri, at = {}, _REC
    for f in TRI_FIELDS:
        w = _WIDTH.get(f, 3)
        tri[f] = fbuf[:, at:at + w]
        at += w
    for j, f in enumerate(TRI_IFIELDS):
        tri[f] = ibuf[:, 1 + j]
    return {"t": torch.where(found, fbuf[:, 8], BIG_T),
            "prim": torch.where(found, ibuf[:, 0], -1),
            "b1": fbuf[:, 9], "b2": fbuf[:, 10], "tri": tri}
