"""The intersect kernels' roofline: the operations and bytes that the rays of
a launch need, counted by the benchmark's own walk over the system's tables,
against the published peaks of one NVIDIA H100 SXM (dense FP32 outside the
tensor cores, and HBM3 bandwidth, at its 700 W limit).

Operations:
- a ray-triangle pair (Moller-Trumbore, no multiply-add contracted) counts
  the stages of its hit test that it reaches: 29 for the first (the cross
  product d x e2, the divisor, its reciprocal, o - v0, b1 and its tests), 18
  more where b1 passes (the cross product s x e1, b2 and its tests), 8 more
  where b2 passes (t and its two compares);
- a 4-wide node visit counts 4 slab tests of 26 (6 subtractions, 6
  multiplies, 6 min/max for the slabs, 4 for entry and exit, one widening
  multiply, 3 compares).
Bytes: 48 a ray (origin, direction, tmin, tmax in; t, prim, b1, b2 out) and
the tables once (36 B a triangle of the brute-force table; 128 B a node and
48 B a triangle of the 4-wide tables).

The 4-wide walk visits as the system's kernel documents it: from node 0, a
node's hit children nearest first on (entry distance, slot), the others
pushed farthest first; a leaf's triangles in order; any hit ends at its
first hit. Counts are taken on a sample of each launch's rays and scaled to
its live rays."""
from __future__ import annotations

import torch

PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
OPS_STAGES = (29, 18, 8)
OPS_SLAB = 26
WIDTH = 4
RAY_BYTES = 48
BRUTE_TRI_BYTES = 36
NODE_BYTES = 128
TRI_BYTES = 48
_NETWORK = ((0, 1), (2, 3), (0, 2), (1, 3), (1, 2))


def _stages(o, d, v0, e1, e2, tmin, tbest):
    """The three stage masks of each pair's hit test, and its t."""
    s1 = torch.cross(d, e2, dim=-1)
    div = (s1 * e1).sum(-1)
    inv = 1.0 / torch.where(div == 0.0, 1.0, div)
    s = o - v0
    b1 = (s * s1).sum(-1) * inv
    st2 = (div != 0.0) & (b1 >= 0.0) & (b1 <= 1.0)
    s2 = torch.cross(s, e1, dim=-1)
    b2 = (d * s2).sum(-1) * inv
    st3 = st2 & (b2 >= 0.0) & (b1 + b2 <= 1.0)
    t = (e2 * s2).sum(-1) * inv
    return st2, st3, st3 & (t > tmin) & (t < tbest), t


def pair_ops(n1, n2, n3):
    return OPS_STAGES[0] * n1 + OPS_STAGES[1] * n2 + OPS_STAGES[2] * n3


def brute_ops(tris9, o, d, tmin, tmax, any_hit):
    """Operations of each ray over the (T, 9) table [v0 | e1 | e2]: every
    pair of a live ray (tmax > tmin); an any-hit ray up to its first hit."""
    v0, e1, e2 = tris9[:, 0:3], tris9[:, 3:6], tris9[:, 6:9]
    st2, st3, hit, _ = _stages(o[:, None], d[:, None], v0[None], e1[None], e2[None],
                               tmin[:, None], tmax[:, None])
    need = (tmax > tmin)[:, None].expand_as(hit)
    if any_hit:
        first = torch.where(hit.any(1), torch.argmax(hit.to(torch.uint8), 1),
                            tris9.shape[0] - 1)
        need = need & (torch.arange(tris9.shape[0], device=o.device)[None] <= first[:, None])
    return pair_ops(need.sum(1), (need & st2).sum(1), (need & st3).sum(1)).double()


def bvh4_ops(nodes, tris, o, d, tmin, tmax, any_hit, stack=64):
    """Operations of each ray's 4-wide walk."""
    dev, n = o.device, o.shape[0]
    node_int, tri_int = nodes.view(torch.int32), tris.view(torch.int32)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    ops = torch.zeros(n, dtype=torch.float64, device=dev)
    lane = torch.arange(n, device=dev)
    ref = torch.zeros(n, dtype=torch.int64, device=dev)
    sp = torch.zeros_like(ref)
    stk = torch.zeros((n, stack), dtype=torch.int64, device=dev)
    tbest = tmax.clone()
    o_, d_, inv_, tmin_ = o, d, inv, tmin
    while lane.numel():
        m = lane.numel()
        rows = torch.arange(m, device=dev)
        is_node = ref >= 0
        nid = torch.where(is_node, ref, 0)
        box = nodes[nid, :6 * WIDTH].reshape(m, 6, WIDTH)
        t0 = (box[:, 0:3] - o_[:, :, None]) * inv_[:, :, None]
        t1 = (box[:, 3:6] - o_[:, :, None]) * inv_[:, :, None]
        near = torch.minimum(t0, t1).amax(1)
        far = torch.maximum(t0, t1).amin(1) * 1.0000004
        hit = (near <= far) & (far > tmin_[:, None]) & (near < tbest[:, None])
        hits = hit.sum(1)
        key = list(torch.where(hit, near, torch.inf).unbind(1))
        slot = list(torch.arange(WIDTH, device=dev).expand(m, WIDTH).unbind(1))
        for a, b in _NETWORK:
            sw = (key[b] < key[a]) | ((key[b] == key[a]) & (slot[b] < slot[a]))
            key[a], key[b] = torch.where(sw, key[b], key[a]), torch.where(sw, key[a], key[b])
            slot[a], slot[b] = torch.where(sw, slot[b], slot[a]), torch.where(sw, slot[a], slot[b])
        child = node_int[nid, 6 * WIDTH:7 * WIDTH].to(torch.int64)
        push = is_node & (hits > 1)
        for j in (3, 2, 1):
            on = push & (hits > j)
            r = rows[on]
            stk[r, sp[r]] = child[r, slot[j][r]]
            sp = sp + on.to(torch.int64)
        tid = torch.where(is_node, 0, ~ref)
        row = tris[tid]
        st2, st3, got, t = _stages(o_, d_, row[:, 0:3], row[:, 4:7], row[:, 8:11], tmin_, tbest)
        ops[lane] += torch.where(is_node, float(WIDTH * OPS_SLAB),
                                 pair_ops(1, st2.double(), st3.double()))
        got = got & ~is_node
        tbest = torch.where(got, t, tbest)
        descend = is_node & (hits > 0)
        more = ~is_node & ((tri_int[tid, 11] & 1) > 0)
        pop = ~descend & ~more
        popped = torch.gather(stk, 1, (sp - 1).clamp_min(0)[:, None])[:, 0]
        nearest = torch.gather(child, 1, slot[0][:, None])[:, 0]
        ref = torch.where(descend, nearest, torch.where(more, ref - 1, popped))
        live = ~(pop & (sp == 0))
        if any_hit:
            live = live & ~got
        sp = torch.where(pop, (sp - 1).clamp_min(0), sp)
        if not bool(live.all()):
            lane, ref, sp, stk, tbest = lane[live], ref[live], sp[live], stk[live], tbest[live]
            o_, d_, inv_, tmin_ = o_[live], d_[live], inv_[live], tmin_[live]
    return ops


def bound_s(ops, nbytes):
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / PEAK_FP32_OPS, nbytes / PEAK_BYTES)


def launch_bound_s(launch, tables):
    """The bound of one captured launch: its sampled rays' operations scaled
    to all of its rays, and its bytes. launch: dict kind ("brute" or
    "bvh4"), any_hit, n (rays), rays (o, d, tmin, tmax of the sample)."""
    o, d, tmin, tmax = launch["rays"]
    if launch["kind"] == "brute":
        ops = brute_ops(tables["tris9"], o, d, tmin, tmax, launch["any_hit"])
        table = tables["tris9"].shape[0] * BRUTE_TRI_BYTES
    else:
        ops = bvh4_ops(tables["nodes"], tables["tris"], o, d, tmin, tmax, launch["any_hit"])
        table = tables["nodes"].shape[0] * NODE_BYTES + tables["tris"].shape[0] * TRI_BYTES
    mean = float(ops.mean()) if ops.numel() else 0.0
    return bound_s(mean * launch["n"], launch["n"] * RAY_BYTES + table)
