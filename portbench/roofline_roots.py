"""The 4-wide walk's roofline on instanced scenes, where the walk is launched
by two callers: the base route from node 0 (kernels/intersect.py) and the
instanced sweep from each ray's own BLAS root (kernels/instanced.py), which
may be a node or a leaf reference (~first triangle). roofline.py counts
every ray from node 0 and the base route's launches only; this file counts
each sampled ray from where the kernel starts it, with roofline.py's
peaks, slab-test and Moller-Trumbore stage counts.

Bytes a launch: 48 a ray (origin, direction, tmin, tmax in; t, prim, b1, b2
out), 4 more for a root, and the launch's own tables once (128 B a node, 48
B a triangle)."""
from __future__ import annotations

import contextlib

import torch

from .roofline import (NODE_BYTES, OPS_SLAB, RAY_BYTES, TRI_BYTES, WIDTH, _NETWORK,
                       _stages, bound_s, pair_ops)

ROOT_BYTES = 4
SAMPLE_RAYS = 4096      # rays counted a launch


def bvh4_counts(nodes, tris, o, d, tmin, tmax, any_hit, roots=None, stack=64):
    """(operations, node visits, triangle tests) of each ray's 4-wide walk,
    from node 0 or from its root: roofline.bvh4_ops's walk with the first
    item taken from `roots`."""
    dev, n = o.device, o.shape[0]
    node_int, tri_int = nodes.view(torch.int32), tris.view(torch.int32)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-20, torch.where(d < 0, -1e-20, 1e-20), d)
    ops = torch.zeros(n, dtype=torch.float64, device=dev)
    n_node = torch.zeros(n, dtype=torch.int64, device=dev)
    n_tri = torch.zeros_like(n_node)
    lane = torch.arange(n, device=dev)
    ref = (torch.zeros(n, dtype=torch.int64, device=dev) if roots is None
           else roots.to(torch.int64))
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stk = torch.zeros((n, max(stack, 1)), dtype=torch.int64, device=dev)
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
        n_node[lane] += is_node.to(torch.int64)
        n_tri[lane] += (~is_node).to(torch.int64)
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
    return ops, n_node, n_tri


def launch_bound_s(launch):
    """The bound of one captured launch: its sampled rays' operations scaled
    to all of its rays, and its bytes."""
    o, d, tmin, tmax, roots = launch["rays"]
    nodes, tris = launch["tables"]
    ops = bvh4_counts(nodes, tris, o, d, tmin, tmax, launch["any_hit"], roots,
                      launch["stack"])[0]
    mean = float(ops.mean()) if ops.numel() else 0.0
    ray_bytes = RAY_BYTES + (ROOT_BYTES if roots is not None else 0)
    table = nodes.shape[0] * NODE_BYTES + tris.shape[0] * TRI_BYTES
    return bound_s(mean * launch["n"], launch["n"] * ray_bytes + table)


@contextlib.contextmanager
def capturing(launches, gen):
    """Every 4-wide launch of the base route and of the instanced sweep
    recorded (its tables, any_hit, ray count, stack bound and a sample of
    its rays with their roots) while the block runs."""
    from grail_torch.kernels import instanced, intersect
    real = {mod: mod.bvh4_traverse for mod in (intersect, instanced)}

    def wrap(walk):
        def recorded(nodes, tris, o, d, tmin, tmax, any_hit=False, *, stack, roots=None):
            n = o.shape[0]
            if n:
                idx = torch.randperm(n, generator=gen)[:SAMPLE_RAYS].to(o.device)
                rays = tuple(None if a is None else a[idx].detach().clone()
                             for a in (o, d, tmin, tmax, roots))
                launches.append({"any_hit": bool(any_hit), "n": n, "stack": stack,
                                 "tables": (nodes, tris), "rays": rays})
            return walk(nodes, tris, o, d, tmin, tmax, any_hit, stack=stack, roots=roots)
        return recorded

    for mod, walk in real.items():
        mod.bvh4_traverse = wrap(walk)
    try:
        yield
    finally:
        for mod, walk in real.items():
            mod.bvh4_traverse = walk


def request_bound_s(generator, run):
    """The summed bound of the 4-wide launches of the window's first request,
    run again with each launch's rays sampled (a generator seeded from the
    run's seed); None where it made no such launch."""
    launches = []
    gen = torch.Generator().manual_seed(run.seed % (2 ** 63))
    with capturing(launches, gen):
        generator.request(1)
    if not launches:
        return None
    return sum(launch_bound_s(la) for la in launches)
