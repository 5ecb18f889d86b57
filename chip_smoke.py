#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (grail_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line with its seconds; any
failure ends the run with a non-zero exit code:
  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build: every CUDA kernel of the port, compiled from the sources here
     (one nvcc per source, all started together), with ptxas's registers
     and spills per kernel instance;
  Cornell box (36 triangles, brute-force intersector):
  3. parity: the kernel against its plain PyTorch version on the card at the
     main path's shapes (1,048,576 rays);
  4. main path: a render on the card against the same render on the CPU;
  5. bench: the bench render (256x256, 16 spp, path integrator, max depth 5)
     through the kernel, with its launch count, and the kernel's time beside
     its plain version and bound;
  mesh100k (the 100k-triangle terrain at grid=224, BVH traversal):
  6. parity: each of the four record-stream kernels against its plain
     version at 1,048,576 rays: the bench camera wave (skip, closest hit), a
     binned incoherent secondary wave (ordered, closest and any hit) and
     shadow rays with random lengths and 1/8 dead lanes (skip, any hit); the
     two 4-wide kernels on the rays of the kernels they replace on the main
     path (closest hit on the secondary wave, any hit on the shadow rays),
     against their plain versions and against those kernels;
  7. main path: a 64x64, 4 spp, depth 3 render on the card against the CPU,
     through the binned (4-wide) route;
  8. bench: the bench render (256x256, 16 spp, depth 5) through the kernels,
     with launches per render of each kernel;
  9. kernel_time: each traversal kernel's ms per launch beside its plain
     version and its bound; each 4-wide kernel timed in turns with the
     kernel it replaces, and the 4-wide closest hit on the camera wave in
     turns with the skip kernel that the main path keeps there.
Then a {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.
Needs a CUDA device and nvcc; imports nothing of JAX.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from grail_torch.engine.integrator import IntegratorConfig
from grail_torch.engine.render import camera_rays, megawave_lanes, render
from grail_torch.kernels import brute_intersect as bi
from grail_torch.kernels import bvh4 as b4
from grail_torch.kernels import bvh_stream as bs
from grail_torch.kernels import build
from grail_torch.kernels.binning import (N_RAY_BUCKETS, bin_rays_key, bucket_rank,
                                         sort_by_rank)
from grail_torch.kernels.intersect import BIG_T, SORT_MIN, moller_trumbore, pack_tris
from grail_torch.scene.presets import cornell_box, mesh_scene

N_RAYS = 1 << 20
MESH_GRID = 224
# H100 SXM published peaks (dense, at the 700 W limit): FP32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_PAIR = 55          # Möller-Trumbore + hit test per ray-triangle pair
# slab test per box record (bvh_stream.cu): 6 subtracts, 6 multiplies, one
# min and one max per axis (6), 4 min/max across axes, 1 multiply and
# 3 compares
OPS_PER_BOX = 26
RAY_BYTES = 12 + 12 + 4 + 4 + 16   # o, d, tmin, tmax in; t, prim, b1, b2 out
PRIM_AGREE_MIN = 0.999
OCC_AGREE_MIN = 0.9999
RTOL, ATOL = 1e-5, 1e-6
RELMAE_MAX = 1e-3
STREAM_SOURCE = "grail_torch/kernels/csrc/bvh_stream.cu"
STREAM_REPLACES = {"ordered": "grail/kernels/bvh_stream.py:269",
                   "skip": "grail/kernels/bvh_stream.py:414"}
BVH4_SOURCE = "grail_torch/kernels/csrc/bvh4.cu"
# each 4-wide kernel: the record-stream kernel it replaces on the main path
BVH4_REPLACES = {"bvh4_closest": "ordered_closest", "bvh4_any_hit": "skip_any_hit"}
NODE_BYTES, TRI_BYTES = 128, 48


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          check=True).stdout.strip()


def relative_mae(a, b):
    return float(np.mean(np.abs(a - b)) / (np.mean(np.abs(b)) + 1e-6))


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of fn() over reps launches (CUDA events, warmed up)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def ray_cases(scene, meta, dev):
    """{name: (o, d, tmin, tmax)} at N_RAYS rays: the bench camera wave,
    rays from inside the box (secondary waves), and shadow rays with random
    lengths, some of them dead lanes (tmax = 0)."""
    pix, samp, _ = megawave_lanes(meta, 0, meta.sampler.spp, dev)
    rays = camera_rays(scene, meta, pix, samp)[0]
    check(rays["o"].shape[0] == N_RAYS, "bench megawave is 1M rays")
    gen = torch.Generator(device=dev).manual_seed(0)

    def inside(n):
        lo = torch.tensor([-0.99, 0.01, -0.99], device=dev)
        return lo + torch.rand(n, 3, device=dev, generator=gen) * 1.98

    def dirs(n):
        v = torch.randn(n, 3, device=dev, generator=gen)
        return v / torch.linalg.vector_norm(v, dim=1, keepdim=True)

    zeros = torch.zeros(N_RAYS, device=dev)
    big = torch.full((N_RAYS,), 1.0e7, device=dev)
    shadow_t = torch.rand(N_RAYS, device=dev, generator=gen) * 2.5
    shadow_t[: N_RAYS // 8] = 0.0
    return {
        "camera_wave": (rays["o"].contiguous(), rays["d"].contiguous(), zeros, big),
        "secondary": (inside(N_RAYS), dirs(N_RAYS), zeros, big),
        "shadow": (inside(N_RAYS), dirs(N_RAYS), zeros, shadow_t),
    }


def compare(kern, plain, any_hit=False):
    """Mismatch count of prim, and the max |difference| of t, b1, b2 where
    prim agrees; raises beyond the stated tolerance (and, for any hit, if
    the occlusion masks agree on fewer than OCC_AGREE_MIN of the rays)."""
    t_k, p_k, b1_k, b2_k = kern
    t_p, p_p, b1_p, b2_p = plain[:4]
    same = p_k == p_p
    n_bad = int((~same).sum())
    errs = {}
    for name, a, b in (("t", t_k, t_p), ("b1", b1_k, b1_p), ("b2", b2_k, b2_p)):
        a, b = a[same], b[same]
        errs[name] = float((a - b).abs().max()) if a.numel() else 0.0
        check(bool(torch.all((a - b).abs() <= ATOL + RTOL * b.abs())),
              f"{name} outside rtol {RTOL}, atol {ATOL}")
    bitwise = (n_bad == 0 and all(torch.equal(x, y) for x, y in zip(kern, plain)))
    check(1.0 - n_bad / p_k.numel() >= PRIM_AGREE_MIN,
          f"prim disagrees on {n_bad} of {p_k.numel()} rays")
    if any_hit:
        occ_agree = float(((p_k >= 0) == (p_p >= 0)).float().mean())
        check(occ_agree >= OCC_AGREE_MIN, f"occlusion agrees on {occ_agree:.6f}")
    return n_bad, errs, bitwise


def against_replaced(new, old, args, any_hit, scene):
    """Mismatch counts of a 4-wide kernel against the record-stream kernel it
    replaces, on the same rays; raises beyond the stated thresholds. t, b1
    and b2 must be bitwise equal where prim agrees. Closest hit: prim agrees
    on >= PRIM_AGREE_MIN of the rays. Any hit: occlusion agrees on
    >= OCC_AGREE_MIN, and since the two walks visit in other orders (near
    first here, preorder there) the first occluder found may differ, so
    instead of prim, >= PRIM_AGREE_MIN of the reported triangles must be
    real hits of their rays in (tmin, tmax) by moller_trumbore."""
    same = new[1] == old[1]
    n = new[1].numel()
    n_prim = int((~same).sum())
    n_occ = int(((new[1] >= 0) != (old[1] >= 0)).sum())
    check(all(torch.equal(a[same], b[same]) for a, b in zip(new, old)),
          "t, b1, b2 differ from the replaced kernel where prim agrees")
    out = {"prim_mismatch": n_prim, "occlusion_mismatch": n_occ}
    if not any_hit:
        check(1.0 - n_prim / n >= PRIM_AGREE_MIN,
              f"prim disagrees with the replaced kernel on {n_prim} of {n} rays")
        return out
    check(1.0 - n_occ / n >= OCC_AGREE_MIN,
          f"occlusion disagrees with the replaced kernel on {n_occ} of {n} rays")
    hit = new[1] >= 0
    o, d, tmin, tmax = (a[hit] for a in args)
    idx = scene["tri_idx"][new[1][hit].long()].long()
    v = scene["verts"]
    v0 = v[idx[:, 0]]
    real = moller_trumbore(o, d, v0, v[idx[:, 1]] - v0, v[idx[:, 2]] - v0, tmin, tmax)[0]
    out["reported_not_real_hit"] = int((~real).sum())
    check(float(real.float().mean()) >= PRIM_AGREE_MIN,
          f"{out['reported_not_real_hit']} reported occluders are not hits")
    return out


def cornell_phases(dev, gpu):
    """Phases 3-5; returns the brute_intersect entry of the kernels line."""
    t0 = time.perf_counter()
    scene, meta, _ = cornell_box(256, 256, 16, device=dev)
    tris9 = pack_tris(scene)
    cases = ray_cases(scene, meta, dev)
    max_err = 0.0
    with torch.no_grad():
        for case, args in cases.items():
            for any_hit in (False, True):
                kern = bi.brute_intersect(tris9, *args, any_hit=any_hit)
                plain = bi.brute_intersect_plain(tris9, *args, any_hit=any_hit)
                torch.cuda.synchronize()
                n_bad, errs, bitwise = compare(kern, plain)
                max_err = max([max_err] + list(errs.values()))
                emit({"phase": "parity", "scene": "cornell", "kernel": "brute_intersect",
                      "case": case, "any_hit": any_hit, "rays": args[0].shape[0],
                      "hits": int((kern[1] >= 0).sum()), "prim_mismatch": n_bad,
                      "max_abs_diff": errs, "bitwise_equal": bitwise})
    emit({"phase": "parity", "scene": "cornell", "seconds": time.perf_counter() - t0})

    # the main path on the card against the same render on the CPU
    # (the entry() configuration: 64x64, 4 spp, max depth 3)
    t0 = time.perf_counter()
    cfg_e = IntegratorConfig(kind="path", max_depth=3)
    imgs = {}
    for where in (dev, torch.device("cpu")):
        sc, mt, _ = cornell_box(64, 64, 4, device=where)
        imgs[where.type] = render(sc, mt, cfg_e, spp=4, device=where)[0].cpu().numpy()
    err = relative_mae(imgs["cuda"], imgs["cpu"])
    emit({"phase": "main_path_vs_cpu", "scene": "cornell", "res": 64, "spp": 4,
          "max_depth": 3, "relative_mae": err,
          "bitwise_equal": bool(np.array_equal(imgs["cuda"], imgs["cpu"])),
          "seconds": time.perf_counter() - t0})
    check(np.isfinite(imgs["cuda"]).all() and err < RELMAE_MAX,
          f"GPU render differs from the CPU render (relative MAE {err})")

    # the bench render through the kernel: one warm-up, three timed
    t0 = time.perf_counter()
    cfg = IntegratorConfig(kind="path", max_depth=5)
    spp = meta.sampler.spp
    render(scene, meta, cfg, spp=spp, device=dev)
    torch.cuda.synchronize()
    times, launches = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        bi.LAUNCHES = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img, _ = render(scene, meta, cfg, spp=spp, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        launches.append(bi.LAUNCHES)
    img = img.cpu().numpy()
    expected = 2 * (cfg.max_depth + 1)       # one closest hit + one shadow ray a bounce
    emit({"phase": "bench", "scene": "cornell", "res": 256, "spp": spp,
          "max_depth": cfg.max_depth, "render_seconds": times,
          "camera_rays_per_sec": meta.xres * meta.yres * spp / statistics.median(times),
          "brute_intersect_launches_per_render": launches,
          "expected_launches": expected, "image_mean": float(img.mean()),
          "isfinite": bool(np.isfinite(img).all()),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
          "seconds": time.perf_counter() - t0})
    check(all(n == expected for n in launches),
          f"brute_intersect launched {launches} times per render, want {expected}")
    check(np.isfinite(img).all() and img.shape == (256, 256, 3) and img.mean() > 0.0,
          "bench image is not finite and positive")

    # kernel, plain version and bound at the main path's shapes
    o, d, tmin, tmax = cases["camera_wave"]
    n, n_tris = o.shape[0], tris9.shape[0]
    with torch.no_grad():
        ms = cuda_ms(lambda: bi.brute_intersect(tris9, o, d, tmin, tmax), 50)
        plain_ms = cuda_ms(lambda: bi.brute_intersect_plain(tris9, o, d, tmin, tmax), 5)
        so, sd, smin, smax = cases["shadow"]
        any_ms = cuda_ms(lambda: bi.brute_intersect(tris9, so, sd, smin, smax,
                                                    any_hit=True), 50)
    live = int((tmax > tmin).sum())
    bytes_moved = n * (12 + 12 + 4 + 4) + n_tris * 36 + n * 16
    ops = OPS_PER_PAIR * live * n_tris
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FP32_OPS * 1e3
    emit({"phase": "kernel_time", "kernel": "brute_intersect", "case": "camera_wave",
          "rays": n, "triangles": n_tris, "ms": ms, "plain_ms": plain_ms,
          "any_hit_shadow_ms": any_ms, "bytes": bytes_moved, "operations": ops,
          "bytes_ms": t_bytes, "operations_ms": t_ops, "gpu": gpu})
    return {"name": "brute_intersect", "route": "cuda",
            "source": "grail_torch/kernels/csrc/brute_intersect.cu",
            "replaces": "grail/kernels/pallas_intersect.py:31",
            "launches": launches[0], "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None}


def mesh_ray_cases(scene, meta, dev):
    """{kernel: (case, o, d, tmin, tmax)} at N_RAYS rays, each made as the
    intersect dispatch hands rays to that kernel: the bench camera wave
    (skip, closest); a secondary wave from the camera wave's hit points in
    random directions toward the camera's side, binned and sorted with its
    dead lanes (the misses) inert and last (ordered, closest and any hit);
    shadow rays from the hit points with random lengths and 1/8 dead lanes
    (skip, any hit)."""
    pix, samp, _ = megawave_lanes(meta, 0, meta.sampler.spp, dev)
    rays = camera_rays(scene, meta, pix, samp)[0]
    o, d = rays["o"].contiguous(), rays["d"].contiguous()
    check(o.shape[0] == N_RAYS, "bench megawave is 1M rays")
    zeros = torch.zeros(N_RAYS, device=dev)
    big = torch.full((N_RAYS,), 1.0e7, device=dev)
    t, prim, _, _ = bs.stream_traverse(scene["bvh"]["stream"], o, d, zeros, big)
    hit = prim >= 0
    p = o + (t * (1.0 - 1e-4))[:, None] * d
    p = torch.where(hit[:, None], p, o)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(N_RAYS, 3, device=dev, generator=gen)
    w = w / torch.linalg.vector_norm(w, dim=1, keepdim=True)
    w = torch.where(((w * d).sum(1) > 0)[:, None], -w, w)
    dead = ~hit
    tmin2 = torch.where(dead, BIG_T, 0.0)
    tmax2 = torch.where(dead, -BIG_T, 1.0e7)
    vmin, vmax = scene["verts"].amin(0), scene["verts"].amax(0)
    key = torch.where(dead, N_RAY_BUCKETS, bin_rays_key(p, w, vmin, vmax))
    secondary = sort_by_rank(bucket_rank(key, N_RAY_BUCKETS + 1), p, w, tmin2, tmax2)
    shadow_t = torch.rand(N_RAYS, device=dev, generator=gen) * 3.0
    dead = torch.zeros(N_RAYS, dtype=torch.bool, device=dev)
    dead[: N_RAYS // 8] = True
    shadow = (p.contiguous(), w.flip(0).contiguous(), torch.where(dead, BIG_T, 0.0),
              torch.where(dead, -BIG_T, shadow_t))
    return {"skip_closest": ("camera_wave", o, d, zeros, big),
            "ordered_closest": ("sorted_secondary", *secondary),
            "ordered_any_hit": ("sorted_secondary", *secondary),
            "skip_any_hit": ("shadow", *shadow)}


def _kind(name):
    return name.split("_", 1)[0], name.endswith("any_hit")


def mesh_phases(dev, gpu):
    """Phases 6-9; returns the four bvh_stream and the two bvh4 entries of
    the kernels line."""
    t0 = time.perf_counter()
    scene, meta, _ = mesh_scene(256, 256, 16, grid=MESH_GRID, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    table, depth = scene["bvh"]["stream"], scene["bvh"]["depth"]
    nodes, tris4, stack = (scene["bvh"][k] for k in ("bvh4_nodes", "bvh4_tris",
                                                      "bvh4_stack"))
    emit({"phase": "mesh_scene", "grid": MESH_GRID, "triangles": meta.n_tris,
          "records": table.shape[0] * bs.RECS_PER_ROW, "table_bytes": table.numel() * 4,
          "tree_depth": depth, "bvh4_nodes": nodes.shape[0],
          "bvh4_table_bytes": (nodes.numel() + tris4.numel()) * 4,
          "bvh4_stack_bound": stack, "host_build_seconds": build_s})

    t0 = time.perf_counter()
    with torch.no_grad():
        cases = mesh_ray_cases(scene, meta, dev)
    results = {}
    for name in bs.KERNELS:
        kind, any_hit = _kind(name)
        case, *args = cases[name]
        with torch.no_grad():
            kern = bs.stream_traverse(table, *args, any_hit=any_hit, kind=kind,
                                      depth=depth)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            plain = bs.stream_traverse_plain(table, *args, any_hit=any_hit, kind=kind)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
        n_bad, errs, bitwise = compare(kern, plain, any_hit)
        live = int((args[3] > args[2]).sum())
        visits = (int(plain[4].sum()), int(plain[5].sum()))
        results[name] = {"case": case, "args": args, "errs": errs, "live": live,
                         "visits": visits, "plain_s": plain_s, "kern": kern}
        emit({"phase": "parity", "scene": "mesh100k", "kernel": f"bvh_stream_{name}",
              "case": case, "rays": N_RAYS, "live_rays": live,
              "hits": int((kern[1] >= 0).sum()), "prim_mismatch": n_bad,
              "occlusion_mismatch": int(((kern[1] >= 0) != (plain[1] >= 0)).sum()),
              "max_abs_diff": errs, "bitwise_equal": bitwise,
              "box_visits": visits[0], "tri_visits": visits[1],
              "max_visits_per_ray": int((plain[4] + plain[5]).max()),
              "plain_seconds": plain_s})
    # the 4-wide kernels on the rays of the kernels they replace
    results4 = {}
    for name, old in BVH4_REPLACES.items():
        any_hit = name == "bvh4_any_hit"
        r = results[old]
        with torch.no_grad():
            kern = b4.bvh4_traverse(nodes, tris4, *r["args"], any_hit=any_hit,
                                    stack=stack)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            plain = b4.bvh4_traverse_plain(nodes, tris4, *r["args"], any_hit=any_hit,
                                           stack=stack)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t1
            n_bad, errs, bitwise = compare(kern, plain, any_hit)
            vs_old = against_replaced(kern, r["kern"], r["args"], any_hit, scene)
        counts = tuple(int(x.sum()) for x in plain[4:])
        results4[name] = {"errs": errs, "counts": counts}
        # items (node fetches + triangle tests) per ray, over warps of 32
        # consecutive rays: the share of lanes busy while the warp walks
        items = (plain[4] + plain[6]).view(-1, 32).double()
        lane_use = float(items.mean(1).sum() / items.amax(1).sum())
        emit({"phase": "parity", "scene": "mesh100k", "kernel": name, "case": r["case"],
              "rays": N_RAYS, "live_rays": r["live"], "hits": int((kern[1] >= 0).sum()),
              "prim_mismatch": n_bad,
              "occlusion_mismatch": int(((kern[1] >= 0) != (plain[1] >= 0)).sum()),
              "max_abs_diff": errs, "bitwise_equal": bitwise,
              f"vs_bvh_stream_{old}": vs_old, "node_fetches": counts[0],
              "box_tests": counts[1], "tri_tests": counts[2],
              "max_node_fetches_per_ray": int(plain[4].max()),
              "warp_lane_use": lane_use, "plain_seconds": plain_s})
        check(bitwise, f"{name} is not bitwise equal to its plain version")
    # keep only the rays and counts: the outputs would count in the bench
    # render's peak memory
    del kern, plain
    for r in results.values():
        del r["kern"]
    emit({"phase": "parity", "scene": "mesh100k", "seconds": time.perf_counter() - t0})

    # the main path on the card against the same render on the CPU, at
    # 16,384 lanes: above the dispatch's binning threshold (SORT_MIN) at
    # every bounce, also after the pre-RR split halves the wave, so the
    # comparison runs the binned, ordered route as the bench render does
    t0 = time.perf_counter()
    cfg_e = IntegratorConfig(kind="path", max_depth=3)
    res_e, spp_e = 64, 4
    imgs = {}
    for where in (dev, torch.device("cpu")):
        sc, mt, _ = mesh_scene(res_e, res_e, spp_e, grid=MESH_GRID, device=where)
        for counts in (bs.LAUNCHES, b4.LAUNCHES):
            counts.update(dict.fromkeys(counts, 0))
        imgs[where.type] = render(sc, mt, cfg_e, spp=spp_e,
                                  device=where)[0].cpu().numpy()
        if where.type == "cuda":
            gpu_launches = dict(bs.LAUNCHES, **b4.LAUNCHES)
    err = relative_mae(imgs["cuda"], imgs["cpu"])
    emit({"phase": "main_path_vs_cpu", "scene": "mesh100k", "res": res_e,
          "spp": spp_e, "max_depth": 3, "lanes": res_e * res_e * spp_e,
          "sort_min": SORT_MIN, "gpu_launches": gpu_launches, "relative_mae": err,
          "bitwise_equal": bool(np.array_equal(imgs["cuda"], imgs["cpu"])),
          "seconds": time.perf_counter() - t0})
    check(res_e * res_e * spp_e // 2 >= SORT_MIN, "comparison wave below SORT_MIN")
    check(gpu_launches == {"skip_closest": 1, "skip_any_hit": 0, "ordered_closest": 0,
                           "ordered_any_hit": 0, "bvh4_closest": cfg_e.max_depth,
                           "bvh4_any_hit": cfg_e.max_depth + 1},
          f"GPU mesh render took {gpu_launches}, not the binned route")
    check(np.isfinite(imgs["cuda"]).all() and err < RELMAE_MAX,
          f"GPU mesh render differs from the CPU render (relative MAE {err})")

    # the bench render through the kernels: one warm-up, three timed
    t0 = time.perf_counter()
    cfg = IntegratorConfig(kind="path", max_depth=5)
    spp = meta.sampler.spp
    render(scene, meta, cfg, spp=spp, device=dev)
    torch.cuda.synchronize()
    times, launches = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    for _ in range(3):
        for counts in (bs.LAUNCHES, b4.LAUNCHES):
            counts.update(dict.fromkeys(counts, 0))
        bi.LAUNCHES = 0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img, _ = render(scene, meta, cfg, spp=spp, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        launches.append(dict(bs.LAUNCHES, **b4.LAUNCHES, brute_intersect=bi.LAUNCHES))
    img = img.cpu().numpy()
    # one megawave of 1M rays: the camera wave's closest hit (skip), the
    # binned closest hits of bounces 1-5 (4-wide), one shadow wave a bounce
    # (4-wide)
    expected = {"skip_closest": 1, "skip_any_hit": 0, "ordered_closest": 0,
                "ordered_any_hit": 0, "bvh4_closest": cfg.max_depth,
                "bvh4_any_hit": cfg.max_depth + 1, "brute_intersect": 0}
    emit({"phase": "bench", "scene": "mesh100k", "res": 256, "spp": spp,
          "max_depth": cfg.max_depth, "grid": MESH_GRID, "render_seconds": times,
          "camera_rays_per_sec": meta.xres * meta.yres * spp / statistics.median(times),
          "launches_per_render": launches, "expected_launches": expected,
          "host_build_seconds": build_s, "image_mean": float(img.mean()),
          "isfinite": bool(np.isfinite(img).all()),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
          "held_before_render_bytes": held, "seconds": time.perf_counter() - t0})
    check(all(n == expected for n in launches),
          f"traversal kernels launched {launches} per render, want {expected}")
    check(np.isfinite(img).all() and img.shape == (256, 256, 3) and img.mean() > 0.0,
          "bench image is not finite and positive")

    # each kernel's time, its plain version's and its bound at 1M rays
    t0 = time.perf_counter()
    entries = []
    for name in bs.KERNELS:
        kind, any_hit = _kind(name)
        r = results[name]
        args = r["args"]
        with torch.no_grad():
            ms = cuda_ms(lambda: bs.stream_traverse(table, *args, any_hit=any_hit,
                                                    kind=kind, depth=depth), 20)
            plain_ms = cuda_ms(lambda: bs.stream_traverse_plain(
                table, *args, any_hit=any_hit, kind=kind), 1, warmup=0)
        n_box, n_tri = r["visits"]
        ops = OPS_PER_BOX * n_box + OPS_PER_PAIR * n_tri
        bytes_moved = N_RAYS * RAY_BYTES + table.numel() * 4
        t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FP32_OPS * 1e3
        emit({"phase": "kernel_time", "kernel": f"bvh_stream_{name}", "case": r["case"],
              "rays": N_RAYS, "live_rays": r["live"], "ms": ms, "plain_ms": plain_ms,
              "box_visits": n_box, "tri_visits": n_tri,
              "record_bytes_read": (n_box + n_tri) * bs.FIELDS * 4,
              "bytes": bytes_moved, "operations": ops, "bytes_ms": t_bytes,
              "operations_ms": t_ops, "gpu": gpu})
        entries.append({
            "name": f"bvh_stream_{name}", "route": "cuda", "source": STREAM_SOURCE,
            "replaces": STREAM_REPLACES[kind], "launches": launches[0][name],
            "max_abs_err": max(r["errs"].values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None})
    # each 4-wide kernel in turns with the kernel it replaces (old, new,
    # new, old); its bound counts its own walk: the ray bytes and the 4-wide
    # tables once, 26 operations a slab test and 55 a triangle test. The
    # bound of the replaced kernel's walk on these rays (the record table,
    # the records it visits) is printed beside it as bound_ms_record_walk.
    table4_bytes = (nodes.numel() + tris4.numel()) * 4
    for name, old in BVH4_REPLACES.items():
        any_hit = name == "bvh4_any_hit"
        r = results[old]
        args = r["args"]
        old_kind = _kind(old)[0]
        runs = {"old": lambda: bs.stream_traverse(table, *args, any_hit=any_hit,
                                                  kind=old_kind, depth=depth),
                "new": lambda: b4.bvh4_traverse(nodes, tris4, *args, any_hit=any_hit,
                                                stack=stack)}
        turns = {k: [] for k in runs}
        with torch.no_grad():
            for who in ("old", "new", "new", "old"):
                turns[who].append(cuda_ms(runs[who], 20))
            plain_ms = cuda_ms(lambda: b4.bvh4_traverse_plain(
                nodes, tris4, *args, any_hit=any_hit, stack=stack), 1, warmup=0)
        ms = statistics.mean(turns["new"])
        n_node, n_test, n_tri4 = results4[name]["counts"]
        ops = OPS_PER_BOX * n_test + OPS_PER_PAIR * n_tri4
        bytes_moved = N_RAYS * RAY_BYTES + table4_bytes
        t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FP32_OPS * 1e3
        n_box, n_tri = r["visits"]
        rec_bound = max((N_RAYS * RAY_BYTES + table.numel() * 4) / PEAK_BYTES,
                        (OPS_PER_BOX * n_box + OPS_PER_PAIR * n_tri) / PEAK_FP32_OPS) * 1e3
        emit({"phase": "kernel_time", "kernel": name, "case": r["case"], "rays": N_RAYS,
              "live_rays": r["live"], "ms": ms, "ms_turns": turns, "plain_ms": plain_ms,
              "fill_blocks": b4.fill_blocks(dev.index, any_hit, stack),
              "node_fetches": n_node, "box_tests": n_test, "tri_tests": n_tri4,
              "bytes_read": n_node * NODE_BYTES + n_tri4 * TRI_BYTES,
              "bytes": bytes_moved, "operations": ops, "bytes_ms": t_bytes,
              "operations_ms": t_ops, "replaced": f"bvh_stream_{old}",
              "replaced_box_visits": n_box, "replaced_tri_visits": n_tri,
              "bound_ms_record_walk": rec_bound, "gpu": gpu})
        entries.append({
            "name": name, "route": "cuda", "source": BVH4_SOURCE,
            "replaces": STREAM_REPLACES[old_kind], "launches": launches[0][name],
            "max_abs_err": max(results4[name]["errs"].values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bound_ms_record_walk": rec_bound, "library_ms": None})

    # the camera wave, which the main path keeps on the skip kernel: the
    # 4-wide closest hit on it, checked as on the secondary wave and timed
    # in turns with the skip kernel (skip, bvh4, bvh4, skip)
    args = results["skip_closest"]["args"]
    runs = {"skip_closest": lambda: bs.stream_traverse(table, *args, kind="skip",
                                                       depth=depth),
            "bvh4_closest": lambda: b4.bvh4_traverse(nodes, tris4, *args, stack=stack)}
    with torch.no_grad():
        new = runs["bvh4_closest"]()
        plain = b4.bvh4_traverse_plain(nodes, tris4, *args, stack=stack)
        n_bad, errs, bitwise = compare(new, plain)
        vs_skip = against_replaced(new, runs["skip_closest"](), args, False, scene)
        counts = tuple(int(x.sum()) for x in plain[4:])
        del new, plain
        turns = {k: [] for k in runs}
        for who in ("skip_closest", "bvh4_closest", "bvh4_closest", "skip_closest"):
            turns[who].append(cuda_ms(runs[who], 20))
    check(bitwise, "bvh4_closest is not bitwise equal to its plain version "
                   "on the camera wave")
    emit({"phase": "kernel_time", "kernel": "bvh4_closest", "case": "camera_wave",
          "rays": N_RAYS, "ms": statistics.mean(turns["bvh4_closest"]),
          "skip_closest_ms": statistics.mean(turns["skip_closest"]), "ms_turns": turns,
          "bitwise_equal": bitwise, "prim_mismatch": n_bad,
          "vs_bvh_stream_skip_closest": vs_skip, "node_fetches": counts[0],
          "box_tests": counts[1], "tri_tests": counts[2],
          "skip_box_visits": results["skip_closest"]["visits"][0],
          "skip_tri_visits": results["skip_closest"]["visits"][1], "gpu": gpu})
    emit({"phase": "kernel_time", "scene": "mesh100k", "seconds": time.perf_counter() - t0})
    return entries


def main():
    check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. environment
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    emit({"phase": "environment", "gpu": gpu, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": run([build.nvcc_path(), "--version"])
          .splitlines()[-1], "python": sys.version.split()[0]})

    # 2. build every kernel from the sources in this checkout
    t0 = time.perf_counter()
    built = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {name: {"seconds": sec,
                             "ptxas": [ln.strip() for ln in log.splitlines()
                                       if "entry function" in ln or "Used" in ln
                                       or "spill" in ln]}
                      for name, (sec, log) in built.items()}})

    kernels = [cornell_phases(dev, gpu)] + mesh_phases(dev, gpu)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
