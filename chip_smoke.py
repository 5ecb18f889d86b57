#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (grail_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line with its seconds; any
failure ends the run with a non-zero exit code:
  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build: every CUDA kernel of the port, compiled from the sources here
     (one nvcc per source, all started together), with ptxas's registers
     and spills per kernel instance, and the brute-force kernel's static
     instructions a ray-triangle pair (its triangle loop in cuobjdump -sass);
  Cornell box (36 triangles, brute-force intersector):
  3. parity: both instances (closest and any hit) against their plain
     PyTorch version on the card at the main path's shapes (1,048,576 rays)
     and at a ragged count (1,048,613), bitwise;
  4. main path: a render on the card against the same render on the CPU;
  5. bench: the bench render (256x256, 16 spp, path integrator, max depth 5)
     through the kernel, with its launch counts, and each instance's time
     beside its plain version, its bound (the operations of the stages of
     the hit test that each pair needs) and its issue time were every pair
     to take every path of its loop;
  mesh100k (the 100k-triangle terrain at grid=224, BVH traversal):
  6. parity: each of the four record-stream kernels against its plain
     version at 1,048,576 rays: the bench camera wave (skip, closest hit), a
     binned incoherent secondary wave (ordered, closest and any hit) and
     shadow rays with random lengths and 1/8 dead lanes (skip, any hit); the
     two 4-wide kernels on the rays of the kernels they replace on the main
     path (closest hit on the secondary wave and on the camera wave, any hit
     on the shadow rays), against their plain versions and against those
     kernels;
  7. main path: a 64x64, 4 spp, depth 3 render on the card against the CPU,
     through the 4-wide route;
  8. bench: the bench render (256x256, 16 spp, depth 5) through the kernels,
     with launches per render of each kernel, the closest hit's split by
     wave (camera, binned);
  9. kernel_time: each traversal kernel's ms per launch beside its plain
     version and its bound; each 4-wide kernel timed in turns with the
     kernel it replaces, on each wave it takes.
Then a {"kernels": [...]} line and, last, {"ok": true, "device": {...}}.
Needs a CUDA device and nvcc; imports nothing of JAX.
"""
import json
import os
import re
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
from grail_torch.kernels.intersect import (BIG_T, CLOSEST_WAVES, SORT_MIN,
                                           moller_trumbore, pack_tris)
from grail_torch.native import build_bvh_native
from grail_torch.scene.presets import cornell_box, mesh_scene

N_RAYS = 1 << 20
MESH_GRID = 224
# H100 SXM published peaks (dense, at the 700 W limit): FP32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
# Möller-Trumbore and its hit test per ray-triangle pair, by stage of the
# predicate (a conjunction, so a pair that fails a stage needs no later one):
# s1, the divisor, its guard and reciprocal, s, b1 and the divisor and b1
# tests (29); s2, b2, b1 + b2 and their tests (18); t and its two tests (8)
OPS_STAGES = (29, 18, 8)
OPS_PER_PAIR = sum(OPS_STAGES)   # every stage: 55
LANES_PER_SM = 128         # FP32 lanes of a Hopper SM: one instruction a lane a clock
# slab test per box record (bvh_stream.cu): 6 subtracts, 6 multiplies, one
# min and one max per axis (6), 4 min/max across axes, 1 multiply and
# 3 compares
OPS_PER_BOX = 26
RAY_BYTES = 12 + 12 + 4 + 4 + 16   # o, d, tmin, tmax in; t, prim, b1, b2 out
PRIM_AGREE_MIN = 0.999
OCC_AGREE_MIN = 0.9999
RTOL, ATOL = 1e-5, 1e-6
RELMAE_MAX = 1e-3
SLEEP_CYCLES = 100_000_000    # ~50 ms of the card's clock ahead of a timed run
STREAM_SOURCE = "grail_torch/kernels/csrc/bvh_stream.cu"
STREAM_REPLACES = {"ordered": "grail/kernels/bvh_stream.py:269",
                   "skip": "grail/kernels/bvh_stream.py:414"}
BVH4_SOURCE = "grail_torch/kernels/csrc/bvh4.cu"
# each 4-wide kernel, the record-stream kernel it replaces on the main path
# and the dispatch's closest-hit route (intersect.CLOSEST_WAVES), one entry a
# wave: closest hit on binned secondary waves, any hit on shadow waves,
# closest hit on the camera wave
BVH4_REPLACES = (("bvh4_closest", "ordered_closest", "binned"),
                 ("bvh4_any_hit", "skip_any_hit", None),
                 ("bvh4_closest", "skip_closest", "unbinned"))
BRUTE_SOURCE = "grail_torch/kernels/csrc/brute_intersect.cu"
RAGGED = 37                # rays past 1M in the ragged parity case
NODE_BYTES, TRI_BYTES = 128, 48


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          check=True).stdout.strip()


def sass_loop_instructions(name):
    """{function: instructions of its largest loop} of kernel library
    `name`, from cuobjdump -sass (a loop: the span from a backward branch's
    target to the branch, every path and out-of-line block inside it); None
    where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", build.lib_path(name)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    loops = {}
    for chunk in out.split("Function : ")[1:]:
        fn = chunk.split(None, 1)[0]
        best = 0
        for addr, target in re.findall(r"/\*([0-9a-f]+)\*/[^;]*?\bBRA\b[^;]*?0x([0-9a-f]+)",
                                       chunk):
            a, t = int(addr, 16), int(target, 16)
            if t <= a:
                best = max(best, (a - t) // 16 + 1)
        loops[fn] = best
    return loops


def relative_mae(a, b):
    return float(np.mean(np.abs(a - b)) / (np.mean(np.abs(b)) + 1e-6))


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of fn() over reps launches (CUDA events, warmed up).
    A sleep kernel queued first keeps the card busy while the host queues
    the launches, so a wrapper's host time per call, which can exceed a
    short kernel's, does not count."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
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


def cornell_phases(dev, gpu, issue_rate, sass):
    """Phases 3-5; returns the entries of the kernels line of the brute-force
    kernel's two instances (closest hit, any hit)."""
    t0 = time.perf_counter()
    scene, meta, _ = cornell_box(256, 256, 16, device=dev)
    tris9 = pack_tris(scene)
    cases = ray_cases(scene, meta, dev)
    max_err = dict.fromkeys(bi.KERNELS, 0.0)
    with torch.no_grad():
        for case, args in cases.items():
            ragged = tuple(torch.cat([a, a[:RAGGED]]).contiguous() for a in args)
            for rays in (args, ragged):
                for any_hit in (False, True):
                    name = bi.KERNELS[int(any_hit)]
                    kern = bi.brute_intersect(tris9, *rays, any_hit=any_hit)
                    plain = bi.brute_intersect_plain(tris9, *rays, any_hit=any_hit)
                    torch.cuda.synchronize()
                    n_bad, errs, bitwise = compare(kern, plain)
                    max_err[name] = max([max_err[name]] + list(errs.values()))
                    emit({"phase": "parity", "scene": "cornell", "kernel": name,
                          "case": case, "rays": rays[0].shape[0],
                          "hits": int((kern[1] >= 0).sum()), "prim_mismatch": n_bad,
                          "max_abs_diff": errs, "bitwise_equal": bitwise})
                    check(bitwise, f"{name} is not bitwise equal to its plain version "
                                   f"({case}, {rays[0].shape[0]} rays)")
    del kern, plain
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
        bi.LAUNCHES.update(dict.fromkeys(bi.LAUNCHES, 0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img, _ = render(scene, meta, cfg, spp=spp, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        launches.append(dict(bi.LAUNCHES))
    img = img.cpu().numpy()
    # one closest hit and one shadow ray a bounce
    expected = dict.fromkeys(bi.KERNELS, cfg.max_depth + 1)
    emit({"phase": "bench", "scene": "cornell", "res": 256, "spp": spp,
          "max_depth": cfg.max_depth, "render_seconds": times,
          "camera_rays_per_sec": meta.xres * meta.yres * spp / statistics.median(times),
          "launches_per_render": launches,
          "expected_launches": expected, "image_mean": float(img.mean()),
          "isfinite": bool(np.isfinite(img).all()),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
          "seconds": time.perf_counter() - t0})
    check(all(n == expected for n in launches),
          f"brute_intersect launched {launches} per render, want {expected}")
    check(np.isfinite(img).all() and img.shape == (256, 256, 3) and img.mean() > 0.0,
          "bench image is not finite and positive")

    # each instance's time, its plain version's and its bound at the main
    # path's shapes: closest hit on the camera wave, any hit on the shadow
    # rays. Pairs counted as this run's rays need them: a live ray tests
    # every triangle, an any-hit ray up to its first hit; each pair's
    # operations by the stages of the hit test it reaches (OPS_STAGES).
    # Beside it, the bound with every stage counted for every pair (55),
    # and those pairs times the kernel's static instructions a pair (its
    # triangle loop over the rays a thread, every path) over the card's FP32
    # issue rate: its issue time were every pair to take every path; a warp
    # issues only the paths one of its lanes takes.
    n_tris = tris9.shape[0]
    per_thread = int(re.search(r"kRays = (\d+);",
                               open(BRUTE_SOURCE).read()).group(1))
    entries = []
    for any_hit, case in ((False, "camera_wave"), (True, "shadow")):
        name = bi.KERNELS[int(any_hit)]
        o, d, tmin, tmax = cases[case]
        n = o.shape[0]
        with torch.no_grad():
            ms = cuda_ms(lambda: bi.brute_intersect(tris9, o, d, tmin, tmax, any_hit), 50)
            plain_ms = cuda_ms(lambda: bi.brute_intersect_plain(tris9, o, d, tmin, tmax,
                                                                any_hit), 5)
            stages = [int(c.sum()) for c in bi.brute_intersect_plain(
                tris9, o, d, tmin, tmax, any_hit, counts=True)[4:]]
        pairs = stages[0]
        bytes_moved = n * RAY_BYTES + n_tris * 36
        ops = sum(k * c for k, c in zip(OPS_STAGES, stages))
        t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FP32_OPS * 1e3
        bound_every_pair = max(t_bytes, OPS_PER_PAIR * pairs / PEAK_FP32_OPS * 1e3)
        loop = None if sass is None else next(
            (v for k, v in sass.items() if f"ILb{int(any_hit)}E" in k), None)
        per_pair = None if loop is None else loop / per_thread
        every_path = None if per_pair is None else pairs * per_pair / issue_rate * 1e3
        emit({"phase": "kernel_time", "kernel": name, "case": case, "rays": n,
              "live_rays": int((tmax > tmin).sum()), "triangles": n_tris,
              "pairs": pairs, "pairs_past_b1": stages[1], "pairs_past_b2": stages[2],
              "ms": ms, "plain_ms": plain_ms, "bytes": bytes_moved, "operations": ops,
              "bytes_ms": t_bytes, "operations_ms": t_ops,
              "bound_ms": max(t_bytes, t_ops), "bound_ms_every_pair": bound_every_pair,
              "sass_loop_instructions": loop, "rays_per_thread": per_thread,
              "static_instructions_per_pair": per_pair,
              "issue_rate_lane_instructions_per_s": issue_rate,
              "issue_ms_every_path": every_path, "gpu": gpu})
        entries.append({"name": name, "case": case, "route": "cuda",
                        "source": BRUTE_SOURCE,
                        "replaces": "grail/kernels/pallas_intersect.py:31",
                        "launches": launches[0][name], "max_abs_err": max_err[name],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                        "bound_by": "bytes" if t_bytes > t_ops else "operations",
                        "bound_ms_every_pair": bound_every_pair, "library_ms": None})
    return entries


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
    """Phases 6-9; returns the entries of the kernels line: the four
    bvh_stream kernels, and the two bvh4 kernels on each wave they take."""
    t0 = time.perf_counter()
    scene, meta, _ = mesh_scene(256, 256, 16, grid=MESH_GRID, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    table, depth = scene["bvh"]["stream"], scene["bvh"]["depth"]
    nodes, tris4, stack = (scene["bvh"][k] for k in ("bvh4_nodes", "bvh4_tris",
                                                      "bvh4_stack"))
    # the record table's share of the set-up: its host packing and upload,
    # timed again on the same tree (no main-path kernel reads it)
    verts_np, idx_np = scene["verts"].cpu().numpy(), scene["tri_idx"].cpu().numpy()
    b_np = build_bvh_native(verts_np, idx_np, max_prims=4, force_leaf=4)
    t1 = time.perf_counter()
    again = torch.as_tensor(bs.build_stream_table(b_np, verts_np, idx_np), device=dev)
    torch.cuda.synchronize()
    record_s = time.perf_counter() - t1
    check(torch.equal(again, table), "record table rebuilt differs from the scene's")
    del again
    emit({"phase": "mesh_scene", "grid": MESH_GRID, "triangles": meta.n_tris,
          "records": table.shape[0] * bs.RECS_PER_ROW, "table_bytes": table.numel() * 4,
          "record_table_host_seconds": record_s,
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
    for name, old, _ in BVH4_REPLACES:
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
        results4[old] = {"errs": errs, "counts": counts}
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
        check(bitwise, f"{name} is not bitwise equal to its plain version ({r['case']})")
    # keep only the rays and counts: the outputs would count in the bench
    # render's peak memory
    del kern, plain
    for r in results.values():
        del r["kern"]
    emit({"phase": "parity", "scene": "mesh100k", "seconds": time.perf_counter() - t0})

    # the main path on the card against the same render on the CPU, at
    # 16,384 lanes: above the dispatch's binning threshold (SORT_MIN) at
    # every bounce, also after the pre-RR split halves the wave, so the
    # comparison bins every wave after the camera wave as the bench render
    # does
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
    check(gpu_launches == {"skip_closest": 0, "skip_any_hit": 0, "ordered_closest": 0,
                           "ordered_any_hit": 0, "bvh4_closest": cfg_e.max_depth + 1,
                           "bvh4_any_hit": cfg_e.max_depth + 1},
          f"GPU mesh render took {gpu_launches}, not the 4-wide route")
    check(np.isfinite(imgs["cuda"]).all() and err < RELMAE_MAX,
          f"GPU mesh render differs from the CPU render (relative MAE {err})")

    # the bench render through the kernels: one warm-up, three timed
    t0 = time.perf_counter()
    cfg = IntegratorConfig(kind="path", max_depth=5)
    spp = meta.sampler.spp
    render(scene, meta, cfg, spp=spp, device=dev)
    torch.cuda.synchronize()
    times, launches, waves = [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    for _ in range(3):
        for counts in (bs.LAUNCHES, b4.LAUNCHES, bi.LAUNCHES, CLOSEST_WAVES):
            counts.update(dict.fromkeys(counts, 0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img, _ = render(scene, meta, cfg, spp=spp, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        launches.append(dict(bs.LAUNCHES, **b4.LAUNCHES, **bi.LAUNCHES))
        waves.append(dict(CLOSEST_WAVES))
    img = img.cpu().numpy()
    # one megawave of 1M rays, every wave on the 4-wide kernels: the camera
    # wave's closest hit (unbinned), the binned closest hits of bounces 1-5,
    # one shadow wave a bounce
    expected = {"skip_closest": 0, "skip_any_hit": 0, "ordered_closest": 0,
                "ordered_any_hit": 0, "bvh4_closest": cfg.max_depth + 1,
                "bvh4_any_hit": cfg.max_depth + 1, **dict.fromkeys(bi.KERNELS, 0)}
    expected_waves = {"binned": cfg.max_depth, "unbinned": 1}
    emit({"phase": "bench", "scene": "mesh100k", "res": 256, "spp": spp,
          "max_depth": cfg.max_depth, "grid": MESH_GRID, "render_seconds": times,
          "camera_rays_per_sec": meta.xres * meta.yres * spp / statistics.median(times),
          "launches_per_render": launches, "expected_launches": expected,
          "bvh4_closest_by_wave": waves, "expected_by_wave": expected_waves,
          "host_build_seconds": build_s, "image_mean": float(img.mean()),
          "isfinite": bool(np.isfinite(img).all()),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev),
          "held_before_render_bytes": held, "seconds": time.perf_counter() - t0})
    check(all(n == expected for n in launches),
          f"traversal kernels launched {launches} per render, want {expected}")
    check(all(w == expected_waves for w in waves),
          f"bvh4_closest took waves {waves} per render, want {expected_waves}")
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
            "name": f"bvh_stream_{name}", "case": r["case"], "route": "cuda",
            "source": STREAM_SOURCE,
            "replaces": STREAM_REPLACES[kind], "launches": launches[0][name],
            "max_abs_err": max(r["errs"].values()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": None})
    # each 4-wide kernel in turns with the kernel it replaces (old, new,
    # new, old) on each wave; its bound counts its own walk on these rays:
    # the ray bytes and the 4-wide tables once, 26 operations a slab test
    # and 55 a triangle test. The bound of the replaced kernel's walk on
    # these rays (the record table, the records it visits) is printed beside
    # it as bound_ms_record_walk.
    table4_bytes = (nodes.numel() + tris4.numel()) * 4
    for name, old, wave in BVH4_REPLACES:
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
        n_node, n_test, n_tri4 = results4[old]["counts"]
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
              "operations_ms": t_ops, "bound_ms": max(t_bytes, t_ops),
              "replaced": f"bvh_stream_{old}", "replaced_ms": statistics.mean(turns["old"]),
              "replaced_box_visits": n_box, "replaced_tri_visits": n_tri,
              "bound_ms_record_walk": rec_bound, "gpu": gpu})
        entries.append({
            "name": name, "case": r["case"], "route": "cuda", "source": BVH4_SOURCE,
            "replaces": STREAM_REPLACES[old_kind],
            "launches": waves[0][wave] if wave else launches[0][name],
            "max_abs_err": max(results4[old]["errs"].values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bound_ms_record_walk": rec_bound, "library_ms": None})
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

    sass = sass_loop_instructions("brute_intersect")
    emit({"phase": "sass", "kernel": "brute_intersect",
          "loop_instructions": sass if sass is not None else "cuobjdump not available"})
    clock_mhz = float(run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                           "--format=csv,noheader,nounits"]).splitlines()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    issue_rate = sms * LANES_PER_SM * clock_mhz * 1e6

    kernels = cornell_phases(dev, gpu, issue_rate, sass) + mesh_phases(dev, gpu)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
