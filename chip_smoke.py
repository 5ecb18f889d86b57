#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (grail_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line; any failure ends the run
with a non-zero exit code:
  1. environment: the card's name and power limit (nvidia-smi), versions;
  2. build: every CUDA kernel of the port, compiled from the sources here;
  3. parity: each kernel against its plain PyTorch version on the card at the
     main path's shapes (1,048,576 rays);
  4. main path: a render on the card against the same render on the CPU;
  5. bench: the bench render of the Cornell box (256x256, 16 spp, path
     integrator, max depth 5) through the kernels, with their launch counts,
     and the kernels' times beside their plain versions and bounds.
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
from grail_torch.kernels import build
from grail_torch.kernels.intersect import pack_tris
from grail_torch.scene.presets import cornell_box

N_RAYS = 1 << 20
# H100 SXM published peaks (dense, at the 700 W limit): FP32 outside the
# tensor cores and HBM3 bandwidth
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12
OPS_PER_PAIR = 55          # Möller-Trumbore + hit test per ray-triangle pair
PRIM_AGREE_MIN = 0.999
RTOL, ATOL = 1e-5, 1e-6
RELMAE_MAX = 1e-3


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


def cuda_ms(fn, reps):
    """Mean device time of fn() over reps launches (CUDA events, warmed up)."""
    for _ in range(2):
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


def compare(kern, plain):
    """Mismatch count of prim, and the max |difference| of t, b1, b2 where
    prim agrees; raises beyond the stated tolerance."""
    t_k, p_k, b1_k, b2_k = kern
    t_p, p_p, b1_p, b2_p = plain
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
    return n_bad, errs, bitwise


def main():
    check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda", 0)

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
                                       if "Used" in ln or "spill" in ln]}
                      for name, (sec, log) in built.items()}})

    # 3. each kernel against its plain version on the card
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
                emit({"phase": "parity", "kernel": "brute_intersect", "case": case,
                      "any_hit": any_hit, "rays": args[0].shape[0],
                      "hits": int((kern[1] >= 0).sum()), "prim_mismatch": n_bad,
                      "max_abs_diff": errs, "bitwise_equal": bitwise})

    # 4. the main path on the card against the same render on the CPU
    #    (the entry() configuration: 64x64, 4 spp, max depth 3)
    cfg_e = IntegratorConfig(kind="path", max_depth=3)
    imgs = {}
    for where in (dev, torch.device("cpu")):
        sc, mt, _ = cornell_box(64, 64, 4, device=where)
        imgs[where.type] = render(sc, mt, cfg_e, spp=4, device=where)[0].cpu().numpy()
    err = relative_mae(imgs["cuda"], imgs["cpu"])
    emit({"phase": "main_path_vs_cpu", "res": 64, "spp": 4, "max_depth": 3,
          "relative_mae": err, "bitwise_equal": bool(np.array_equal(
              imgs["cuda"], imgs["cpu"]))})
    check(np.isfinite(imgs["cuda"]).all() and err < RELMAE_MAX,
          f"GPU render differs from the CPU render (relative MAE {err})")

    # 5. the bench render through the kernel: one warm-up, three timed
    cfg = IntegratorConfig(kind="path", max_depth=5)
    spp = meta.sampler.spp
    render(scene, meta, cfg, spp=spp, device=dev)
    torch.cuda.synchronize()
    times, launches = [], []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        bi.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, _ = render(scene, meta, cfg, spp=spp, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(bi.LAUNCHES)
    img = img.cpu().numpy()
    expected = 2 * (cfg.max_depth + 1)       # one closest hit + one shadow ray a bounce
    emit({"phase": "bench", "scene": "cornell", "res": 256, "spp": spp,
          "max_depth": cfg.max_depth, "render_seconds": times,
          "camera_rays_per_sec": meta.xres * meta.yres * spp / statistics.median(times),
          "brute_intersect_launches_per_render": launches,
          "expected_launches": expected, "image_mean": float(img.mean()),
          "isfinite": bool(np.isfinite(img).all()),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(dev)})
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

    emit({"kernels": [{
        "name": "brute_intersect", "route": "cuda",
        "source": "grail_torch/kernels/csrc/brute_intersect.cu",
        "replaces": "grail/kernels/pallas_intersect.py:31",
        "launches": launches[0], "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes > t_ops else "operations",
        "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
