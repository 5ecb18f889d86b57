"""The instanced-scene benchmark (port of benchmarks/instbench.py): 100
instances of one sphere (sphere(radius=0.5, nu=224, nv=112): 50,176
triangles) in a 10x10 grid over a 2-triangle floor under one point light,
rendered once through the instanced route (the TLAS sweep and the 4-wide
walk with per-ray BLAS roots) and once with all 5,017,600 world-space
triangles baked into the base soup (one 4-wide BVH).

    python3 -m grail_torch.tools.instbench [--res 256] [--spp 4] [--depth 3]

prints one JSON line of both scenes' set-up, rates and launches, and their
ratio. Needs a CUDA device; build_instanced(32, device="cpu") builds the
instanced scene on the CPU at a small image size.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from ..core import transform as tr
from ..device import resolve_device
from ..engine import camera as cam
from ..engine.integrator import IntegratorConfig
from ..engine.render import render
from ..kernels import bvh4, instanced
from ..scene.buffers import SceneBuilder
from ..scene.shapes import sphere

N_INST = 10 * 10
SPHERE_NU, SPHERE_NV = 224, 112


def _builder(res):
    b = SceneBuilder()
    b.xres = b.yres = res
    b.matte(kd=(0.6, 0.6, 0.6))
    b.matte(kd=(0.7, 0.4, 0.3))
    ext = 14.0
    b.add_mesh(np.array([[-ext, 0, -ext], [ext, 0, -ext], [ext, 0, ext],
                         [-ext, 0, ext]], np.float32),
               np.array([[0, 1, 2], [0, 2, 3]], np.int64), 0)
    b.add_point_light((0.0, 24.0, 0.0), (2200.0, 2200.0, 2200.0))
    c2w = tr.look_at((0, 18.0, 22.0), (0, 0.5, 0), (0, 1, 0))
    b.camera = cam.build_camera(cam.PERSPECTIVE, c2w, c2w, res, res, fov=55.0)
    return b


def _positions():
    return [(-9.0 + 2.0 * c, 0.55, -9.0 + 2.0 * r) for r in range(10) for c in range(10)]


def build_instanced(res, device=None):
    """(scene, meta): N_INST instances of the sphere object."""
    v, i, n, uv = sphere(radius=0.5, nu=SPHERE_NU, nv=SPHERE_NV)
    b = _builder(res)
    oid = b.add_object()
    b.add_object_mesh(oid, v, i, 1, normals=n, uvs=uv)
    for p in _positions():
        b.add_instance(oid, tr.translate(p))
    return b.finalize(device)


def build_flattened(res, device=None):
    """(scene, meta): the same field with every sphere's triangles in world
    space in the base soup."""
    v, i, n, uv = sphere(radius=0.5, nu=SPHERE_NU, nv=SPHERE_NV)
    b = _builder(res)
    for p in _positions():
        b.add_mesh(v + np.asarray(p, np.float32), i, 1, normals=n, uvs=uv)
    return b.finalize(device)


def bench(make, res=256, spp=4, depth=3, device=None):
    """Build with make(res, device), render once to warm up, then three
    timed renders (each to torch.cuda.synchronize() on the card). Returns
    the set-up seconds, the render seconds, the median rate in camera rays/s,
    the 4-wide kernels' launches and the instanced sweeps' rounds a render,
    the peak device memory and the image's mean."""
    dev = resolve_device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    scene, meta = make(res, dev)
    sync()
    build_s = time.perf_counter() - t0
    cfg = IntegratorConfig(kind="path", max_depth=depth)
    render(scene, meta, cfg, spp=spp, device=dev)
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    seconds, launches, sweeps = [], [], []
    for _ in range(3):
        bvh4.LAUNCHES.update(dict.fromkeys(bvh4.LAUNCHES, 0))
        instanced.LAST_SWEEPS.clear()
        sync()
        t0 = time.perf_counter()
        img, _ = render(scene, meta, cfg, spp=spp, device=dev)
        sync()
        seconds.append(time.perf_counter() - t0)
        launches.append(dict(bvh4.LAUNCHES))
        sweeps.append([list(s) for s in instanced.LAST_SWEEPS])
    return {"build_seconds": build_s, "render_seconds": seconds,
            "camera_rays_per_sec": res * res * spp / statistics.median(seconds),
            "launches_per_render": launches, "sweeps_per_render": sweeps,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "image_mean": float(img.mean())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--depth", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("instbench: no CUDA device")
    out = {"n_instances": N_INST, "gpu": torch.cuda.get_device_name(0)}
    for name, make in (("instanced", build_instanced), ("flattened", build_flattened)):
        out[name] = bench(make, args.res, args.spp, args.depth)
    out["instanced_over_flattened"] = (out["instanced"]["camera_rays_per_sec"]
                                       / out["flattened"]["camera_rays_per_sec"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
