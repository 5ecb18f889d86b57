"""Where the device time of one render goes, on the card.

    python3 -m grail_torch.tools.profile_render
        [--scene cornell|mesh|mesh1m|inst] [--res 256] [--spp 16] [--depth 5]
        [--grid N] [--kind path|direct|whitted|ao] [--strategy one|power|all]
        [--ao-samples N] [--mat-sort]
    python3 -m grail_torch.tools.profile_render --pbrt scenes/envlight.pbrt
        [--res N] [--spp N] [--kind igi]

Renders the Cornell box (or mesh_scene, the textured terrain of
2(grid-1)^2 triangles under an environment light, grid 224 unless given; or
mesh_scene_1m, the terrain at grid 708 seen through a thin lens by a moving
camera: bench.py's mesh1m is --spp 4; or instbench's instanced scene, 100
instances of a 50,176-triangle sphere: its bench is --spp 4 --depth 3; or a
.pbrt scene file through the port's parser, at its authored depth and
integrator, and its authored resolution and samples unless --res (a square
film) or --spp name others; --kind igi renders the file under instant GI)
with the path integrator unless --kind names another (--mat-sort: with
material-sorted shading, whose pass is the stage `megabatch`), once to warm up, once timed, then once under torch.profiler, and prints JSON
lines: the render's wall time (unprofiled and
profiled), the summed kernel time and the device's busy share (kernel time
over the unprofiled wall time), the number of kernel launches; for each stage
of the path its kernel time, the device timeline it spans and the host time
spent issuing it (all inclusive of what runs inside; sample_li lies inside
direct lighting and bsdf_eval partly inside bsdf_sample, the march's transmittance inside
`medium`, so stages nest);
and the kernels and operators that take the most device time. The stream traversal
kernels are launched through ctypes and do not appear in the profiler's
kernel list; chip_smoke.py times them with CUDA events. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from ..core import rng
from ..engine import (camera, film, igi, integrator, irradiance, photonmap, prt,
                      render as rnd, subsurface)
from ..kernels import intersect
from ..kernels import instanced
from ..scene.parser import parse_string
from ..scene.presets import cornell_box, mesh_scene, mesh_scene_1m
from ..shade import bsdf, geometry, lights, materials, measured, media, textures
from .instbench import build_instanced

# stage name -> (module, function names) wrapped in a profiler range
_STAGES = {
    "rng": (rng, ("sample_1d", "sample_2d")),
    "camera": (camera, ("generate_rays",)),
    "intersect": (intersect, ("intersect", "intersect_p")),
    "binning": (intersect, ("bin_rays_key", "bucket_rank", "sort_by_rank",
                            "unsort")),                 # inside intersect
    "traversal": (intersect, ("bvh4_traverse",)),       # inside intersect
    # the instanced sweep (inside intersect) and its parts: the (N, I) TLAS
    # cull, the rays to object space, the BLAS walk with per-ray roots
    "instanced": (intersect, ("instances_intersect",)),
    "tlas_cull": (instanced, ("_instance_nears",)),
    "to_object_space": (instanced, ("w2o_ray",)),
    "blas_walk": (instanced, ("bvh4_traverse",)),
    "uv_differentials": (geometry, ("uv_differentials",)),
    "textures": (integrator, ("eval_textures",)),
    "noise": (textures, ("noise",)),                # Perlin noise, inside textures
    "bump": (integrator, ("_apply_bump",)),
    "alpha": (integrator, ("_alpha_at",)),          # the cutouts' alpha lookups
    "environment": (lights, ("env_pdf", "escaped_radiance")),
    "shading_geometry": (geometry, ("shading_geometry",)),
    "textures_lobes": (materials, ("gather_lobes",)),
    # the material-sorted pass (mat_sort): the sort, each material's
    # textures and lobes, the BSDF work, the gather back
    "megabatch": (integrator, ("megabatch_shade",)),
    "bsdf_sample": (bsdf, ("bsdf_sample",)),
    "bsdf_eval": (bsdf, ("bsdf_f", "bsdf_pdf")),    # also inside bsdf_sample
    "sample_li": (lights, ("sample_li",)),
    "direct_lighting": (integrator, ("estimate_direct", "_whitted_light")),
    "ambient_occlusion": (integrator, ("_ao_li",)),
    "compaction": (integrator, ("_compaction_take",)),
    # participating media: the volume integrator on the camera segment (the
    # march's shadow waves inside it) and the transmittance of later
    # segments and light samples
    "medium": (media, ("single_scatter_li", "emission_li", "transmittance")),
    "measured": (measured, ("lookup",)),         # the half-angle table fetch
    # kind="dipole": the point cloud and its irradiance (once a render), and
    # the dense Mo contraction
    "dipole_preprocess": (subsurface, ("dipole_preprocess",)),
    "dipole_contraction": (subsurface, ("_mo",)),
    # the preprocessed kinds: photon shooting, the grid's sort and the
    # 27-cell scans (the k-NN histogram, the estimate, the gathered
    # directions); the irradiance cache's preprocess and its dense
    # interpolation; PRT's transfer projections (diffuse and glossy) and the
    # probes' bake; instant GI's VPL paths and its gather over the VPLs
    "photon_shoot": (photonmap, ("_shoot_block",)),
    "photon_grid": (photonmap, ("build_photon_grid",)),
    "photon_scan": (photonmap, ("_neighbor_scan",)),
    "ic_preprocess": (irradiance, ("irradiance_preprocess",)),
    "ic_interpolate": (irradiance, ("_interpolate",)),
    "prt_transfer": (prt, ("compute_diffuse_transfer", "project_transferred")),
    "probe_bake": (prt, ("bake_probes",)),
    "vpl": (igi, ("generate_vpls", "vpl_radiance")),
    "film": (film, ("add_samples_grid", "develop")),
}


def _ranged(stage, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function("stage:" + stage):
            return fn(*args, **kwargs)
    return wrapper


def _instrument():
    """Wrap each stage's functions in a named profiler range; returns the
    originals so the caller can restore them."""
    saved = []
    for stage, (module, names) in _STAGES.items():
        for name in names:
            fn = getattr(module, name)
            saved.append((module, name, fn))
            setattr(module, name, _ranged(stage, fn))
    return saved


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("cornell", "mesh", "mesh1m", "inst"),
                    default="cornell")
    ap.add_argument("--grid", type=int, help="terrain grid (default: the preset's)")
    ap.add_argument("--res", type=int, help="film side (default 256, or the "
                                            "scene file's)")
    ap.add_argument("--spp", type=int, help="samples a pixel (default 16, or the "
                                            "scene file's)")
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--pbrt", metavar="FILE",
                    help="a .pbrt scene at its authored settings (in place of "
                         "--scene, --depth and --grid)")
    ap.add_argument("--kind", choices=integrator.KINDS, default="path")
    ap.add_argument("--strategy", choices=integrator.STRATEGIES, default="one")
    ap.add_argument("--ao-samples", type=int, default=1)
    ap.add_argument("--mat-sort", action="store_true",
                    help="material-sorted shading (IntegratorConfig.mat_sort)")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_render: no CUDA device")
    dev = torch.device("cuda", 0)
    cfg = integrator.IntegratorConfig(kind=args.kind, max_depth=args.depth,
                                      light_strategy=args.strategy,
                                      ao_samples=args.ao_samples,
                                      mat_sort=args.mat_sort)
    if args.pbrt:
        with open(args.pbrt) as f:
            text = f.read()
        if args.res:
            text = re.sub(r'"integer xresolution" \[\d+\] "integer yresolution" \[\d+\]',
                          f'"integer xresolution" [{args.res}] '
                          f'"integer yresolution" [{args.res}]', text)
        if args.spp:
            text = re.sub(r'"integer pixelsamples" \[\d+\]',
                          f'"integer pixelsamples" [{args.spp}]', text)
        scene, meta, api = parse_string(text, device=dev,
                                        search_path=os.path.dirname(args.pbrt))
        cfg = api.integrator_config
        if args.kind == "igi":
            cfg = dataclasses.replace(cfg, kind="igi")
        cfg = dataclasses.replace(cfg, mat_sort=args.mat_sort)
        args.scene, args.res, args.spp, args.depth = (
            args.pbrt, meta.xres, meta.sampler.spp, cfg.max_depth)
    else:
        args.res, args.spp = args.res or 256, args.spp or 16
        if args.scene == "inst":
            scene, meta = build_instanced(args.res, dev)
        elif args.scene != "cornell":
            preset = mesh_scene if args.scene == "mesh" else mesh_scene_1m
            grid = {} if args.grid is None else {"grid": args.grid}
            scene, meta, _ = preset(args.res, args.res, args.spp, device=dev, **grid)
        else:
            scene, meta, _ = cornell_box(args.res, args.res, args.spp, device=dev)
    rnd.render(scene, meta, cfg, spp=args.spp, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rnd.render(scene, meta, cfg, spp=args.spp, device=dev)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    saved = _instrument()
    instanced.LAST_SWEEPS.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rnd.render(scene, meta, cfg, spp=args.spp, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)

    events = prof.key_averages()
    # the stage ranges appear twice: as host ranges (CPU) and as the device
    # timeline span they cover (CUDA user annotations, idle gaps included)
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.key.startswith("stage:")]
    kernel_us = sum(e.self_device_time_total for e in kernels)
    print(json.dumps({
        "render": {"scene": args.scene, "kind": cfg.kind,
                   "light_strategy": cfg.light_strategy, "mat_sort": cfg.mat_sort,
                   "n_tris": meta.n_tris,
                   "res": args.res, "spp": args.spp, "max_depth": args.depth,
                   "wall_ms": wall_plain * 1e3, "wall_ms_profiled": wall * 1e3,
                   "kernel_ms": kernel_us / 1e3,
                   "device_busy_share": kernel_us / 1e3 / (wall_plain * 1e3),
                   "kernel_launches": sum(e.count for e in kernels),
                   "gpu": torch.cuda.get_device_name(0)}}))
    stages = {}
    for e in events:
        if e.key.startswith("stage:"):
            st = stages.setdefault(e.key[len("stage:"):], {"calls": e.count})
            if e.device_type == DeviceType.CUDA:
                st["device_span_ms"] = e.self_device_time_total / 1e3
            else:
                st["kernel_ms"] = e.device_time_total / 1e3
                st["host_ms_profiled"] = e.cpu_time_total / 1e3
    print(json.dumps({"stages": stages}))
    if args.scene == "inst":
        # (kind, rays, rounds) of each instanced sweep of the profiled
        # render: one BLAS launch and one host sync a round
        print(json.dumps({"sweeps": [list(s) for s in instanced.LAST_SWEEPS]}))
    for kind, rows in (("kernel", kernels),
                       ("operator", [e for e in events
                                     if e.device_type == DeviceType.CPU
                                     and e.key.startswith("aten::")])):
        rows = sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)
        for e in rows[:args.top]:
            print(json.dumps({kind: e.key[:120], "count": e.count,
                              "self_device_ms": e.self_device_time_total / 1e3}))


if __name__ == "__main__":
    main()
