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
material-sorted shading, whose pass is the span `megabatch`), once to warm
up, once timed, then once under torch.profiler, and prints JSON lines:

- the render: its wall time (unprofiled and profiled), the summed kernel
  time, the device's busy time (the union of kernel, copy and fill
  intervals) and busy share (busy time over the unprofiled wall time), and
  the number of kernel launches;
- for each of the program's spans (grail_torch/telemetry.py; every stage
  of the path is one, e.g. `shading_geometry`, `textures`,
  `textures_lobes`, the integrator's `megawave`, `bounce/<b>` and
  `compaction`, each intersect kernel's host launch `launch/<kernel>`): its
  calls, its host time and host self time (less the spans inside it), the
  device time of the kernels launched while it was the innermost span, and
  the device idle time that began while it was;
- the host's waits for the device (`sync/<site>`: reads of device values,
  copies from pageable host memory): count and wait;
- the lanes handed to the intersect dispatch, by role and per camera ray;
- the sampler (core/rng.py): its kernel's launches by function, the calls
  on the card that took the plain version, and the `rng` spans' calls and
  lanes (one launch a call where every call takes the kernel);
- the BSDF stack (shade/bsdf.py): its kernel's launches by route, and the
  `bsdf_eval` and `bsdf_sample` spans' calls (one launch a call: every CUDA
  call takes the kernel);
- the kernels and the operators that take the most device time.

Every device number comes from the profiler's Chrome trace, whose kernel
events include the intersect kernels launched through ctypes (they have no
operator, so `key_averages()` lists them under no operator row). Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .. import telemetry
from ..engine import integrator, render as rnd
from ..kernels import bsdf as kbsdf
from ..kernels import instanced
from ..kernels import sampler as ksampler
from ..scene.parser import parse_string
from ..scene.presets import cornell_box, mesh_scene, mesh_scene_1m
from .instbench import build_instanced

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def trace_events(prof):
    """The complete ("X") events of the profiler's Chrome trace."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X"]


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(ranges, times):
    """For each time, the name of the innermost of `ranges` ((start, end,
    name), nested, one thread) open at it, or None."""
    items = sorted([(s, 0, e, name) for s, e, name in ranges]
                   + [(t, 1, i, None) for i, t in enumerate(times)])
    out, stack = [None] * len(times), []
    for t, kind, x, name in items:
        while stack and stack[-1][0] < t:
            stack.pop()
        if kind == 0:
            stack.append((x, name))
        else:
            out[x] = stack[-1][1] if stack else None
    return out


class Timeline:
    """A Chrome trace reduced (microseconds on the profiler's clock): device
    intervals, the program's `grail:` ranges by thread, and for each kernel
    the innermost range open when its launching call was made."""

    def __init__(self, events):
        self.device = [e for e in events if e.get("cat") in _DEVICE_CATS]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.ranges = collections.defaultdict(list)
        for e in events:
            if (e.get("cat") == "user_annotation"
                    and e["name"].startswith(telemetry.PREFIX)):
                self.ranges[e.get("tid")].append(
                    (e["ts"], e["ts"] + e["dur"], e["name"][len(telemetry.PREFIX):]))
        launch = {e.get("args", {}).get("correlation"): (e["ts"], e.get("tid"))
                  for e in events if e.get("cat") in _LAUNCH_CATS}
        by_tid = collections.defaultdict(list)
        for i, k in enumerate(self.kernels):
            ts, tid = launch.get(k.get("args", {}).get("correlation"), (None, None))
            if ts is not None:
                by_tid[tid].append((i, ts))
        self.launched_in = [None] * len(self.kernels)
        for tid, items in by_tid.items():
            names = _innermost(self.ranges.get(tid, ()), [ts for _, ts in items])
            for (i, _), name in zip(items, names):
                self.launched_in[i] = name

    def busy_intervals(self):
        return _union((e["ts"], e["ts"] + e["dur"]) for e in self.device)

    def idle_by_span(self):
        """Device idle time (us) inside the program's outermost ranges, summed
        by the innermost range the busiest thread was in when each gap
        began."""
        tid = max(self.ranges, key=lambda t: len(self.ranges[t]), default=None)
        if tid is None:
            return {}
        ranges = self.ranges[tid]
        t0, t1 = min(r[0] for r in ranges), max(r[1] for r in ranges)
        edges = [t0] + [x for iv in self.busy_intervals()
                        if iv[1] > t0 and iv[0] < t1 for x in iv] + [t1]
        gaps = [(max(s, t0), min(e, t1)) for s, e in zip(edges[0::2], edges[1::2])
                if min(e, t1) > max(s, t0)]
        out = collections.Counter()
        for (s, e), name in zip(gaps, _innermost(ranges, [s for s, _ in gaps])):
            out[name] += e - s
        return out


def span_table(spans, timeline):
    """Per span name: calls, host and host self ms (from the span log),
    kernel ms launched while it was innermost, idle ms begun while it was."""
    child = collections.Counter()
    for s in spans:
        if s.parent is not None:
            child[s.parent] += s.end - s.start
    kernel_us = collections.Counter()
    for k, name in zip(timeline.kernels, timeline.launched_in):
        kernel_us[name] += k["dur"]
    idle_us = timeline.idle_by_span()
    table = {}
    for s in spans:
        row = table.setdefault(s.name, {"calls": 0, "host_ms": 0.0, "host_self_ms": 0.0})
        row["calls"] += 1
        row["host_ms"] += (s.end - s.start) * 1e-6
        row["host_self_ms"] += (s.end - s.start - child[s.id]) * 1e-6
    for name, row in table.items():
        row["kernel_ms"] = kernel_us.pop(name, 0.0) * 1e-3
        row["idle_ms"] = idle_us.pop(name, 0.0) * 1e-3
    # kernels launched, and gaps begun, outside every span
    table["(no span)"] = {"kernel_ms": kernel_us.pop(None, 0.0) * 1e-3,
                          "idle_ms": idle_us.pop(None, 0.0) * 1e-3}
    return table


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

    telemetry.reset()
    instanced.LAST_SWEEPS.clear()
    ksampler.LAUNCHES.update(dict.fromkeys(ksampler.LAUNCHES, 0))
    kbsdf.LAUNCHES.update(dict.fromkeys(kbsdf.LAUNCHES, 0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rnd.render(scene, meta, cfg, spp=args.spp, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = list(telemetry.SPANS)
    telemetry.reset()
    tl = Timeline(trace_events(prof))
    kernel_us = sum(k["dur"] for k in tl.kernels)
    busy_us = sum(e - s for s, e in tl.busy_intervals())
    print(json.dumps({
        "render": {"scene": args.scene, "kind": cfg.kind,
                   "light_strategy": cfg.light_strategy, "mat_sort": cfg.mat_sort,
                   "n_tris": meta.n_tris,
                   "res": args.res, "spp": args.spp, "max_depth": args.depth,
                   "wall_ms": wall_plain * 1e3, "wall_ms_profiled": wall * 1e3,
                   "kernel_ms": kernel_us / 1e3, "device_busy_ms": busy_us / 1e3,
                   "device_busy_share": busy_us / 1e3 / (wall_plain * 1e3),
                   "kernel_launches": len(tl.kernels),
                   "gpu": torch.cuda.get_device_name(0)}}))
    print(json.dumps({"spans": span_table(spans, tl)}))
    syncs = {}
    for s in spans:
        if s.name.startswith("sync/"):
            row = syncs.setdefault(s.name[len("sync/"):], {"count": 0, "ms": 0.0})
            row["count"] += 1
            row["ms"] += (s.end - s.start) * 1e-6
    lanes = collections.Counter()
    for s in spans:
        if s.name.startswith("wave/"):
            lanes[s.name[len("wave/"):]] += s.lanes
    print(json.dumps({"syncs": syncs, "lanes": lanes,
                      "lanes_per_camera_ray": sum(lanes.values())
                      / (meta.xres * meta.yres * args.spp)}))
    rng_spans = [s for s in spans if s.name == "rng"]
    print(json.dumps({"sampler": {"launches": dict(ksampler.LAUNCHES),
                                  "rng_calls": len(rng_spans),
                                  "rng_lanes": sum(s.lanes for s in rng_spans)}}))
    print(json.dumps({"bsdf": {"launches": dict(kbsdf.LAUNCHES),
                               "calls": sum(s.name in ("bsdf_eval", "bsdf_sample")
                                            for s in spans)}}))
    if args.scene == "inst":
        # (kind, rays, rounds) of each instanced sweep of the profiled
        # render: one BLAS launch and one host sync a round
        print(json.dumps({"sweeps": [list(s) for s in instanced.LAST_SWEEPS]}))
    by_kernel = collections.defaultdict(lambda: [0, 0.0])
    for k in tl.kernels:
        row = by_kernel[k["name"][:120]]
        row[0] += 1
        row[1] += k["dur"] * 1e-3
    for name, (count, ms) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:args.top]:
        print(json.dumps({"kernel": name, "count": count, "device_ms": ms}))
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::")]
    for e in sorted(ops, key=lambda e: e.self_device_time_total, reverse=True)[:args.top]:
        print(json.dumps({"operator": e.key[:120], "count": e.count,
                          "self_device_ms": e.self_device_time_total / 1e3}))


if __name__ == "__main__":
    main()
