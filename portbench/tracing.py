"""The traced run: named ranges around the system's stages, applied from
outside the program (a frozen copy of the stage wrappers of the system's
profile tool, `_STAGES` and `_instrument`), torch.profiler over the traced
window, and the reduction of its Chrome trace to what the per-layer readers
need: device intervals by kernel name, host ranges by stage, and which
stage's range launched each kernel.

Every range is named "pb:<stage>". Kernels launched through ctypes (the
intersect kernels) carry no operator of their own, but CUPTI records them
like any other kernel, with the runtime call that launched them.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import os

PREFIX = "pb:"

# stage -> (module path, function names); the modules are the system's
STAGES = {
    "camera": ("grail_torch.engine.render", ("camera_rays",)),
    "intersect": ("grail_torch.engine.integrator", ("_trace",)),
    "binning": ("grail_torch.kernels.intersect",
                ("bin_rays_key", "bucket_rank", "sort_by_rank", "unsort")),
    "shade": ("grail_torch.engine.integrator", ("_shade_context",)),
    "light": ("grail_torch.engine.integrator", ("_direct_light",)),
    "bsdf_sample": ("grail_torch.shade.bsdf", ("bsdf_sample",)),
    "environment": ("grail_torch.shade.lights", ("env_pdf", "escaped_radiance")),
    "compaction": ("grail_torch.engine.integrator", ("_compaction_take",)),
    "film": ("grail_torch.engine.film", ("add_samples_grid", "develop")),
}
# the stages whose host time is shading and lighting
SHADE_STAGES = ("shade", "light", "bsdf_sample", "environment")
INTERSECT_KERNELS = ("brute_intersect_kernel", "bvh4_kernel")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _ranged(name, fn):
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(PREFIX + name):
            return fn(*args, **kwargs)
    return wrapper


@contextlib.contextmanager
def instrumented(stages=STAGES):
    """Each stage's functions wrapped in a named range, restored on exit."""
    import importlib
    saved = []
    try:
        for stage, (modname, names) in stages.items():
            mod = importlib.import_module(modname)
            for name in names:
                fn = getattr(mod, name)
                saved.append((mod, name, fn))
                setattr(mod, name, _ranged(stage, fn))
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


@contextlib.contextmanager
def profiled(path):
    """torch.profiler (host and CUDA activity) over the block; the Chrome
    trace is written to `path` on exit."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """A Chrome trace reduced. Times in microseconds on the profiler's clock;
    the window is [t0, t1], the host time of the range named `window`."""

    def __init__(self, events, window="pb:window"):
        ev = [e for e in events if e.get("ph") == "X"]
        host = [e for e in ev if e.get("cat") == "user_annotation"]
        wins = [e for e in host if e["name"] == window]
        if not wins:
            raise ValueError(f"the trace has no {window!r} range")
        self.t0 = wins[0]["ts"]
        self.t1 = wins[0]["ts"] + wins[0]["dur"]
        inside = [e for e in ev if self.t0 <= e["ts"] <= self.t1]
        self.device = [(e["name"], e["ts"], e["dur"], e.get("args", {}).get("correlation"),
                        e.get("cat")) for e in inside if e.get("cat") in _DEVICE_CATS]
        self.kernels = [d for d in self.device if d[4] == "kernel"]
        self.spans = [(e["name"][len(PREFIX):], e["ts"], e["dur"], e.get("tid"))
                      for e in host if e["name"].startswith(PREFIX)
                      and e["name"] != window and self.t0 <= e["ts"] <= self.t1]
        self.launch_ts = {e.get("args", {}).get("correlation"): (e["ts"], e.get("tid"))
                          for e in inside if e.get("cat") == "cuda_runtime"}

    @classmethod
    def load(cls, path):
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self):
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        return _union((ts, ts + dur) for _, ts, dur, _, _ in self.device)

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def kernel_s(self, substrings):
        return sum(dur for name, _, dur, _, _ in self.kernels
                   if any(s in name for s in substrings)) * 1e-6

    def outer_spans(self, stages):
        """The spans of `stages` not inside another span of `stages`, with the
        time of every other span inside them taken off (host self time)."""
        chosen = sorted((s for s in self.spans if s[0] in stages), key=lambda s: s[1])
        outer, end = [], -1.0
        for s in chosen:
            if s[1] >= end:
                outer.append(s)
                end = s[1] + s[2]
        others = sorted((s for s in self.spans if s[0] not in stages), key=lambda s: s[1])
        starts = [s[1] for s in others]
        total = 0.0
        for name, ts, dur, tid in outer:
            covered = _union((max(o[1], ts), min(o[1] + o[2], ts + dur))
                             for o in others[bisect.bisect_left(starts, ts):
                                             bisect.bisect_right(starts, ts + dur)]
                             if o[3] == tid)
            total += dur - sum(e - s for s, e in covered if e > s)
        return total * 1e-6

    def stage_device_s(self, stage):
        """Device time of the kernels whose launching call lies inside a span
        of `stage` on the same thread (a stage's spans do not nest)."""
        ranges = sorted((ts, ts + dur, tid) for name, ts, dur, tid in self.spans
                        if name == stage)
        starts = [r[0] for r in ranges]
        total = 0.0
        for _, _, dur, corr, _ in self.kernels:
            launch = self.launch_ts.get(corr)
            i = -1 if launch is None else bisect.bisect_right(starts, launch[0]) - 1
            if i >= 0 and launch[0] <= ranges[i][1] and ranges[i][2] == launch[1]:
                total += dur
        return total * 1e-6

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle gaps summed
        by the innermost stage the host was in when each gap began."""
        by_op = collections.Counter()
        for name, _, dur, _, _ in self.device:
            by_op[name[:120]] += dur * 1e-6
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        # one sweep in time order: the host's ranges nest, so a stack holds
        # the ranges open at each gap's start, the innermost on top
        items = sorted([(ts, 0, ts + dur, name) for name, ts, dur, _ in self.spans]
                       + [(s, 1, e, None) for s, e in idle])
        gaps = collections.Counter()
        stack = []
        for t, kind, end, name in items:
            while stack and stack[-1][0] < t:
                stack.pop()
            if kind == 0:
                stack.append((end, name))
            else:
                gaps[stack[-1][1] if stack else "outside stages"] += (end - t) * 1e-6
        return {"device_ops": [[k, v] for k, v in by_op.most_common(top)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}
