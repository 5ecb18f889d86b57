"""Per-layer metrics of a traced run. Each metric has a reader of its own,
layers/<metric name>.py, whose `read(ctx)` returns the number, or None where
the run has nothing for it to read (the harness then leaves the metric out
of the line). The helpers below are shared by the readers."""
from __future__ import annotations

import contextlib
import functools
import importlib.util

import torch

from .. import manifest, roofline, tracing


class Context:
    """What a traced run hands the readers: the run, its generator, the traced
    window (requests, camera rays, seconds), its trace, and the numbers the
    set-up measured."""

    def __init__(self, run, generator, window, trace, inputs):
        self.run, self.generator, self.window, self.trace = run, generator, window, trace
        self.inputs = inputs or {}

    @property
    def mrays(self):
        return self.window.rays / 1e6

    @functools.cached_property
    def intersect_bound_s(self):
        """The summed bound of the window's intersect launches: one request's
        launches captured and counted, times the window's requests (every
        request renders the same film at the same samples a pixel)."""
        launches, tables = capture_request(self.generator, self.run)
        if not launches:
            return None
        per_request = sum(roofline.launch_bound_s(la, tables) for la in launches)
        return per_request * self.window.requests


def launches_per_mray(ctx):
    return len(ctx.trace.kernels) / ctx.mrays


def idle_pct(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)


def read_all(man, cell, ctx):
    out = {}
    for m in manifest.metrics_of(man, cell, "per_layer"):
        spec = importlib.util.spec_from_file_location("portbench_layer_" + m["name"],
                                                      manifest.layer_path(m["name"]))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


SAMPLE_RAYS = 4096      # rays counted a launch


@contextlib.contextmanager
def _capturing(launches, tables, gen):
    from grail_torch.kernels import intersect as isect
    brute, walk = isect.brute_intersect, isect.bvh4_traverse

    def sample(o, d, tmin, tmax):
        n = o.shape[0]
        idx = torch.randperm(n, generator=gen)[:SAMPLE_RAYS].to(o.device)
        return tuple(a[idx].detach().clone() for a in (o, d, tmin, tmax))

    def brute_wrap(tris9, o, d, tmin, tmax, any_hit=False):
        tables.setdefault("tris9", tris9)
        if o.shape[0]:
            launches.append({"kind": "brute", "any_hit": any_hit, "n": o.shape[0],
                             "rays": sample(o, d, tmin, tmax)})
        return brute(tris9, o, d, tmin, tmax, any_hit)

    def walk_wrap(nodes, tris, o, d, tmin, tmax, any_hit=False, **kw):
        tables.setdefault("nodes", nodes)
        tables.setdefault("tris", tris)
        if o.shape[0]:
            launches.append({"kind": "bvh4", "any_hit": any_hit, "n": o.shape[0],
                             "rays": sample(o, d, tmin, tmax)})
        return walk(nodes, tris, o, d, tmin, tmax, any_hit, **kw)

    isect.brute_intersect, isect.bvh4_traverse = brute_wrap, walk_wrap
    try:
        yield
    finally:
        isect.brute_intersect, isect.bvh4_traverse = brute, walk


def capture_request(generator, run):
    """The intersect launches of the window's first request, run again with
    each launch's rays sampled (a generator seeded from the run's seed)."""
    launches, tables = [], {}
    gen = torch.Generator().manual_seed(run.seed % (2 ** 63))
    with _capturing(launches, tables, gen):
        generator.request(1)
    return launches, tables


def intersect_roofline_pct(ctx):
    bound = ctx.intersect_bound_s
    spent = ctx.trace.kernel_s(tracing.INTERSECT_KERNELS)
    if bound is None or spent <= 0.0:
        return None
    return 100.0 * bound / spent
