"""Run one cell of BENCHMARK.json once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from process start: imports, the CUDA context, the kernels' build
or load, the scene made from the seed and built on the card, one warm-up
request of the cell's own shapes), then a closed loop of requests, one
client, for --seconds: the window ends when the request running at that
time completes, and every rate counts all of the window's work over all of
its time. --trace 0 prints the cell's end-to-end metrics; --trace 1 runs
the window (its first TRACE_SECONDS at most) under torch.profiler with the
stage ranges on and prints the per-layer metrics. Then the program's state is freed and the plain
reference checks what the window produced. The last line of standard
output is one JSON object; the numbers compared, each beside its limit, are
the last lines of standard error.

Without a CUDA card (or with fewer than the cell asks for) it exits with 2
and prints no result; so it does if JAX or the JAX package is loaded.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --control 1

runs the control instead: the reference in bfloat16 in the program's place,
judged by the same comparison (a chip run for setting limits, not part of a
benchmark run).
"""
from __future__ import annotations

import os
import sys
import time


def _process_start():
    """Seconds on the perf_counter clock at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "portbench", "_out")
# the kernel caches of anything that JIT-compiles, at fixed paths in the checkout
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(OUT, "cuda_cache"))

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402

from portbench import guard, manifest, stats  # noqa: E402


TRACE_SECONDS = 5.0     # the traced window: the profiler's trace stays small


@dataclasses.dataclass
class Window:
    requests: int
    rays: int
    seconds: float
    latencies: list

    @property
    def p90(self):
        return stats.percentile(self.latencies, 90)


class Run:
    """One run of a cell: its configuration, traffic, seed and device."""

    def __init__(self, cell, seed, device):
        import torch
        self.torch = torch
        self.config = cell["config"]
        self.traffic = manifest.load_traffic(cell["traffic"])
        self.seed = seed
        self.device = torch.device(device)

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)


def window(generator, run, seconds, first=1):
    """Closed-loop requests from index `first` until `seconds` have passed
    and the request in flight has completed."""
    lat, k = [], first
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        generator.request(k)
        te = time.perf_counter()
        lat.append(te - ts)
        k += 1
        if te - t0 >= seconds:
            break
    n = k - first
    return Window(n, n * generator.rays_per_request, te - t0, lat)


def traced_window(generator, run, seconds):
    """The window under the profiler with the stage ranges on; returns
    (Window, tracing.Trace)."""
    from torch.profiler import record_function
    from portbench import tracing
    path = os.path.join(OUT, "trace.json")
    with tracing.instrumented():
        with tracing.profiled(path):
            with record_function("pb:window"):
                w = window(generator, run, seconds)
    tr = tracing.Trace.load(path)
    os.remove(path)
    return w, tr


def execute(cell_name, seed, seconds, trace, device, control=False, traffic=None):
    """Run one cell; returns the result dict and the numbers compared
    [(name, value, limit)]. traffic: overrides of the traffic's parameters
    (the tests' small sizes)."""
    import torch
    man = manifest.load()
    cell = manifest.cell(man, cell_name)
    run = Run(cell, seed, device)
    if traffic:
        run.traffic = dict(run.traffic, **traffic)
    generator = manifest.load_generator(run.traffic["generator"]).Generator(run)
    if run.device.type == "cuda":
        torch.cuda.set_device(run.device)
        torch.empty(1, device=run.device)       # the context and its allocator
        torch.cuda.reset_peak_memory_stats(run.device)
    layer_inputs = generator.setup()
    run.sync()
    setup_s = time.perf_counter() - T_START
    if control:
        window(generator, run, seconds)
        got = generator.control()
        return None, [(k, v, run.traffic["limits"][k]) for k, v in got.items()]
    if trace:
        generator.time_backward = True
        w, tr = traced_window(generator, run, min(seconds, TRACE_SECONDS))
    else:
        w, tr = window(generator, run, seconds), None
    peak = (torch.cuda.max_memory_allocated(run.device) if run.device.type == "cuda"
            else 0)
    dev = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
           "kind": (torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                    else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        from portbench import layers
        metrics = layers.read_all(man, cell, layers.Context(
            run=run, generator=generator, window=w, trace=tr, inputs=layer_inputs))
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
    else:
        e2e = dict(generator.end_to_end(w), setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in manifest.metrics_of(man, cell, "end_to_end")}
    loaded = guard.forbidden_modules()
    if loaded:
        raise guard.ForbiddenImport(loaded)
    got = generator.check()
    limits = run.traffic["limits"]
    numbers = [(k, v, limits[k]) for k, v in got.items()]
    result = {"correct": all(v <= lim for _, v, lim in numbers), "attempted": w.requests,
              "failed": 0, "metrics": metrics, "device": dev,
              "_latencies_ms": [1e3 * x for x in w.latencies]}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in numbers}
    return result, numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)        # the host's only work is issuing launches
    cell = manifest.cell(manifest.load(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result, numbers = execute(args.workload, args.seed, args.seconds, args.trace,
                                  "cuda:0", control=bool(args.control))
    except guard.ForbiddenImport as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 3
    if result is not None:
        lat = sorted(result.pop("_latencies_ms"))
        print(f"portbench: {len(lat)} requests, latency ms p10 {stats.percentile(lat, 10):.1f} "
              f"p50 {stats.percentile(lat, 50):.1f} p90 {stats.percentile(lat, 90):.1f} "
              f"max {lat[-1]:.1f}; load average {os.getloadavg()}", file=sys.stderr)
    for name, value, limit in numbers:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    if result is not None:
        print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
