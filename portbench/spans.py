"""The program's own span log, `grail_torch.telemetry.SPANS`, as the
per-layer readers take it. The program records spans only while a profiler
records, and the benchmark's profiler records only over the traced window,
so the log holds the window's spans and nothing else. A program without the
log (or one that recorded nothing) gives None, and the readers then leave
their metric out."""
from __future__ import annotations

import collections


def window_spans():
    """The traced window's spans (each with name, id, parent, root, thread,
    start and end in ns, lanes), or None where the program keeps no log or
    the log ran full (its first spans would be missing)."""
    try:
        from grail_torch import telemetry
    except ImportError:
        return None
    spans = list(telemetry.SPANS)
    if not spans or len(spans) == telemetry.SPANS.maxlen:
        return None
    return spans


def self_s(spans, keep):
    """Summed self time, in seconds, of the spans whose name `keep` accepts:
    each span's duration less the durations of its direct children."""
    children = collections.Counter()
    for s in spans:
        if s.parent is not None:
            children[s.parent] += s.end - s.start
    return sum(s.end - s.start - children[s.id] for s in spans if keep(s.name)) * 1e-9


def integrator(name):
    """The integrator's own spans: a megawave, its bounces, compaction."""
    return name in ("megawave", "compaction") or name.startswith("bounce/")


def integrator_self_ms_per_mray(ctx):
    spans = window_spans()
    if spans is None or not any(s.name == "megawave" for s in spans):
        return None
    return 1e3 * self_s(spans, integrator) / ctx.mrays
