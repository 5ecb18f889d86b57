"""The host's wait on reads of device values inside the program (its
`sync/<site>` spans: the compaction's survivor count and every other read on
the render path) per million camera rays; 0 where a render reads none."""
from portbench.spans import window_spans


def read(ctx):
    spans = window_spans()
    if spans is None or not any(s.name == "render" for s in spans):
        return None
    wait_ns = sum(s.end - s.start for s in spans if s.name.startswith("sync/"))
    return 1e3 * wait_ns * 1e-9 / ctx.mrays
