"""Lanes handed to the intersect dispatch (the widths of the program's
`wave/<role>` spans, every role) per camera ray of the window: compaction
lowers it, a split that overflows leaves the wave at full width."""
from portbench.spans import window_spans


def read(ctx):
    spans = window_spans()
    if spans is None:
        return None
    lanes = [s.lanes for s in spans if s.name.startswith("wave/")]
    if not lanes:
        return None
    return sum(lanes) / ctx.window.rays
