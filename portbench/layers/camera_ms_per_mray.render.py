"""Host time of the program's `camera` spans (ray generation, with the
`camera/lens` and `camera/motion` spans and the `sync/*` reads inside them)
per million camera rays."""
from portbench.spans import window_spans


def read(ctx):
    spans = window_spans()
    if spans is None or not any(s.name == "camera" for s in spans):
        return None
    return 1e3 * sum(s.end - s.start for s in spans if s.name == "camera") * 1e-9 / ctx.mrays
