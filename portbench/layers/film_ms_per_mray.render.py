"""Host self time of the film (the program's `film` spans: accumulating each
megawave's samples and developing the image) per million camera rays."""
from portbench.spans import self_s, window_spans


def read(ctx):
    spans = window_spans()
    if spans is None or not any(s.name == "film" for s in spans):
        return None
    return 1e3 * self_s(spans, lambda name: name == "film") / ctx.mrays
