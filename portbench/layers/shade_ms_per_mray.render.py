"""Host self time inside the outermost shading and lighting ranges (the
shading context, direct lighting, BSDF sampling, the environment light),
the intersect and other ranges inside them taken off, per million camera
rays: the path is launch-bound, so the host time of launching sets the pace."""
from portbench.tracing import SHADE_STAGES


def read(ctx):
    return 1e3 * ctx.trace.outer_spans(SHADE_STAGES) / ctx.mrays
