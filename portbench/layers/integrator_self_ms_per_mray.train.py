"""Host self time of the integrator's own work in the training forward (the
step's megawave, its bounces and compaction; the spans of every stage inside
them taken off) per million camera rays."""
from portbench.spans import integrator_self_ms_per_mray


def read(ctx):
    return integrator_self_ms_per_mray(ctx)
