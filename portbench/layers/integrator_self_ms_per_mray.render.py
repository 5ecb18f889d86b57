"""Host self time of the integrator's own work (megawave set-up and NaN
quarantine, each bounce's MIS weights, Russian roulette, throughput updates,
and compaction; the spans of every stage inside them taken off) per million
camera rays."""
from portbench.spans import integrator_self_ms_per_mray


def read(ctx):
    return integrator_self_ms_per_mray(ctx)
