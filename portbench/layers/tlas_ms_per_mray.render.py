"""Host time of the instanced sweep (the program's `instanced` spans: the
dense TLAS cull, each round's sync and candidate pick, the rays taken to
object space), the `launch/bvh4` spans of the walk inside them taken off,
per million camera rays; nothing on a scene without instances."""
from portbench.spans import window_spans


def read(ctx):
    spans = window_spans()
    if spans is None:
        return None
    by_id = {s.id: s for s in spans}
    sweeps = [s for s in spans if s.name == "instanced"]
    if not sweeps:
        return None

    def in_sweep(s):
        while s.parent is not None and s.parent in by_id:
            s = by_id[s.parent]
            if s.name == "instanced":
                return True
        return False

    walk_ns = sum(s.end - s.start for s in spans if s.name == "launch/bvh4" and in_sweep(s))
    sweep_ns = sum(s.end - s.start for s in sweeps)
    return 1e3 * (sweep_ns - walk_ns) * 1e-9 / ctx.mrays
