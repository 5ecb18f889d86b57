"""The lanes the instanced walk does work for over the lanes it is handed:
the summed lanes of the program's `sweep/closest` and `sweep/any` spans
(the rays with a candidate instance in a round) over the summed lanes of
each `instanced` span (the rays handed in, every one of which each round's
launch takes) times that call's rounds. Rays without a candidate ride in the
launch at tmax = -BIG_T; nothing where the program has no round spans."""
import collections

from portbench.spans import window_spans


def read(ctx):
    spans = window_spans()
    if spans is None:
        return None
    rounds, used = collections.Counter(), 0
    for s in spans:
        if s.name in ("sweep/closest", "sweep/any"):
            rounds[s.parent] += 1
            used += s.lanes
    handed = sum(s.lanes * rounds[s.id] for s in spans
                 if s.name == "instanced" and s.lanes is not None)
    if not rounds or handed <= 0:
        return None
    return used / handed
