"""Order statistics over every sample, stalls included."""
from __future__ import annotations

import math


def percentile(values, q):
    """The q-th percentile by the nearest-rank rule: the smallest sample with
    at least q% of the samples at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)]

