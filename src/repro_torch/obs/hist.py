"""Shared percentile + fixed-bucket histogram math.

One exact implementation used by both the metrics registry
(:class:`repro_torch.obs.metrics.MetricsRegistry` histograms) and the replay
verdict's queue-delay percentiles (``ReplayVerdict`` of the JAX package's
``repro/replay``, which the port does not have yet), so the two can never
disagree on the same data — the historical replay percentile used
``int(q*n)`` indexing (a floor-biased, off-by-one rank) while dashboards
expect nearest-rank.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

#: Default latency buckets (seconds) for time histograms: sub-ms to the
#: makespan scale of a fleet burst. The last bucket is the +inf overflow.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, 600.0,
    math.inf,
)


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Exact nearest-rank percentile of an ascending-sorted sequence.

    ``rank = ceil(q * n)`` (1-indexed, clamped to [1, n]) — the standard
    nearest-rank definition: p50 of [1,2,3,4] is 2, p100 is the max,
    p0 is the min. Returns 0.0 on empty input (no data, no latency)."""
    n = len(sorted_vals)
    if n == 0:
        return 0.0
    rank = math.ceil(q * n)
    return sorted_vals[min(max(rank, 1), n) - 1]


def bucket_counts(values: Sequence[float],
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS
                  ) -> List[int]:
    """Cumulative-free per-bucket counts (value <= upper edge, first
    matching bucket wins)."""
    counts = [0] * len(buckets)
    for v in values:
        for i, edge in enumerate(buckets):
            if v <= edge:
                counts[i] += 1
                break
    return counts
