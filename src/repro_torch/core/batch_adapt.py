"""Batch adaptation (paper §5.5, Eq. 4).

A copy of ``repro/core/batch_adapt.py`` (pure Python): the port imports
nothing of ``repro``.

The COS server solves, per accelerator, the bounded knapsack

    max   sum_r  b_r * M_r(data) + M_r(model)
    s.t.  b_min <= b_r <= b_max_r   for all r
          sum_r b_r * M_r(data) + M_r(model)  <=  M_total - M_occupied

maximizing memory utilization over the queued requests while provably
avoiding OOM. The objective is monotone in every b_r, so the exact solver
is a water-fill: admit requests at b_min (dropping latest-first while even
b_min does not fit — the paper retries dropped requests next round), then
grow the smallest-fraction request in integer steps until the budget or
every b_max is hit.

Invariants (property-tested in tests/test_batch_adapt.py):
  * total estimated memory never exceeds the budget;
  * every admitted request has b_min <= b_r <= b_max_r;
  * maximality: if budget remains, every admitted request is at b_max.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple


# NamedTuples, not frozen dataclasses: every admission round constructs
# one AdaptRequest per queued request and one Assignment per admitted
# one, and frozen-dataclass __init__ (object.__setattr__ per field) is
# an order of magnitude slower than tuple construction at fleet scale.
class AdaptRequest(NamedTuple):
    req_id: int
    mem_per_sample: float       # M_r(data): bytes per batch element
    mem_model: float            # M_r(model): bytes for weights
    b_max: int                  # upper bound (client's training batch)
    b_min_override: int = 0     # >0: fixed floor (non-adaptable request —
                                # ALL_IN_COS cannot decouple its batch, §5.1)
    weight: float = 1.0         # service class: when HBM is scarce, higher
                                # weights keep proportionally larger batches
                                # and are the last dropped to the next round
                                # (weight 1.0 everywhere is bitwise the
                                # classic class-blind fill)

    def floor(self, b_min: int) -> int:
        if self.b_min_override:
            return min(self.b_min_override, self.b_max)
        return min(b_min, self.b_max)


class Assignment(NamedTuple):
    req_id: int
    batch: int
    mem: float


@dataclass(frozen=True)
class AdaptResult:
    assignments: List[Assignment]
    dropped: List[int]           # req_ids deferred to the next round
    mem_used: float
    budget: float

    @property
    def utilization(self) -> float:
        return self.mem_used / self.budget if self.budget else 0.0


def adapt_batches(
    requests: List[AdaptRequest],
    budget: float,
    b_min: int = 32,
    step: int = 8,
) -> AdaptResult:
    """Exact greedy water-fill solver for Eq. 4."""
    reqs = list(requests)
    dropped: List[int] = []

    def base_cost(rs) -> float:
        return sum(r.mem_model + r.floor(b_min) * r.mem_per_sample for r in rs)

    # Admission: drop requests until the b_min config fits (paper:
    # "removes one request at a time and retries"). Class-aware: the
    # lowest-weight, latest-arriving request goes first — with all-equal
    # weights this is exactly the historical latest-first drop.
    while reqs and base_cost(reqs) > budget:
        victim = min(range(len(reqs)), key=lambda i: (reqs[i].weight, -i))
        dropped.append(reqs[victim].req_id)
        reqs = reqs[:victim] + reqs[victim + 1:]

    batches = {r.req_id: r.floor(b_min) for r in reqs}
    used = base_cost(reqs)

    # Water-fill: repeatedly grow the request with the lowest
    # weight-scaled fill fraction, so at equilibrium a weight-w request
    # sits w times higher in its [b_min, b_max] range than a weight-1
    # one (division by weight 1.0 is exact: the classic fill, bitwise).
    #
    # Heap-driven: only the grown request's key changes per step, so a
    # heap keyed on (fraction, req_id) — a total order, req_id is unique
    # — pops candidates in exactly the order the historical
    # sorted-per-step scan visited them. Requests popped but not grown
    # (would not fit) keep their keys and are pushed back after each
    # step, reproducing the full rescan bitwise while the common case
    # (first candidate fits) costs O(log n) instead of O(n log n).
    # Full-coverage fast path: when the whole remaining headroom fits in
    # the budget, every request ends at b_max no matter the fill order —
    # assignments are integer-exact either way; only mem_used's float
    # rounding can differ by an ulp (its consumers are tolerance checks).
    # The common case on an uncontended accelerator, and at fleet scale
    # the heap's per-step tuple churn is a top-3 hotspot.
    growth = sum((r.b_max - batches[r.req_id]) * r.mem_per_sample
                 for r in reqs)
    if used + growth <= budget:
        for r in reqs:
            batches[r.req_id] = r.b_max
        used += growth
        assignments = [
            Assignment(r.req_id, batches[r.req_id],
                       r.mem_model + batches[r.req_id] * r.mem_per_sample)
            for r in reqs
        ]
        return AdaptResult(assignments, dropped, used, budget)

    # Parallel position-indexed arrays instead of per-pop dataclass +
    # dict traffic: the heap entry carries (key, req_id, index) — req_id
    # is unique, so the index never participates in the ordering and
    # pops happen in exactly the (key, req_id) order as before. max()
    # floors degenerate (<= 0) weights without touching valid ones —
    # division by a precomputed 1.0 stays exact, and the key expression
    # is operation-for-operation the historical one.
    grow = [r for r in reqs if batches[r.req_id] < r.b_max]
    rid_a = [r.req_id for r in grow]
    bmax_a = [r.b_max for r in grow]
    mps_a = [r.mem_per_sample for r in grow]
    w_a = [max(r.weight, 1e-12) for r in grow]
    bat_a = [batches[r.req_id] for r in grow]
    heap = [(bat_a[i] / bmax_a[i] / w_a[i], rid_a[i], i)
            for i in range(len(grow))]
    heapq.heapify(heap)
    pop, push = heapq.heappop, heapq.heappush
    while heap:
        _, rid, i = pop(heap)
        bm = bmax_a[i]
        b = bat_a[i]
        inc = bm - b
        if inc > step:
            inc = step
        cost = inc * mps_a[i]
        if used + cost > budget:
            # Can never fit on a later step either: `used` only grows
            # and this request's step cost is fixed while it stands
            # still — dropping it here visits candidates in exactly the
            # order the historical rescan did, minus the futile retries.
            continue
        b += inc
        bat_a[i] = b
        used += cost
        if b < bm:
            push(heap, (b / bm / w_a[i], rid, i))
    for i, rid in enumerate(rid_a):
        batches[rid] = bat_a[i]

    assignments = [
        Assignment(r.req_id, batches[r.req_id],
                   r.mem_model + batches[r.req_id] * r.mem_per_sample)
        for r in reqs
    ]
    return AdaptResult(assignments, dropped, used, budget)


def adaptation_stats(results: List[AdaptResult], default_batch: int) -> Tuple[float, float]:
    """Paper Table 5: % of requests with reduced batch, average reduction %."""
    n, reduced, total_red = 0, 0, 0.0
    for res in results:
        for a in res.assignments:
            n += 1
            if a.batch < default_batch:
                reduced += 1
                total_red += 100.0 * (default_batch - a.batch) / default_batch
    if n == 0:
        return 0.0, 0.0
    return 100.0 * reduced / n, (total_red / reduced if reduced else 0.0)


def per_server_adaptation_stats(
    results_by_server: Dict[int, List[AdaptResult]],
    default_batch: int,
) -> Dict[int, Tuple[float, float]]:
    """Fleet view of Table 5: adaptation rounds run per server replica
    (each against its own per-accelerator budgets), so the reduction
    profile is reported per server too."""
    return {
        sid: adaptation_stats(results, default_batch)
        for sid, results in sorted(results_by_server.items())
    }
