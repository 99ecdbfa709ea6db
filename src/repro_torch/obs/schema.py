"""Registered enumerations of the observability layer.

One module is the single source of truth for what the tracer and the
metrics registry may emit. A copy of ``repro/obs/schema.py`` with the same
sets, including the names that only the fleet and the replayer emit (the
port has neither yet), so a trace of either package reads the same:

* :data:`SPAN_NAMES` — every structured-span name the runtime emits
  (``tr.emit(...)`` / ``tr.begin(...)`` sites). The JAX package's
  schema-stability tests grep its source both ways: a span name emitted
  anywhere must be registered, and a registered name must still be
  emitted somewhere.
* :data:`METRIC_KEYS` — every metric key the runtime touches
  (``mx.inc`` / ``mx.observe`` / ``mx.gauge_set`` sites), same
  both-direction guarantee.
* :data:`TIERS` — the process-level grouping of the Perfetto export:
  one ``pid`` per tier, one ``tid`` per resource track within it.

The tracer and the registry validate against these sets at emission
time, so an unregistered name fails the emitting run loudly instead of
silently producing an unqueryable trace.
"""
from __future__ import annotations

#: Causal-tree span names (request lifecycle across the tiers).
SPAN_NAMES = frozenset({
    # request lifecycle (fleet intake -> served -> pulled)
    "request",
    # compute-tier admission + execution (scheduler/server)
    "admission", "model.load", "cos.compute", "quantize",
    # storage tier
    "storage.read",
    # wire + client training loop
    "wire.transfer", "client.compute", "iteration",
    # decision-path replay (one lightweight span per replayed request)
    "replay.request",
})

#: Perfetto process groups: every span carries exactly one tier.
TIERS = frozenset({"control", "storage", "compute", "network", "client"})

#: Metric keys (counters, gauges and histograms with label sets).
METRIC_KEYS = frozenset({
    # simulator core
    "events_total",
    # request lifecycle
    "requests_total", "responses_total", "queue_delay_seconds",
    "stage_seconds", "slo_miss_total",
    # compute-tier scheduler / coalescer
    "reload_bytes_total", "reload_saved_bytes_total", "warm_hit_total",
    "coalesce_total",
    # warm-weight cache
    "evict_total", "cache_resident_bytes",
    # elasticity
    "scale_events_total",
    # network fabric
    "trunk_bytes_total", "trunk_utilization",
    # scaling signals
    "accel_utilization",
})


def validate_span_name(name: str) -> str:
    """Refuse to emit a span name the schema does not know."""
    if name not in SPAN_NAMES:
        raise ValueError(
            f"span name {name!r} is not in repro_torch.obs.schema.SPAN_NAMES; "
            f"register it there so traces stay queryable")
    return name


def validate_tier(tier: str) -> str:
    if tier not in TIERS:
        raise ValueError(
            f"span tier {tier!r} is not in repro_torch.obs.schema.TIERS")
    return tier


def validate_metric_key(key: str) -> str:
    """Refuse to touch a metric key the schema does not know."""
    if key not in METRIC_KEYS:
        raise ValueError(
            f"metric key {key!r} is not in repro_torch.obs.schema.METRIC_KEYS; "
            f"register it there so dashboards stay stable")
    return key
