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

The running program's own tracer and registry (:mod:`repro_torch.obs.program`,
on the host's real clock) validate against two further sets, which the JAX
package does not have: :data:`PROGRAM_SPAN_NAMES` and
:data:`PROGRAM_METRIC_KEYS`.
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


#: Span names of the running program, by layer (``tr.span("...")`` sites).
PROGRAM_SPAN_NAMES = frozenset({
    # data path: the consumer's wait, the producer thread's batch, the copy in
    "data.wait", "data.assemble", "data.to_device",
    # tier split and train step (a tier step's root is train.step or
    # train.extract)
    "train.step", "train.extract", "train.tune", "train.adamw",
    # inside the extraction, per COS-batch microbatch
    "extract.prefix", "extract.quantize",
    # the storage tier's vision executor: one request, its two copies
    "executor.request", "executor.copy_in", "executor.copy_out",
    # inside a block: latent attention (projections and the flash call), and
    # the dropless MoE's routing, grouped expert products and combine
    "attn.mla", "moe.route", "moe.experts", "moe.combine",
})

#: Counter keys of the running program (``mx.inc("...")`` sites).
PROGRAM_METRIC_KEYS = frozenset({
    "steps_total", "chunks_total", "microbatches_total",
    # the boundary payload where the extraction returns it
    "wire_bytes_total",
    # copies between host and card, labelled memory=pinned|pageable
    "h2d_bytes_total", "d2h_bytes_total",
    # the LM head's products, labelled route=split_bf16|f32 (kernels/head.py)
    "head_products_total",
    # (token, expert) rows the dropless MoE routes
    "moe_routed_rows_total",
})


def validate_span_name(name: str, names: frozenset = SPAN_NAMES) -> str:
    """Refuse to emit a span name the schema does not know."""
    if name not in names:
        which = "SPAN_NAMES" if names is SPAN_NAMES else "PROGRAM_SPAN_NAMES"
        raise ValueError(
            f"span name {name!r} is not in repro_torch.obs.schema.{which}; "
            f"register it there so traces stay queryable")
    return name


def validate_tier(tier: str) -> str:
    if tier not in TIERS:
        raise ValueError(
            f"span tier {tier!r} is not in repro_torch.obs.schema.TIERS")
    return tier


def validate_metric_key(key: str, keys: frozenset = METRIC_KEYS) -> str:
    """Refuse to touch a metric key the schema does not know."""
    if key not in keys:
        which = "METRIC_KEYS" if keys is METRIC_KEYS else "PROGRAM_METRIC_KEYS"
        raise ValueError(
            f"metric key {key!r} is not in repro_torch.obs.schema.{which}; "
            f"register it there so dashboards stay stable")
    return key
