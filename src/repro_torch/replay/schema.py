"""Versioned schema of the COS trace format (record/replay subsystem).

A copy of ``repro/replay/schema.py``: a trace written by either package
reads in the other.

One module is the single source of truth for what a trace *is*:

* :data:`EVENT_KINDS` — every ``kind`` string the runtime records into
  the simulator :class:`~repro_torch.cos.clock.EventLog`. The trace writer
  refuses unknown kinds, so a new event cannot silently break replay.
* :data:`TRACE_VERSION` + the record dataclasses — the JSONL wire
  format. A trace file is one JSON object per line: exactly one
  ``header`` line first, then ``request`` lines (the open-loop arrival
  stream a :class:`~repro_torch.replay.replayer.TraceReplayer` re-drives) and
  optional ``event`` lines (the recorded run's event log, used e.g. to
  check replayed decisions against the live ones).

Recorded and generated traces share this format, which is what makes a
recorded production day and a synthetic workload interchangeable inputs
to policy search.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, NamedTuple, Tuple

TRACE_VERSION = 1

#: Every event ``kind`` the runtime records (simulator-shared logs and
#: per-component EventLogs). Grouped by the subsystem that emits them.
EVENT_KINDS = frozenset({
    # resource timelines (clock.py)
    "busy",
    # request lifecycle (fleet/server)
    "post", "route", "served", "reject", "reissue", "rebalance", "deliver",
    # client training loop
    "iteration", "resplit",
    # elasticity + autoscaling
    "kill", "restart", "scale-up", "scale-down", "cordon", "scale-hold",
    "accel-util",
    # compute-tier scheduler (coalescing + warm-weight cache)
    "coalesce", "warm-hit", "cache-evict",
    # storage tier
    "store.read", "store.replicate", "store.unreplicate",
})

#: JSONL record discriminators (the ``type`` field of every line).
RECORD_TYPES = ("header", "request", "event")

#: ``header.mode`` values: how the replayer orders the request stream.
#: ``batch`` — all requests are pending before serving starts (a
#: recorded burst drain): dispatch order comes from the scheduler
#: policy, exactly like the live fleet's single dispatch round.
#: ``open-loop`` — requests are processed in arrival order (a generated
#: or recorded production day).
REPLAY_MODES = ("batch", "open-loop")


def validate_kind(kind: str) -> str:
    """Refuse to serialize an event kind the schema does not know."""
    if kind not in EVENT_KINDS:
        raise ValueError(
            f"event kind {kind!r} is not in repro_torch.replay.schema.EVENT_KINDS; "
            f"add it there (and bump TRACE_VERSION if the semantics of "
            f"existing kinds changed) so replay stays schema-complete")
    return kind


@dataclass(frozen=True)
class TraceHeader:
    """Deployment snapshot a replay reconstructs its fleet shim from."""

    version: int = TRACE_VERSION
    seed: int = 0
    mode: str = "batch"
    n_servers: int = 2
    n_accels: int = 2
    n_nodes: int = 3
    replication: int = 2
    internal_bandwidth: float = 5e9
    storage_latency: float = 2e-4
    #: tenant -> pinned compute weight (scheduler service class).
    tenant_weights: Dict[int, float] = field(default_factory=dict)
    #: object name -> storage-node indices holding a replica (the layout
    #: every replay starts from).
    placement: Dict[str, Tuple[int, ...]] = field(default_factory=dict)
    #: object name -> on-wire read size in bytes.
    object_bytes: Dict[str, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.mode not in REPLAY_MODES:
            raise ValueError(f"mode must be one of {REPLAY_MODES}, "
                             f"got {self.mode!r}")
        if self.version != TRACE_VERSION:
            raise ValueError(f"trace version {self.version} != supported "
                             f"TRACE_VERSION {TRACE_VERSION}")


class RequestRecord(NamedTuple):
    """One request of the arrival stream (a NamedTuple so replay can use
    records directly as its hot-loop row type)."""

    req_id: int
    tenant: int
    object_name: str
    model_key: str
    arrival: float
    service: float          # accelerator seconds (recorded or generated)
    act_bytes: float        # bytes served back (the demand signal)
    network_weight: float = 1.0
    compute_weight: float = 1.0


class EventRecord(NamedTuple):
    """One recorded event-log entry."""

    t: float
    kind: str
    detail: str


__all__ = [
    "TRACE_VERSION", "EVENT_KINDS", "RECORD_TYPES", "REPLAY_MODES",
    "validate_kind", "TraceHeader", "RequestRecord", "EventRecord",
]
