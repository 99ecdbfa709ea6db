"""Trace record/replay subsystem: versioned traces, workload
generation, fast policy replay, and learned-placement training.

A copy of ``repro/replay`` (numpy and the standard library; the learned
placement's ridge fit in torch).

* :mod:`repro_torch.replay.schema` — the versioned JSONL trace format.
* :mod:`repro_torch.replay.trace` — Trace container, writer/reader, live-run
  recorder.
* :mod:`repro_torch.replay.workload` — seeded open-loop workload generator
  (diurnal + Zipf + bursts).
* :mod:`repro_torch.replay.replayer` — decision-path replay of a trace under
  any :mod:`repro_torch.api.policies` combination.
* :mod:`repro_torch.replay.learned` — offline training for
  :class:`~repro_torch.api.policies.LearnedPlacement` (imported lazily so the
  replay hot path never pulls in torch).
"""
from repro_torch.replay.schema import (EVENT_KINDS, EventRecord, RequestRecord,
                                 TRACE_VERSION, TraceHeader, validate_kind)
from repro_torch.replay.trace import Trace, live_route_decisions, record_trace
from repro_torch.replay.replayer import ReplayVerdict, TraceReplayer, replay
from repro_torch.replay.workload import WorkloadSpec, catalog_objects, generate

_LAZY = {"PlacementModel", "featurize", "train_placement_model"}


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.replay import learned
        return getattr(learned, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "TRACE_VERSION", "EVENT_KINDS", "validate_kind",
    "TraceHeader", "RequestRecord", "EventRecord",
    "Trace", "record_trace", "live_route_decisions",
    "TraceReplayer", "ReplayVerdict", "replay",
    "WorkloadSpec", "generate", "catalog_objects",
    "PlacementModel", "featurize", "train_placement_model",
]
