"""Chrome-trace / Perfetto JSON export of a span trace.

Maps the tier/track structure onto the Chrome trace-event format that
both ``chrome://tracing`` and https://ui.perfetto.dev load natively:

* one **process** (``pid``) per tier (control, storage, compute,
  network, client), named via ``process_name`` metadata;
* one **thread** (``tid``) per resource track within the tier (an
  accelerator, a storage node, a WAN link, a tenant), named via
  ``thread_name`` metadata;
* one complete event (``ph: "X"``) per span, with microsecond ``ts`` /
  ``dur`` and the span's labels + causal ids in ``args``.

Loading a fleet-burst trace shows the paper's Fig. 9 picture directly:
consecutive iterations' storage reads, pushdown compute, wire
transfers, and client suffix compute overlapping across the rows.
"""
from __future__ import annotations

import json
from typing import Dict, List, Tuple

from repro_torch.obs.span import Span, Tracer

#: Virtual simulator seconds -> trace microseconds.
_US = 1e6


def _layout(spans: List[Span]) -> Dict[Tuple[str, str], Tuple[int, int]]:
    """Deterministic (tier, track) -> (pid, tid): pids follow sorted
    tier order, tids sorted track order within each tier."""
    tiers: Dict[str, set] = {}
    for s in spans:
        tiers.setdefault(s.tier, set()).add(s.track)
    out: Dict[Tuple[str, str], Tuple[int, int]] = {}
    for pid, tier in enumerate(sorted(tiers), start=1):
        for tid, track in enumerate(sorted(tiers[tier]), start=1):
            out[(tier, track)] = (pid, tid)
    return out


def chrome_trace(tracer: Tracer) -> dict:
    """Render every span in ``tracer`` to a Chrome trace-event dict."""
    spans = tracer.spans
    layout = _layout(spans)
    events: List[dict] = []
    seen_pids: Dict[int, str] = {}
    for (tier, track), (pid, tid) in sorted(layout.items(),
                                            key=lambda kv: kv[1]):
        if pid not in seen_pids:
            seen_pids[pid] = tier
            events.append({"ph": "M", "name": "process_name", "pid": pid,
                           "tid": 0, "args": {"name": tier}})
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": track}})
    xs = []
    for s in spans:
        pid, tid = layout[(s.tier, s.track)]
        args: Dict[str, object] = {"span_id": s.span_id,
                                   "parent_id": s.parent_id}
        for k, v in s.labels:
            args[k] = v
        xs.append({"ph": "X", "name": s.name,
                   "ts": round(s.t0 * _US, 3),
                   "dur": round(max(s.t1 - s.t0, 0.0) * _US, 3),
                   "pid": pid, "tid": tid, "args": args})
    xs.sort(key=lambda e: (e["ts"], e["pid"], e["tid"], e["args"]["span_id"]))
    events.extend(xs)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(doc: dict) -> None:
    """Schema check used by tests and ``make obs-smoke``: raises
    ValueError on the first malformed event."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a chrome trace: missing traceEvents")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    named: Dict[int, str] = {}
    threads: set = set()
    last_ts = None
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph == "M":
            if e["name"] == "process_name":
                named[e["pid"]] = e["args"]["name"]
            elif e["name"] == "thread_name":
                threads.add((e["pid"], e["tid"]))
            continue
        if ph != "X":
            raise ValueError(f"event {i}: unexpected phase {ph!r}")
        for field in ("name", "ts", "dur", "pid", "tid"):
            if field not in e:
                raise ValueError(f"event {i}: missing {field!r}")
        if e["ts"] < 0 or e["dur"] < 0:
            raise ValueError(f"event {i}: negative ts/dur")
        if e["pid"] not in named:
            raise ValueError(f"event {i}: pid {e['pid']} has no "
                             f"process_name metadata")
        if (e["pid"], e["tid"]) not in threads:
            raise ValueError(f"event {i}: (pid, tid) ({e['pid']}, "
                             f"{e['tid']}) has no thread_name metadata")
        if last_ts is not None and e["ts"] < last_ts:
            raise ValueError(f"event {i}: ts not monotonically "
                             f"non-decreasing")
        last_ts = e["ts"]


def write_trace(tracer: Tracer, path: str) -> dict:
    """Export + validate + write ``path``; returns the trace dict."""
    doc = chrome_trace(tracer)
    validate_chrome_trace(doc)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return doc
