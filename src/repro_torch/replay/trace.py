"""Trace container + JSONL writer/reader + live-run recorder.

A :class:`Trace` is the in-memory form of the versioned JSONL format in
:mod:`repro_torch.replay.schema`: one header, a request stream, and (for
recorded runs) the event log of the live run. Serialization is
byte-deterministic — ``json.dumps`` with sorted keys and compact
separators — so "same seed => byte-identical trace file" is a testable
property, exactly like the simulator's event-log determinism.

:func:`record_trace` snapshots a drained :class:`repro_torch.api.HapiCluster`
into a trace: the deployment shape into the header, every submitted
request (with its *measured* service time and served bytes) into the
request stream, and the full simulator event log into event records —
everything a :class:`~repro_torch.replay.replayer.TraceReplayer` needs to
re-drive the run's decision path against alternative policies.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.replay.schema import (
    EventRecord,
    RequestRecord,
    TRACE_VERSION,
    TraceHeader,
    validate_kind,
)


class Trace:
    """Header + request stream + (optional) recorded events."""

    def __init__(self, header: TraceHeader,
                 requests: Iterable[RequestRecord],
                 events: Iterable[EventRecord] = ()) -> None:
        self.header = header
        self.requests: List[RequestRecord] = list(requests)
        self.events: List[EventRecord] = list(events)

    def __len__(self) -> int:
        return len(self.requests)

    def events_of(self, kind: str) -> List[EventRecord]:
        return [e for e in self.events if e.kind == kind]

    # -- serialization ---------------------------------------------------------
    def to_jsonl_bytes(self) -> bytes:
        """Byte-deterministic JSONL: header line, then requests, then
        events (order preserved)."""
        lines = [_dumps(_header_obj(self.header))]
        for r in self.requests:
            lines.append(_dumps({
                "type": "request", "id": r.req_id, "tenant": r.tenant,
                "obj": r.object_name, "model": r.model_key,
                "arrival": r.arrival, "service": r.service,
                "act_bytes": r.act_bytes, "nw": r.network_weight,
                "cw": r.compute_weight,
            }))
        for e in self.events:
            lines.append(_dumps({
                "type": "event", "t": e.t,
                "kind": validate_kind(e.kind), "detail": e.detail,
            }))
        return ("\n".join(lines) + "\n").encode()

    @classmethod
    def from_jsonl_bytes(cls, raw: bytes) -> "Trace":
        header: Optional[TraceHeader] = None
        requests: List[RequestRecord] = []
        events: List[EventRecord] = []
        for line in raw.decode().splitlines():
            if not line.strip():
                continue
            obj = json.loads(line)
            typ = obj.get("type")
            if typ == "header":
                header = _parse_header(obj)
            elif typ == "request":
                requests.append(RequestRecord(
                    req_id=int(obj["id"]), tenant=int(obj["tenant"]),
                    object_name=obj["obj"], model_key=obj["model"],
                    arrival=float(obj["arrival"]),
                    service=float(obj["service"]),
                    act_bytes=float(obj["act_bytes"]),
                    network_weight=float(obj["nw"]),
                    compute_weight=float(obj["cw"]),
                ))
            elif typ == "event":
                events.append(EventRecord(float(obj["t"]),
                                          validate_kind(obj["kind"]),
                                          obj["detail"]))
            else:
                raise ValueError(f"unknown trace record type {typ!r}")
        if header is None:
            raise ValueError("trace has no header record")
        return cls(header, requests, events)

    def write(self, path: str) -> str:
        with open(path, "wb") as f:
            f.write(self.to_jsonl_bytes())
        return path

    @classmethod
    def read(cls, path: str) -> "Trace":
        with open(path, "rb") as f:
            return cls.from_jsonl_bytes(f.read())


def _dumps(obj: dict) -> str:
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _header_obj(h: TraceHeader) -> dict:
    return {
        "type": "header", "version": h.version, "seed": h.seed,
        "mode": h.mode, "n_servers": h.n_servers, "n_accels": h.n_accels,
        "n_nodes": h.n_nodes, "replication": h.replication,
        "internal_bandwidth": h.internal_bandwidth,
        "storage_latency": h.storage_latency,
        "tenant_weights": {str(t): w
                           for t, w in sorted(h.tenant_weights.items())},
        "placement": {o: list(nodes)
                      for o, nodes in sorted(h.placement.items())},
        "object_bytes": {o: b for o, b in sorted(h.object_bytes.items())},
    }


def _parse_header(obj: dict) -> TraceHeader:
    return TraceHeader(
        version=int(obj["version"]), seed=int(obj["seed"]), mode=obj["mode"],
        n_servers=int(obj["n_servers"]), n_accels=int(obj["n_accels"]),
        n_nodes=int(obj["n_nodes"]), replication=int(obj["replication"]),
        internal_bandwidth=float(obj["internal_bandwidth"]),
        storage_latency=float(obj["storage_latency"]),
        tenant_weights={int(t): float(w)
                        for t, w in obj["tenant_weights"].items()},
        placement={o: tuple(int(n) for n in nodes)
                   for o, nodes in obj["placement"].items()},
        object_bytes={o: int(b) for o, b in obj["object_bytes"].items()},
    )


# ---------------------------------------------------------------------------
# Recording a live run
# ---------------------------------------------------------------------------
def record_trace(cluster, responses, *, mode: str = "batch") -> Trace:
    """Snapshot a drained :class:`repro_torch.api.HapiCluster` into a trace.

    ``responses`` are the :class:`~repro_torch.cos.server.PostResponse` list
    the drain returned — each request's *measured* service time
    (``finished - started``) and served bytes go into its record, so a
    replay charges exactly what the live run did. Requests that were
    rejected (no response) are recorded with zero service and excluded
    bytes; the replayer still routes them (routing is the decision under
    study), it just charges nothing for them.

    ``mode="batch"`` matches how fleet drains actually run — every
    request is pending before serving starts — and is what lets a replay
    under the same policies reproduce the live dispatch decisions
    one-for-one (the round-trip property test).
    """
    fleet = cluster.fleet
    store = fleet.store
    resp_by_id = {r.req_id: r for r in responses}
    requests = []
    for rid in sorted(fleet._req_by_id):
        req = fleet._req_by_id[rid]
        resp = resp_by_id.get(rid)
        requests.append(RequestRecord(
            req_id=rid, tenant=req.tenant, object_name=req.object_name,
            model_key=req.model_key, arrival=req.arrival,
            service=(resp.finished - resp.started) if resp else 0.0,
            act_bytes=resp.act_bytes if resp else 0.0,
            network_weight=req.network_weight,
            compute_weight=req.compute_weight,
        ))
    header = TraceHeader(
        version=TRACE_VERSION, seed=cluster.seed, mode=mode,
        n_servers=len(fleet.servers),
        n_accels=len(fleet.servers[0].accels) if fleet.servers else 0,
        n_nodes=len(store.nodes), replication=store.replication,
        internal_bandwidth=store.nodes[0].bandwidth,
        storage_latency=store.nodes[0].latency,
        tenant_weights=dict(fleet.scheduler.weights),
        placement={o: tuple(nodes)
                   for o, nodes in store._placement.items()},
        object_bytes={o: obj.nbytes for o, obj in store.objects.items()},
    )
    events = [EventRecord(t, validate_kind(k), d)
              for (t, k, d) in fleet.sim.log.events]
    return Trace(header, requests, events)


def live_route_decisions(trace: Trace) -> List[Tuple[int, str, int]]:
    """The recorded run's routing decisions, in dispatch order, parsed
    from its ``route`` events as ``(tenant, object_name, server_id)`` —
    what a same-policy replay must reproduce exactly."""
    out = []
    for e in trace.events_of("route"):
        # detail: "t{tenant} {object} -> s{server_id}"
        tpart, obj, _, spart = e.detail.split()
        out.append((int(tpart[1:]), obj, int(spart[1:])))
    return out


__all__ = ["Trace", "record_trace", "live_route_decisions"]
