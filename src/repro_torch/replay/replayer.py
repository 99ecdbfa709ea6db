"""Trace replayer: re-drive a recorded/generated request stream through
real control policies, fast.

A copy of ``repro/replay/replayer.py``: the same decisions, queue delays
and decision hash as the JAX package's replayer on the same trace; only
the wall-clock fields (``wall_seconds``, ``events_per_sec``) differ.

A :class:`TraceReplayer` re-executes only the *decision path* of a fleet
run — routing, placement re-replication, scaling — against any policy
combination from the :mod:`repro_torch.api.policies` registries, while the
data path (storage reads, accelerator service) is reduced to busy-until
timeline arithmetic. That is the difference between re-running the full
simulator (batch adaptation, live execution, per-event logs) and a hot
loop of a few dict/list operations per request: a **million-request**
policy sweep completes in seconds instead of hours, which is what makes
log-driven policy search and
offline training data for :mod:`repro_torch.replay.learned` practical.

The policies are the *real* objects — the same ``route``/``rebalance``/
``decide`` code the live fleet calls — run against shim fleet/server/
store classes that duck-type exactly the state policies read (queue
depths, accelerator busy-until, storage replica maps, virtual time).
Two consequences the tests pin down:

* **round-trip fidelity** — replaying a recorded ``batch`` trace under
  the policies of the live run reproduces its routing decisions
  one-for-one (with static placement): the replayer rebuilds the
  per-tenant pending queues, orders them with the real scheduler policy
  and routes *all* requests before executing any — exactly the live
  fleet's single dispatch round over an idle fleet.
* **determinism** — same trace + same policy combo => identical
  decision hash and verdict, every time (no wall-clock or unseeded
  randomness anywhere in the decision path).
"""
from __future__ import annotations

import hashlib
import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, NamedTuple, Optional, Tuple

from repro_torch.obs.hist import percentile as _percentile
from repro_torch.replay.schema import RequestRecord
from repro_torch.replay.trace import Trace


# ---------------------------------------------------------------------------
# Shim fleet: the minimal surface real policies read
# ---------------------------------------------------------------------------
class _ReplayAccel:
    __slots__ = ("busy_until", "busy_time")

    def __init__(self) -> None:
        self.busy_until = 0.0
        self.busy_time = 0.0


class _ReplayServer:
    """Queue-depth counters + accelerator timelines for one replica."""
    __slots__ = ("server_id", "accels", "alive", "_depth", "_by_tenant")

    def __init__(self, server_id: int, n_accels: int) -> None:
        self.server_id = server_id
        self.accels = [_ReplayAccel() for _ in range(n_accels)]
        self.alive = True
        self._depth = 0
        self._by_tenant: Dict[int, int] = {}

    def queue_depth(self) -> int:
        return self._depth

    def tenant_queue_depth(self, tenant: int) -> int:
        return self._by_tenant.get(tenant, 0)

    def enqueue(self, tenant: int) -> None:
        self._depth += 1
        self._by_tenant[tenant] = self._by_tenant.get(tenant, 0) + 1

    def dequeue(self, tenant: int) -> None:
        self._depth -= 1
        self._by_tenant[tenant] -= 1


class _ReplayNode:
    """Storage-node ingress/read timeline (replica contention model)."""
    __slots__ = ("busy_until", "busy_time", "bandwidth", "latency")

    def __init__(self, bandwidth: float, latency: float) -> None:
        self.busy_until = 0.0
        self.busy_time = 0.0
        self.bandwidth = bandwidth
        self.latency = latency


class _ReplayObject(NamedTuple):
    nbytes: int


class _ReplayStore:
    """Replica map + node timelines; same mutation API placement
    policies use on the live :class:`~repro_torch.cos.objectstore.ObjectStore`."""

    def __init__(self, header) -> None:
        self.nodes = [_ReplayNode(header.internal_bandwidth,
                                  header.storage_latency)
                      for _ in range(header.n_nodes)]
        self.replication = header.replication
        self._placement: Dict[str, List[int]] = {
            o: list(nodes) for o, nodes in header.placement.items()}
        self.objects: Dict[str, _ReplayObject] = {
            o: _ReplayObject(b) for o, b in header.object_bytes.items()}
        self.replicas_added = 0
        self.replicas_dropped = 0

    def replicas(self, name: str) -> List[int]:
        return self._placement[name]

    def add_replica(self, name: str, node: int) -> bool:
        nodes = self._placement[name]
        if node in nodes:
            return False
        nodes.append(node)
        self.replicas_added += 1
        return True

    def remove_replica(self, name: str, node: int, t: float = 0.0) -> bool:
        nodes = self._placement[name]
        if len(nodes) <= 1 or node not in nodes:
            return False          # never drop the last replica
        nodes.remove(node)
        self.replicas_dropped += 1
        return True


class _ReplaySim:
    """Swallows the trace records policies emit (``accel-util``,
    ``scale-hold``); replay keeps decisions, not event logs."""
    __slots__ = ("records",)

    def __init__(self) -> None:
        self.records: List[Tuple[float, str, str]] = []

    def record(self, t: float, kind: str, detail: str = "") -> None:
        self.records.append((t, kind, detail))


class _ReplayFleet:
    """Duck-types the :class:`~repro_torch.cos.fleet.HapiFleet` attributes the
    registry policies touch. ``fabric`` is always None — replay models a
    private-link deployment; fabric-aware policies degrade exactly as
    they do live."""

    fabric = None

    def __init__(self, header, fair: bool) -> None:
        self.store = _ReplayStore(header)
        self.servers = [_ReplayServer(i, header.n_accels)
                        for i in range(header.n_servers)]
        self.sim = _ReplaySim()
        self.cordoned: set = set()
        self.fair_queueing = fair
        self._vtime = 0.0

    def _alive(self) -> List[_ReplayServer]:
        return [s for s in self.servers if s.alive]

    def _routable(self) -> List[_ReplayServer]:
        r = [s for s in self.servers
             if s.alive and s.server_id not in self.cordoned]
        return r or self._alive()

    @property
    def n_routable(self) -> int:
        return len(self._routable())

    def waiting_posts(self) -> int:
        return sum(s._depth for s in self._alive())


class _Served(NamedTuple):
    """Response view for ``policy.observe`` (demand + SLO signals)."""
    object_name: str
    act_bytes: float
    tenant: int
    compute_weight: float
    arrival: float
    started: float
    finished: float

    @property
    def queue_delay(self) -> float:
        return self.started - self.arrival


# ---------------------------------------------------------------------------
# Verdict
# ---------------------------------------------------------------------------
@dataclass
class ReplayVerdict:
    """What one replay decided and how the modeled fleet fared."""

    mode: str
    policies: Dict[str, str]
    n_requests: int
    n_executed: int
    queue_delay_p50: float
    queue_delay_p95: float
    queue_delay_p99: float
    queue_delay_mean: float
    queue_delay_max: float
    makespan: float
    replicas_added: int
    replicas_dropped: int
    scale_ups: int
    scale_downs: int
    decision_hash: str
    wall_seconds: float
    events_per_sec: float
    decisions: Optional[List[tuple]] = field(default=None, repr=False)

    def route_decisions(self) -> List[Tuple[int, str, int]]:
        """``(tenant, object, server_id)`` routing stream (requires
        ``collect_decisions=True``) — comparable against
        :func:`repro_torch.replay.trace.live_route_decisions`."""
        if self.decisions is None:
            raise ValueError("replay ran without collect_decisions=True")
        return [d[1:] for d in self.decisions if d[0] == "route"]

    def as_dict(self) -> dict:
        d = {k: v for k, v in self.__dict__.items() if k != "decisions"}
        return d


# Percentiles are the shared exact nearest-rank implementation
# (repro_torch.obs.hist.percentile), so a ReplayVerdict and a metrics-registry
# histogram can never disagree on the same delays — the historical local
# int(q*n) indexing was floor-biased by one rank.


# ---------------------------------------------------------------------------
# Replayer
# ---------------------------------------------------------------------------
class TraceReplayer:
    """Re-drive ``trace`` under a policy combination.

    Policies default to the live fleet's defaults (replica-aware
    routing, round-robin placement, WDRR dispatch, no scaling) — pass
    instances from the :mod:`repro_torch.api.policies` registries to search
    alternatives. Policy instances are stateful; give each replay fresh
    ones (``PLACEMENT_POLICIES["demand-aware"]()``), exactly like live
    fleets.

    ``tick_interval`` is the virtual-time controller period: placement
    ``rebalance`` and scaling ``decide`` run once per elapsed interval,
    standing in for the live fleet's per-scheduling-round controller
    tick at a replay-friendly cost.
    """

    def __init__(self, trace: Trace, *, routing=None, placement=None,
                 scaling=None, scheduler=None, tick_interval: float = 30.0,
                 collect_decisions: bool = False, tracer=None,
                 trace_sample: int = 8) -> None:
        from repro_torch.api.policies import (ReplicaAwareRouting,
                                        RoundRobinPlacement, WdrrScheduling)
        self.trace = trace
        self.routing = routing or ReplicaAwareRouting()
        self.placement = placement or RoundRobinPlacement()
        self.scaling = scaling
        self.scheduler = scheduler or WdrrScheduling()
        self.tick_interval = tick_interval
        self.collect = collect_decisions
        # Opt-in (None = off): replay is a hot loop of ~10us/request, so
        # tracing must cost nothing when unused. With a repro_torch.obs.Tracer
        # passed, every ``trace_sample``-th executed request emits one
        # lightweight span (deterministic counter, so sampled traces are
        # still seed-reproducible); ``trace_sample=1`` records every
        # request. Track names and label tuples are interned so the
        # per-sample cost is one raw-tuple append.
        self.tracer = tracer
        self.trace_sample = max(1, trace_sample)
        self._span_skip = 0
        self._span_tracks: Dict[int, str] = {}
        self._span_labels: Dict[int, tuple] = {}

    # -- decision/tick helpers ----------------------------------------------
    def _tick(self, fleet: _ReplayFleet, sha, decisions,
              counts: Dict[str, int]) -> None:
        for oname, node in self.placement.rebalance(fleet):
            if fleet.store.add_replica(oname, node):
                d = ("replicate", oname, node)
                sha.update(repr(d).encode())
                if decisions is not None:
                    decisions.append(d)
        if self.scaling is None:
            return
        step = self.scaling.decide(fleet)
        if step > 0:
            counts["ups"] += 1
            for sid in sorted(fleet.cordoned):
                fleet.cordoned.discard(sid)
                break
            else:
                fleet.servers.append(_ReplayServer(
                    len(fleet.servers), self.trace.header.n_accels))
            d = ("scale", +1)
        elif step < 0:
            cands = [s for s in fleet._routable()]
            if len(cands) <= self.scaling.min_servers:
                return
            victim = min(cands, key=lambda s: (s._depth, -s.server_id))
            fleet.cordoned.add(victim.server_id)
            counts["downs"] += 1
            d = ("scale", -1)
        else:
            return
        sha.update(repr(d).encode())
        if decisions is not None:
            decisions.append(d)

    def _execute(self, fleet: _ReplayFleet, server: _ReplayServer,
                 req: RequestRecord, not_before: float) -> _Served:
        """Charge the data path: read from the least-busy replica node,
        then serve on the server's earliest-free accelerator."""
        store = fleet.store
        node = store.nodes[min(store.replicas(req.object_name),
                               key=lambda n: (store.nodes[n].busy_until, n))]
        rs = max(not_before, node.busy_until)
        dur = node.latency + store.objects[req.object_name].nbytes \
            / node.bandwidth
        node.busy_until = rs + dur
        node.busy_time += dur
        accel = min(server.accels, key=lambda a: a.busy_until)
        start = max(rs + dur, accel.busy_until)
        end = start + req.service
        accel.busy_until = end
        accel.busy_time += req.service
        tr = self.tracer
        if tr is not None:
            self._span_skip += 1
            if self._span_skip >= self.trace_sample:
                self._span_skip = 0
                track = self._span_tracks.get(server.server_id)
                if track is None:
                    track = self._span_tracks[server.server_id] = \
                        f"s{server.server_id}"
                labels = self._span_labels.get(req.tenant)
                if labels is None:
                    labels = self._span_labels[req.tenant] = \
                        (("tenant", str(req.tenant)),)
                tr.emit_fast("replay.request", start, end, "compute", track,
                             -1, labels)
        return _Served(req.object_name, req.act_bytes, req.tenant,
                       req.compute_weight, req.arrival, start, end)

    def _observe(self, served: _Served) -> None:
        self.placement.observe(served)
        if self.scaling is not None:
            self.scaling.observe(served)

    # -- entry point ---------------------------------------------------------
    def run(self) -> ReplayVerdict:
        t0 = time.perf_counter()
        trace, header = self.trace, self.trace.header
        fleet = _ReplayFleet(header, self.scheduler.fair)
        sha = hashlib.sha256()
        decisions: Optional[List[tuple]] = [] if self.collect else None
        counts = {"ups": 0, "downs": 0}
        if header.mode == "batch":
            delays, makespan = self._run_batch(fleet, sha, decisions, counts)
        else:
            delays, makespan = self._run_open_loop(fleet, sha, decisions,
                                                   counts)
        wall = time.perf_counter() - t0
        delays.sort()
        n = len(trace.requests)
        return ReplayVerdict(
            mode=header.mode,
            policies={"routing": self.routing.name,
                      "placement": self.placement.name,
                      "scaling": self.scaling.name if self.scaling else "none",
                      "scheduler": self.scheduler.name},
            n_requests=n, n_executed=len(delays),
            queue_delay_p50=_percentile(delays, 0.50),
            queue_delay_p95=_percentile(delays, 0.95),
            queue_delay_p99=_percentile(delays, 0.99),
            queue_delay_mean=sum(delays) / len(delays) if delays else 0.0,
            queue_delay_max=delays[-1] if delays else 0.0,
            makespan=makespan,
            replicas_added=fleet.store.replicas_added,
            replicas_dropped=fleet.store.replicas_dropped,
            scale_ups=counts["ups"], scale_downs=counts["downs"],
            decision_hash=sha.hexdigest(),
            wall_seconds=wall,
            events_per_sec=n / wall if wall > 0 else 0.0,
            decisions=decisions,
        )

    def _route(self, fleet: _ReplayFleet, req: RequestRecord, sha,
               decisions) -> _ReplayServer:
        server = self.routing.route(fleet, req, fleet._routable())
        server.enqueue(req.tenant)
        d = ("route", req.tenant, req.object_name, server.server_id)
        sha.update(repr(d).encode())
        if decisions is not None:
            decisions.append(d)
        return server

    def _run_batch(self, fleet, sha, decisions, counts):
        """Recorded burst drain: every request pending before serving
        starts. Dispatch order comes from the real scheduler policy and
        *all* routing happens against the idle fleet before any
        execution — the live fleet's single dispatch round, which is
        what makes replayed decisions match recorded ones one-for-one."""
        pending: Dict[int, Deque[RequestRecord]] = {}
        for req in self.trace.requests:
            pending.setdefault(req.tenant, deque()).append(req)
        # ComputeScheduler.weight_of: pinned class weight, else the first
        # queued request's compute weight.
        weights = {t: header_w for t, header_w in
                   self.trace.header.tenant_weights.items()}
        for t, q in pending.items():
            weights.setdefault(t, q[0].compute_weight if q else 1.0)
        ordered = self.scheduler.order(pending, weights)
        routed = [(req, self._route(fleet, req, sha, decisions))
                  for req in ordered]
        delays: List[float] = []
        makespan = 0.0
        next_tick = self.tick_interval
        for req, server in routed:
            server.dequeue(req.tenant)
            if req.service <= 0.0:
                continue              # recorded reject: routed, never served
            served = self._execute(fleet, server, req, req.arrival)
            self._observe(served)
            delays.append(served.queue_delay)
            makespan = max(makespan, served.finished)
            fleet._vtime = max(fleet._vtime, served.started)
            if fleet._vtime >= next_tick:
                self._tick(fleet, sha, decisions, counts)
                next_tick += self.tick_interval
        return delays, makespan

    def _run_open_loop(self, fleet, sha, decisions, counts):
        """Generated/production day: requests routed and served in
        arrival order; a completion heap retires queued work lazily so
        queue-depth counters stay honest without a full event queue."""
        completions: List[Tuple[float, int, _ReplayServer, int]] = []
        delays: List[float] = []
        makespan = 0.0
        next_tick = self.tick_interval
        seq = 0
        tick_interval = self.tick_interval
        for req in self.trace.requests:
            arrival = req.arrival
            while completions and completions[0][0] <= arrival:
                _, _, srv, ten = heapq.heappop(completions)
                srv.dequeue(ten)
            while arrival >= next_tick:
                fleet._vtime = next_tick
                self._tick(fleet, sha, decisions, counts)
                next_tick += tick_interval
            fleet._vtime = arrival
            server = self._route(fleet, req, sha, decisions)
            if req.service <= 0.0:
                server.dequeue(req.tenant)
                continue
            served = self._execute(fleet, server, req, arrival)
            self._observe(served)
            delays.append(served.queue_delay)
            if served.started > arrival:
                heapq.heappush(completions,
                               (served.started, seq, server, req.tenant))
                seq += 1
            else:
                server.dequeue(req.tenant)
            makespan = max(makespan, served.finished)
        return delays, makespan


def replay(trace: Trace, **kwargs) -> ReplayVerdict:
    """One-call convenience: ``replay(trace, placement=..., ...)``."""
    return TraceReplayer(trace, **kwargs).run()


__all__ = ["TraceReplayer", "ReplayVerdict", "replay"]
