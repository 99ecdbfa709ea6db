"""Multi-server, multi-tenant COS fleet front-end.

A copy of ``repro/cos/fleet.py``: the same routing, re-issue, scaling and
return-path decisions in the same order, so a fleet of either package
given the same requests logs the same events at the same virtual times.

The paper's server is stateless by design (§5.2): nothing survives a
request, so horizontal scaling is "just add queues". This module is that
step — a :class:`HapiFleet` that fronts N :class:`HapiServer` replicas
with:

* **pluggable routing** — which replica serves a POST is a
  :class:`~repro_torch.api.policies.RoutingPolicy` (default: replica-aware +
  least-loaded with tenant spreading);
* **pluggable placement** — where object replicas live, including
  demand-aware re-replication while the fleet runs, is a
  :class:`~repro_torch.api.policies.PlacementPolicy`;
* **class-weighted scheduling** — pending POSTs are kept in per-tenant
  queues inside a fleet-wide
  :class:`~repro_torch.cos.scheduler.ComputeScheduler` and released by a
  pluggable :class:`~repro_torch.cos.scheduler.SchedulerPolicy` (weighted
  deficit round-robin on tenant compute weights by default; equal
  weights are exactly the historical fair-queueing round-robin), so one
  tenant's burst cannot starve another and gold tenants get
  weight-proportional accelerator time;
* **cross-server batch coalescing** — with ``coalescing=True`` the
  scheduler ships queued requests for a model to a replica whose
  accelerator already holds it loaded (active lease), cutting the
  stateless per-request reload charge;
* **kill/restart elasticity** — the fleet tracks which replica holds
  each in-flight request; when a replica dies its queue is lost
  (stateless crash) and the fleet re-issues the lost requests to the
  survivors, exactly the client re-issue the paper relies on;
* **cordon-and-drain scale-down** — a retiring replica is first
  *cordoned* (routing stops sending it work) and keeps serving its
  queue; it is killed only once drained, so consolidation never
  forces re-issues (ROADMAP: scale-down draining);
* **pluggable autoscaling** — growth/shrink decisions are a
  :class:`~repro_torch.api.policies.ScalingPolicy` (queue-depth hysteresis by
  default, SLO-miss-aware as an alternative);
* **fleet-wide live execution** — :meth:`register_executor` threads a
  forward function (``core.tier_split.make_vision_executor`` on the
  card) to every replica, including replicas the autoscaler spawns
  later, so live-mode multi-replica runs exercise real kernels.

All replicas, the object store, and the clients share one
:class:`~repro_torch.cos.clock.Simulator`: a single event queue with
deterministic ordering, so the same seed reproduces the same trace
byte-for-byte under any policy combination (asserted for the port by
tests/test_torch_fleet.py).

Prefer standing fleets up through :class:`repro_torch.api.HapiCluster` — the
facade owns the simulator/store/fleet/client wiring so callers never
assemble it by hand.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple, Union

from repro_torch.api.policies import (
    PlacementPolicy,
    QueueDepthScaling,
    ReplicaAwareRouting,
    RoundRobinPlacement,
    RoutingPolicy,
    ScalingPolicy,
)
from repro_torch.cos.clock import Simulator
from repro_torch.cos.objectstore import ObjectStore
from repro_torch.cos.scheduler import (
    ComputeScheduler,
    FifoScheduling,
    SchedulerPolicy,
    WdrrScheduling,
)
from repro_torch.cos.server import HapiServer, PostRequest, PostResponse
from repro_torch.cos.weightcache import WeightCache


class _ServedRequest(NamedTuple):
    """What the fleet keeps of a finished request under compact
    retention: exactly the fields :func:`repro_torch.replay.trace.record_trace`
    reads, at a fraction of a full :class:`PostRequest` — the intake map
    must not pin every profile-bearing request a long run ever served."""

    req_id: int
    tenant: int
    object_name: str
    model_key: str
    arrival: float
    network_weight: float
    compute_weight: float


@dataclass(frozen=True)
class AutoscalePolicy:
    """Back-compat parameter block for the queue-depth autoscaler.

    Kept as the concise way to say "autoscale with these watermarks";
    the fleet converts it into a
    :class:`~repro_torch.api.policies.QueueDepthScaling` strategy. Pass
    ``scaling=`` for any other policy."""
    min_servers: int = 1
    max_servers: int = 8
    scale_up_depth: float = 8.0
    scale_down_depth: float = 0.5
    cooldown_rounds: int = 4

    def to_policy(self) -> QueueDepthScaling:
        return QueueDepthScaling(
            min_servers=self.min_servers, max_servers=self.max_servers,
            scale_up_depth=self.scale_up_depth,
            scale_down_depth=self.scale_down_depth,
            cooldown_rounds=self.cooldown_rounds,
        )


@dataclass
class TenantStats:
    posts: int = 0
    samples: int = 0
    act_bytes: float = 0.0
    first_arrival: float = float("inf")
    last_finish: float = 0.0

    @property
    def throughput(self) -> float:
        """Served samples per virtual second over the tenant's span."""
        span = self.last_finish - self.first_arrival
        return self.samples / span if span > 0 else 0.0


class HapiFleet:
    """Drop-in for :class:`HapiServer` from the client's point of view
    (``store`` / ``submit`` / ``drain`` / ``adapt_results``) that routes
    across N stateless replicas. Control behavior is delegated to the
    routing/placement/scaling strategies (see :mod:`repro_torch.api.policies`);
    the defaults reproduce the historical hard-coded behavior exactly."""

    def __init__(
        self,
        store: ObjectStore,
        n_servers: int = 2,
        *,
        sim: Optional[Simulator] = None,
        seed: int = 0,
        fair_queueing: Optional[bool] = None,
        autoscale: Optional[AutoscalePolicy] = None,
        routing: Optional[RoutingPolicy] = None,
        placement: Optional[PlacementPolicy] = None,
        scaling: Optional[ScalingPolicy] = None,
        scheduler: Optional[Union[SchedulerPolicy, ComputeScheduler]] = None,
        coalescing: Optional[bool] = None,
        weight_cache: Optional[WeightCache] = None,
        return_path: bool = False,
        return_bandwidth: Optional[float] = None,
        **server_kwargs,
    ) -> None:
        self.sim = sim if sim is not None else Simulator(seed)
        self.store = store.attach_sim(self.sim)
        self.routing: RoutingPolicy = routing or ReplicaAwareRouting()
        if scaling is None and autoscale is not None:
            scaling = autoscale.to_policy()
        self.scaling: Optional[ScalingPolicy] = scaling
        # Admission/dispatch live in the ComputeScheduler subsystem
        # (weighted deficit-round-robin by default — byte-identical to
        # the historical fair-queueing round-robin at equal weights).
        # `fair_queueing=` is the deprecated boolean alias for the
        # scheduler policy: True -> WDRR, False -> FIFO.
        if fair_queueing is not None:
            warnings.warn(
                "HapiFleet(fair_queueing=...) is deprecated; pass "
                "scheduler=WdrrScheduling() (the default) or "
                "scheduler=FifoScheduling() instead",
                DeprecationWarning, stacklevel=2)
            if scheduler is None:
                scheduler = (WdrrScheduling() if fair_queueing
                             else FifoScheduling())
        if isinstance(scheduler, ComputeScheduler):
            self.scheduler = scheduler
            if coalescing is not None:       # explicit flag wins either way
                self.scheduler.coalescing = coalescing
        else:
            self.scheduler = ComputeScheduler(scheduler,
                                              coalescing=bool(coalescing))
        # Fleet-wide warm-weight cache (None = off, the byte-identical
        # default): shared by every replica via the shared scheduler.
        if weight_cache is not None:
            self.scheduler.cache = weight_cache
        # Placement precedence: explicit arg, then whatever the store was
        # built with, then the static default. The chosen policy is pushed
        # back onto the store so later put_dataset calls agree with it.
        if placement is None:
            placement = getattr(store, "placement", None) or RoundRobinPlacement()
        self.placement: PlacementPolicy = placement
        self.store.placement = placement
        self._server_kwargs = dict(server_kwargs)
        self._executors: Dict[str, Callable] = {}
        self.servers: List[HapiServer] = [
            HapiServer(store, server_id=i, sim=self.sim,
                       scheduler=self.scheduler, **server_kwargs)
            for i in range(n_servers)
        ]
        self.cordoned: set = set()                   # server ids draining out
        self._inflight: Dict[int, int] = {}          # req_id -> server index
        # Intake map: full PostRequest while in flight; under compact
        # retention a finished request is slimmed to a _ServedRequest
        # (record_trace still reads it; the profile reference is freed).
        self._req_by_id: Dict[int, Union[PostRequest, _ServedRequest]] = {}
        self._slim_done = self.sim.log.retention == "compact"
        self.reissued = 0
        self.rejected: List[int] = []
        # Cross-tenant response rendezvous (same contract as
        # HapiServer.unclaimed): responses drained by one tenant's client
        # on behalf of another wait here for their owner.
        self.unclaimed: Dict[int, PostResponse] = {}
        self.served_by_server: Dict[int, int] = {}
        self.tenant_stats: Dict[int, TenantStats] = {}
        self._vtime = 0.0                            # fleet-wide virtual time
        # Burst return path (default off, byte-identical when off):
        # activation bytes of burst responses are pulled back over the
        # owning tenant's NIC + shared WAN trunk per drain round, instead
        # of materializing instantly at the client. Needs a fabric.
        self.return_path = return_path
        self.return_bandwidth = return_bandwidth
        self.return_ports: Dict[int, object] = {}    # tenant -> FabricPort

    # -- topology ------------------------------------------------------------
    def _alive(self) -> List[HapiServer]:
        return [s for s in self.servers if s.alive]

    def _routable(self) -> List[HapiServer]:
        """Replicas new work may be routed to: alive and not cordoned.
        Falls back to all alive replicas if everything is cordoned (work
        must land somewhere; the cordon is advisory, not a crash)."""
        r = [s for s in self.servers if s.alive
             and s.server_id not in self.cordoned]
        return r or self._alive()

    @property
    def n_alive(self) -> int:
        return len(self._alive())

    @property
    def n_routable(self) -> int:
        """Replicas actually accepting new work — the capacity signal
        scaling policies must use (cordoned replicas still drain their
        queues but contribute nothing to future throughput)."""
        return len(self._routable())

    @property
    def alive(self) -> bool:
        return self.n_alive > 0

    @property
    def fabric(self):
        """The shared :class:`~repro_torch.cos.network.NetworkFabric` behind
        the store's links, or None on private-link deployments — what
        fabric-aware policies read (trunk capacity, per-tenant measured
        bandwidth, storage ingress busyness)."""
        return getattr(self.store, "fabric", None)

    @property
    def fair_queueing(self) -> bool:
        """Deprecated alias (one release of compat): does the dispatch
        policy interleave tenants? Tenant-spreading routers read this."""
        return self.scheduler.policy.fair

    @property
    def adapt_results(self):
        return [r for s in self.servers for r in s.adapt_results]

    @property
    def adapt_results_by_server(self) -> Dict[int, list]:
        return {s.server_id: list(s.adapt_results) for s in self.servers}

    def waiting_posts(self) -> int:
        """Scaling signal: POSTs not yet being executed — pending at the
        scheduler plus queued on alive replicas."""
        return self.scheduler.pending_total() + \
            sum(s.queue_depth() for s in self._alive())

    def accel_utilization(self) -> float:
        """Lifetime mean busy fraction of the alive replicas'
        accelerators over the fleet's elapsed virtual time — a coarse
        report-level saturation metric. Scaling decisions should window
        it instead (``SloScaling`` snapshots busy-time between
        controller evaluations so an idle stretch cannot dilute a fresh
        saturating burst)."""
        accels = [a for s in self._alive() for a in s.accels]
        if not accels or self._vtime <= 0.0:
            return 0.0
        busy = sum(min(a.busy_time, self._vtime) for a in accels)
        return busy / (len(accels) * self._vtime)

    # -- live execution --------------------------------------------------------
    def register_executor(self, model_key: str, fn: Callable) -> None:
        """Register a forward ``fn(payload, split, cos_batch)`` (such as
        ``make_vision_executor``) fleet-wide: on every current replica
        and on any replica the autoscaler spawns later."""
        self._executors[model_key] = fn
        for s in self.servers:
            s.register_executor(model_key, fn)

    # -- elasticity ------------------------------------------------------------
    def kill(self, server_id: int) -> None:
        """Crash one replica. Its queue is lost (stateless crash); the
        fleet re-issues the requests it was holding immediately, so a
        restart of the same replica before the next drain cannot strand
        them."""
        self.servers[server_id].kill()
        self.cordoned.discard(server_id)
        self.sim.record(self._vtime, "kill", f"s{server_id}")
        mx = self.sim.metrics
        mx.inc("scale_events_total", kind="kill")
        self._reissue_lost()

    def restart(self, server_id: int) -> None:
        self.servers[server_id].restart()
        self.sim.record(self._vtime, "restart", f"s{server_id}")
        mx = self.sim.metrics
        mx.inc("scale_events_total", kind="restart")

    def add_server(self) -> HapiServer:
        """Scale up: un-cordon a draining replica if any (the cheapest
        capacity — it is still alive), else revive a dead replica, else
        spawn a fresh one (stateless servers make both identical). New
        replicas inherit the fleet-wide executor registry."""
        mx = self.sim.metrics
        for sid in sorted(self.cordoned):
            s = self.servers[sid]
            if s.alive:
                self.cordoned.discard(sid)
                self.sim.record(self._vtime, "scale-up", f"s{sid} uncordon")
                mx.inc("scale_events_total", kind="scale-up")
                return s
            self.cordoned.discard(sid)       # stale entry: replica died
        for s in self.servers:
            if not s.alive:
                s.restart()
                self.sim.record(self._vtime, "scale-up", f"s{s.server_id}")
                mx.inc("scale_events_total", kind="scale-up")
                return s
        s = HapiServer(self.store, server_id=len(self.servers), sim=self.sim,
                       scheduler=self.scheduler, **self._server_kwargs)
        for key, fn in self._executors.items():
            s.register_executor(key, fn)
        self.servers.append(s)
        self.sim.record(self._vtime, "scale-up", f"s{s.server_id}")
        mx.inc("scale_events_total", kind="scale-up")
        return s

    def remove_server(self) -> Optional[HapiServer]:
        """Scale down by cordon-and-drain: pick the routable replica with
        the shallowest queue (highest id on ties), stop routing to it and
        let it serve out its queue; :meth:`_retire_drained` kills it once
        empty. An already-idle victim therefore retires immediately —
        the historical behavior — while a busy one drains first instead
        of being refused (ROADMAP: scale-down draining)."""
        floor = self.scaling.min_servers if self.scaling else 1
        cands = [s for s in self._alive() if s.server_id not in self.cordoned]
        if len(cands) <= floor:
            return None
        victim = min(cands, key=lambda s: (s.queue_depth(), -s.server_id))
        self.cordoned.add(victim.server_id)
        self.sim.record(self._vtime, "cordon", f"s{victim.server_id}")
        mx = self.sim.metrics
        mx.inc("scale_events_total", kind="cordon")
        self._retire_drained()
        return victim

    def _retire_drained(self) -> int:
        """Kill cordoned replicas whose queues have fully drained (no
        queued and no in-flight requests); returns #retired."""
        retired = 0
        for sid in sorted(self.cordoned):
            s = self.servers[sid]
            if not s.alive:
                self.cordoned.discard(sid)   # died some other way
                continue
            if s.queue or any(si == sid for si in self._inflight.values()):
                continue
            s.kill()
            self.cordoned.discard(sid)
            self.sim.record(self._vtime, "scale-down", f"s{sid}")
            mx = self.sim.metrics
            mx.inc("scale_events_total", kind="scale-down")
            retired += 1
        return retired

    # -- intake + routing ------------------------------------------------------
    def submit(self, req: PostRequest) -> None:
        if not self.alive:
            raise ConnectionError("hapi fleet down")
        self._req_by_id[req.req_id] = req
        self.scheduler.enqueue(req)
        ts = self.tenant_stats.setdefault(req.tenant, TenantStats())
        ts.first_arrival = min(ts.first_arrival, req.arrival)
        self.sim.record(req.arrival, "post", f"t{req.tenant} {req.object_name}")
        # Root of the request's causal tree: every tier the request
        # touches (storage read, admission, pushdown compute, wire pull)
        # parents its span here; _account/client pulls extend the end.
        tr = self.sim.tracer
        req.span_id = tr.begin(
            "request", req.arrival, tier="control",
            track=f"tenant{req.tenant}",
            labels=(("tenant", str(req.tenant)),
                    ("model", req.model_key),
                    ("split", str(req.split)),
                    ("object", req.object_name)))
        mx = self.sim.metrics
        mx.inc("requests_total", tenant=req.tenant)

    def dispatch(self) -> int:
        """Move pending requests onto replicas in scheduler-policy order
        (weighted deficit round-robin across tenants by default; FIFO
        keeps submission order). Returns #dispatched."""
        return self.scheduler.dispatch(self)

    def _dispatch_one(self, req: PostRequest,
                      alive: Optional[List[HapiServer]] = None) -> int:
        # The scheduler passes one routable-set snapshot for a whole
        # dispatch round (nothing inside the loop changes topology);
        # direct callers let us compute it here.
        if alive is None:
            alive = self._routable()
        if not alive:
            raise ConnectionError("hapi fleet down")
        server = self.routing.route(self, req, alive)
        server.submit(req)
        # server_id == position in self.servers by construction (servers
        # are only ever appended), so no O(n_servers) index() scan.
        self._inflight[req.req_id] = server.server_id
        self.sim.record(max(self._vtime, req.arrival), "route",
                        f"t{req.tenant} {req.object_name} -> s{server.server_id}")
        return 1

    def _slim(self, rid: int) -> None:
        """Compact retention: replace a finished request's intake entry
        with the trace-record fields only (frees the profile-bearing
        PostRequest)."""
        req = self._req_by_id.get(rid)
        if type(req) is PostRequest:
            self._req_by_id[rid] = _ServedRequest(
                req.req_id, req.tenant, req.object_name, req.model_key,
                req.arrival, req.network_weight, req.compute_weight)

    def _reissue_lost(self) -> None:
        # O(n_servers) liveness check before the O(inflight) scan: with
        # no dead replica nothing can be lost, and the drain loop calls
        # this every round while tens of thousands of posts are inflight.
        if all(s.alive for s in self.servers):
            return
        lost = sorted(rid for rid, si in self._inflight.items()
                      if not self.servers[si].alive)
        for rid in lost:
            req = self._req_by_id[rid]
            del self._inflight[rid]
            self.scheduler.enqueue(req)
            self.reissued += 1
            self.sim.record(self._vtime, "reissue",
                            f"t{req.tenant} {req.object_name}")

    def _rebalance(self) -> None:
        """After a scale-up, pull excess queued work off overloaded
        replicas back into the pending queues so dispatch re-routes it
        across the grown fleet. Stateless servers make this free — a
        queued request has no server-side footprint yet."""
        alive = self._routable()
        if len(alive) < 2:
            return
        total = sum(s.queue_depth() for s in alive)
        target = -(-total // len(alive))          # ceil
        moved = 0
        for s in alive:
            while s.queue_depth() > target:
                req = s.queue.pop()               # newest queued first
                self._inflight.pop(req.req_id, None)
                self.scheduler.enqueue(req)
                moved += 1
        if moved:
            self.sim.record(self._vtime, "rebalance", f"moved={moved}")

    def _re_replicate(self) -> int:
        """Ask the placement policy for extra replicas (demand-aware
        policies spread hot objects as demand is observed and when the
        fleet grows past the replica count); static policies return
        nothing. Called once per drain scheduling round."""
        made = 0
        for oname, node in self.placement.rebalance(self):
            if self.store.add_replica(oname, node):
                made += 1
        return made

    # -- autoscaling -----------------------------------------------------------
    def _autoscale_step(self) -> None:
        if self.scaling is None:
            return
        decision = self.scaling.decide(self)
        if decision > 0:
            self.add_server()
            self._rebalance()
        elif decision < 0:
            self.remove_server()

    # -- serving ----------------------------------------------------------------
    def _work_remains(self) -> bool:
        return bool(self._inflight) or self.scheduler.has_pending()

    def drain(self, now: float = 0.0) -> List[PostResponse]:
        """Serve everything pending/in-flight across the fleet.

        Replicas are stepped one batch-adaptation round at a time, always
        the least-advanced replica first (deterministic event order), so
        control events — kills, restarts, autoscaler decisions — interleave
        with serving exactly like a discrete-event simulation step loop.
        """
        responses: List[PostResponse] = []
        server_now: Dict[int, float] = {}
        guard = 0
        while self._work_remains():
            guard += 1
            assert guard < 100_000, "fleet scheduler livelock"
            self.sim.run_until(max(now, self._vtime))
            self._reissue_lost()
            if not self.alive:
                raise ConnectionError("hapi fleet down")
            self.dispatch()
            self._autoscale_step()
            self._retire_drained()     # cordoned replicas that ran dry
            self._re_replicate()       # placement tick: demand-aware
            self.scheduler.coalesce(self)   # warm-replica consolidation
            # Least-advanced live replica with queued work, lowest id on
            # ties — a manual strict-less scan (one pass, no list builds
            # or lambda-key min()) picking exactly the replica the old
            # min(active, key=(server_now, server_id)) chose.
            s = None
            sn = 0.0
            get_now = server_now.get
            for cand in self.servers:
                if cand.alive and cand.queue:
                    t_c = get_now(cand.server_id, now)
                    if s is None or t_c < sn:
                        s, sn = cand, t_c
            if s is None:
                # in-flight on dead replicas only: loop re-issues them
                continue
            served, server_now[s.server_id] = s.drain_round(sn)
            queued_ids = {r.req_id for r in s.queue}
            for resp in served:
                self._inflight.pop(resp.req_id, None)
                self._account(resp)
                if self._slim_done:
                    self._slim(resp.req_id)
                responses.append(resp)
            if self.return_path and served:
                self._deliver(served)
            # A replica can reject a request that cannot fit even alone
            # (paper OOM 'X'): it leaves the queue with no response.
            # Filter this server's stale entries first, then sort just
            # those — same ids in the same order as sorting the whole
            # in-flight table, without the per-round full-table sort.
            sidx = s.server_id
            stale = [rid for rid, srv in self._inflight.items()
                     if srv == sidx and rid not in queued_ids]
            for rid in sorted(stale):
                del self._inflight[rid]
                if self._slim_done:
                    self._slim(rid)
                self.rejected.append(rid)
        # Controller tick on the now-idle fleet (lets scale-down and
        # demand-aware re-replication happen between traffic bursts, not
        # only under load — a burst served in one round still updates
        # placement for the next one).
        self._autoscale_step()
        self._retire_drained()
        self._re_replicate()
        return responses

    # -- burst return path -------------------------------------------------------
    def _return_port(self, tenant: int):
        """The tenant's NIC for pulling activations back (the same
        ``wan{tenant}`` fabric port its client would use; created at
        ``return_bandwidth`` — nominal by default — when the tenant has
        no client). None on fabric-less deployments."""
        port = self.return_ports.get(tenant)
        if port is None:
            fabric = self.fabric
            if fabric is None:
                return None
            port = fabric.ports.get(f"wan{tenant}")
            if port is None:
                bw = self.return_bandwidth
                if bw is None:
                    from repro_torch.config import HapiConfig

                    bw = HapiConfig().network_bandwidth
                port = fabric.tenant_port(tenant, bandwidth=bw)
            self.return_ports[tenant] = port
        return port

    def _deliver(self, responses: List[PostResponse]) -> None:
        """Charge one drain round's burst activations on the wire: the
        round's responses resolve as one ``transfer_concurrent`` batch
        (per-tenant NIC serialization + weighted WAN-trunk sharing), so
        serving sweeps are honest about the return direction too.
        Delivery overlaps the next round's serving — it extends each
        request's span and the tenant's finish time, not ``_vtime``."""
        flows = []
        resps = []
        for resp in responses:
            if resp.act_bytes <= 0:
                continue
            port = self._return_port(resp.tenant)
            if port is None:
                continue
            flows.append((port, resp.finished, resp.act_bytes))
            resps.append(resp)
        if not flows:
            return
        results = self.fabric.transfer_concurrent(flows)
        tr = self.sim.tracer
        mx = self.sim.metrics
        for resp, (start, end) in zip(resps, results):
            resp.delivered = end
            self.sim.record(end, "deliver",
                            f"t{resp.tenant} {resp.object_name} "
                            f"{resp.act_bytes:.3e}")
            tr.emit("wire.transfer", start, end, tier="network",
                    track=self.return_ports[resp.tenant].name,
                    parent=resp.span_id,
                    labels=(("tenant", str(resp.tenant)),
                            ("bytes", f"{resp.act_bytes:.0f}")))
            tr.extend(resp.span_id, end)
            mx.observe("stage_seconds", end - start, stage="wire")
            ts = self.tenant_stats.get(resp.tenant)
            if ts is not None and end > ts.last_finish:
                ts.last_finish = end

    def _account(self, resp: PostResponse) -> None:
        self._vtime = max(self._vtime, resp.finished)
        self.served_by_server[resp.server_id] = \
            self.served_by_server.get(resp.server_id, 0) + 1
        ts = self.tenant_stats.setdefault(resp.tenant, TenantStats())
        ts.posts += 1
        obj = self.store.objects.get(resp.object_name)
        ts.samples += obj.n_samples if obj is not None else 0
        ts.act_bytes += resp.act_bytes
        ts.first_arrival = min(ts.first_arrival, resp.arrival)
        ts.last_finish = max(ts.last_finish, resp.finished)
        self.placement.observe(resp)
        if self.scaling is not None:
            self.scaling.observe(resp)
        tr = self.sim.tracer
        tr.extend(resp.span_id, resp.finished)
        mx = self.sim.metrics
        mx.inc("responses_total", tenant=resp.tenant, server=resp.server_id)
        mx.observe("queue_delay_seconds", resp.queue_delay,
                   tenant=resp.tenant)
        # SLO burn: count responses whose queue delay exceeded the
        # scaling policy's target (the signal SloScaling reacts to).
        slo = getattr(self.scaling, "slo_delay", None)
        if slo is not None and resp.queue_delay > slo:
            mx.inc("slo_miss_total", tenant=resp.tenant)

    # -- metrics -----------------------------------------------------------------
    def makespan(self) -> float:
        return self._vtime

    def served_total(self) -> int:
        return sum(self.served_by_server.values())

    def scale_events(self) -> List[Tuple[float, str, str]]:
        return self.sim.log.filter_many(
            ("scale-up", "scale-down", "cordon", "kill", "restart"))

    def scale_event_count(self) -> int:
        """Total elasticity events without materializing the hit list
        (``EventLog.count`` — also correct under compact retention,
        where :meth:`scale_events` only sees the retained tail)."""
        log = self.sim.log
        return sum(log.count(k) for k in
                   ("scale-up", "scale-down", "cordon", "kill", "restart"))
