"""Compute-tier QoS scheduler: fleet-wide admission + dispatch subsystem.

A copy of ``repro/cos/scheduler.py`` over the port's ``core/batch_adapt.py``:
the same dispatch orders, Eq. 4 rounds and records, so a server of either
package serves the same batches at the same virtual times.

The scheduling logic of the storage tier used to live in three places —
:meth:`HapiFleet.dispatch` (per-tenant pending queues, round-robin),
:meth:`HapiServer.drain_round` (wait-window admission, Eq. 4 planning,
queue-order execution) and :func:`repro_torch.core.batch_adapt.adapt_batches`
(class-blind water-fill). This module centralizes it the way tf.data
service centralizes disaggregated input-processing scheduling behind one
dispatcher: a :class:`ComputeScheduler` owns

* **class-weighted dispatch** — pending POSTs sit in per-tenant queues
  and are released to replicas by a pluggable :class:`SchedulerPolicy`.
  The default, :class:`WdrrScheduling`, is weighted deficit round-robin
  keyed on each tenant's *compute weight* (``TenantSpec.compute_weight``,
  defaulting to its ``network_weight`` service class): a gold (weight 4)
  tenant's backlog is released 4x as fast as a bronze (weight 1)
  tenant's while both are backlogged. All-equal weights reduce *exactly*
  to the historical round-robin (property-tested), so default fleets
  reproduce their event logs byte-for-byte. :class:`FifoScheduling` is
  the historical ``fair_queueing=False`` arrival-order path.

* **class-aware Eq. 4 admission** — each server round's batch
  adaptation receives the requests' compute weights
  (:class:`~repro_torch.core.batch_adapt.AdaptRequest.weight`), so when
  accelerator HBM — not the wire — is the bottleneck, gold tenants keep
  proportionally larger COS batches and bronze requests are the first
  dropped to the next round. Weight-1 requests are bitwise the classic
  fill.

* **cross-server batch coalescing** (``coalescing=True``, default off)
  — the paper's servers are stateless: every request is charged a full
  model (re)load. But a replica whose accelerator holds an *active
  lease* for a model effectively has that model resident until the
  lease expires. Each fleet scheduling round the coalescer ships queued
  requests for a model to a replica that already holds it loaded, and
  warm-hit executions skip the reload charge — cutting the aggregate
  stateless-reload bytes without giving up statelessness (the lease is
  still bounded; an expired lease means a full reload, and crash
  recovery is unchanged). Admission on the receiving replica re-runs
  Eq. 4 against *its* HBM budget, so coalescing can never violate the
  no-OOM invariant (regression-tested).

The scheduler is shared by a fleet and all of its replicas (bare
servers own a private one), so per-tenant state — queues, deficits,
weights — is fleet-wide, exactly like HyperTune's dynamic per-worker
batch allocation across heterogeneous executors.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import (TYPE_CHECKING, Deque, Dict, List, Optional, Protocol,
                    Tuple, runtime_checkable)

from repro_torch.core.batch_adapt import AdaptRequest
from repro_torch.cos.weightcache import WeightCache

if TYPE_CHECKING:  # server/fleet import this module; never import them back
    from repro_torch.cos.fleet import HapiFleet
    from repro_torch.cos.server import HapiServer, PostRequest, PostResponse


def windowed_accel_share(
    responses: List["PostResponse"], n_tenants: int,
) -> Tuple[List[float], List[int], float]:
    """Per-tenant accelerator time over the *contended window* — until
    the first tenant's backlog drains, i.e. while every class is still
    backlogged and the scheduler's weights (not demand) set the shares.
    The QoS measurement behind the JAX package's
    ``benchmarks/qos_compute.py`` and the scheduler tests. Returns ``(busy_seconds, served_counts, window_end)``
    with per-response busy intervals clipped to the window. Only tenants
    ``0..n_tenants-1`` are measured (a shared fleet's other traffic is
    ignored); every measured tenant must have at least one response or
    there is no contended window to report."""
    last: Dict[int, float] = {}
    for r in responses:
        if 0 <= r.tenant < n_tenants:
            last[r.tenant] = max(last.get(r.tenant, 0.0), r.finished)
    missing = [t for t in range(n_tenants) if t not in last]
    if missing:
        raise ValueError(
            f"no responses for tenant(s) {missing}: every measured class "
            f"needs served work to define the contended window (were its "
            f"requests all rejected?)")
    end = min(last.values())
    busy = [0.0] * n_tenants
    served = [0] * n_tenants
    for r in responses:
        if not 0 <= r.tenant < n_tenants:
            continue
        busy[r.tenant] += max(0.0, min(r.finished, end) - min(r.started, end))
        if r.finished <= end:
            served[r.tenant] += 1
    return busy, served, end


# ---------------------------------------------------------------------------
# Dispatch-order policies
# ---------------------------------------------------------------------------
@runtime_checkable
class SchedulerPolicy(Protocol):
    """Orders the fleet's pending POSTs for dispatch onto replicas.

    ``fair`` tells tenant-spreading routers whether the policy
    interleaves tenants (the old ``HapiFleet.fair_queueing`` boolean,
    kept readable as a fleet property). Must be deterministic."""

    name: str
    fair: bool

    def order(self, pending: Dict[int, Deque["PostRequest"]],
              weights: Dict[int, float]) -> List["PostRequest"]:
        """Consume every queued request and return dispatch order."""
        ...


@dataclass
class WdrrScheduling:
    """Weighted deficit round-robin across tenant queues.

    Each pass credits tenant *t* with ``quantum = weight_t / max_weight``
    and releases a request per whole unit of accumulated deficit, so
    release rates are weight-proportional while tenants are backlogged.
    With all-equal weights every pass releases exactly one request per
    tenant in sorted tenant order — *identical* to the historical
    round-robin dispatch, which is what keeps default fleets
    byte-compatible (asserted by tests/test_scheduler.py, and for the port
    by tests/test_torch_runtime.py). Deficits are per-``order`` call: a
    drained queue carries no credit into the next burst (standard DRR
    resets deficit on empty)."""

    name: str = "wdrr"
    fair: bool = True

    def order(self, pending: Dict[int, Deque["PostRequest"]],
              weights: Dict[int, float]) -> List["PostRequest"]:
        out: List["PostRequest"] = []
        deficit: Dict[int, float] = {t: 0.0 for t in pending}
        w_max = max((weights.get(t, 1.0) for t, q in pending.items() if q),
                    default=1.0)
        while any(pending.values()):
            # Tail shortcut: once every backlogged tenant has the same
            # weight, DRR releases exactly one per tenant per pass —
            # plain round-robin — so drain directly instead of paying up
            # to w_max/w quantum-accumulation passes per release (the
            # low-weight tail after a 1024:1 gold queue empties).
            live = {weights.get(t, 1.0) for t, q in pending.items() if q}
            if len(live) == 1:
                while any(pending.values()):
                    for tenant in sorted(pending):
                        q = pending[tenant]
                        if q:
                            out.append(q.popleft())
                break
            for tenant in sorted(pending):
                q = pending[tenant]
                if not q:
                    deficit[tenant] = 0.0
                    continue
                # Quantum floor: a non-positive or vanishing weight must
                # still make progress (starvation-free; ratios are
                # honored up to 1024:1).
                deficit[tenant] += max(weights.get(tenant, 1.0) / w_max,
                                       1.0 / 1024.0)
                # Guard against float creep: one whole unit releases one
                # request; 0.25 + 0.25 + 0.25 + 0.25 must release too.
                while q and deficit[tenant] >= 1.0 - 1e-9:
                    deficit[tenant] -= 1.0
                    out.append(q.popleft())
        return out


@dataclass
class FifoScheduling:
    """Arrival-order dispatch — the historical ``fair_queueing=False``
    path: one tenant's deep backlog runs ahead of later submitters."""

    name: str = "fifo"
    fair: bool = False

    def order(self, pending: Dict[int, Deque["PostRequest"]],
              weights: Dict[int, float]) -> List["PostRequest"]:
        out = sorted((r for q in pending.values() for r in q),
                     key=lambda r: (r.arrival, r.req_id))
        for q in pending.values():
            q.clear()
        return out


# ---------------------------------------------------------------------------
# The scheduler subsystem
# ---------------------------------------------------------------------------
class ComputeScheduler:
    """Fleet-wide admission/dispatch scheduler (see module docstring).

    One instance is shared by a :class:`~repro_torch.cos.fleet.HapiFleet` and
    every replica it owns; a bare :class:`~repro_torch.cos.server.HapiServer`
    builds a private one. Holds the per-tenant pending queues, the
    tenant compute-weight table, the dispatch policy and the coalescing
    switch; the per-server admission round (:meth:`server_round`) is
    the code that used to be ``HapiServer.drain_round``.
    """

    def __init__(self, policy: Optional[SchedulerPolicy] = None, *,
                 coalescing: bool = False,
                 cache: Optional[WeightCache] = None) -> None:
        self.policy: SchedulerPolicy = policy if policy is not None \
            else WdrrScheduling()
        self.coalescing = coalescing
        # Fleet-wide warm-weight cache (None — the default — leaves every
        # code path byte-identical to the cache-less scheduler; asserted
        # against the golden digests).
        self.cache = cache
        self.pending: Dict[int, Deque["PostRequest"]] = {}
        # Running size of all pending queues: at fleet scale the tenant
        # dict holds thousands of (mostly drained) deques, so the
        # per-round emptiness probes must not walk it.
        self._npending = 0
        self.weights: Dict[int, float] = {}
        # Stateless-reload accounting (charged vs skipped-by-warm-lease):
        # the coalescing benchmark compares `reload_bytes` across runs.
        self.reload_bytes = 0.0
        self.reload_saved_bytes = 0.0
        self.coalesced = 0

    # -- tenant service classes ------------------------------------------------
    def set_weight(self, tenant: int, weight: float) -> None:
        """Pin a tenant's compute weight (service class). Un-pinned
        tenants fall back to the weight their queued requests carry."""
        if weight <= 0:
            raise ValueError(f"compute weight must be > 0, got {weight}")
        self.weights[tenant] = float(weight)

    def weight_of(self, tenant: int) -> float:
        w = self.weights.get(tenant)
        if w is not None:
            return w
        q = self.pending.get(tenant)
        return q[0].compute_weight if q else 1.0

    # -- pending queues --------------------------------------------------------
    def enqueue(self, req: "PostRequest") -> None:
        self.pending.setdefault(req.tenant, deque()).append(req)
        self._npending += 1

    def pending_total(self) -> int:
        return self._npending

    def has_pending(self) -> bool:
        return self._npending > 0

    # -- dispatch --------------------------------------------------------------
    def dispatch(self, fleet: "HapiFleet") -> int:
        """Release every pending request onto replicas in policy order;
        returns #dispatched. (Routing still picks the replica — the
        scheduler decides *when* each tenant's work is released, which
        is what sets the service order on every contended queue.)"""
        if not self.has_pending():
            return 0
        weights = {t: self.weight_of(t) for t in self.pending}
        ordered = self.policy.order(self.pending, weights)
        # Every policy's order() consumes the queues it returns from.
        self._npending -= len(ordered)
        n = 0
        # One routable-set snapshot for the whole round: dispatching
        # never changes topology, and rebuilding the list per request
        # is O(requests x servers) at fleet scale.
        alive = fleet._routable()
        for i, req in enumerate(ordered):
            try:
                n += fleet._dispatch_one(req, alive)
            except Exception:
                # Routing failed (e.g. the whole fleet is down): the
                # policy already consumed the queues, so put this and
                # every not-yet-dispatched request back — they must
                # survive for the retry after a restart, exactly like
                # queued-on-replica requests survive via re-issue.
                for rest in ordered[i:]:
                    self.enqueue(rest)
                raise
        return n

    # -- cross-server batch coalescing ----------------------------------------
    def _warm(self, server: "HapiServer", req: "PostRequest",
              accel_idx: Optional[int] = None) -> bool:
        """True if ``server`` holds an active lease covering the
        request's model prefix (same model, split at least as deep) —
        i.e. the weights the request needs are already in HBM. O(leases
        for this model) via the server's lease index, not O(all leases):
        the coalescer calls this per queued request per drain round."""
        return any(
            lease.split >= req.split
            and (accel_idx is None or lease.accel == accel_idx)
            for lease in server.warm_leases(req.model_key)
        )

    def _warm_accel(self, server: "HapiServer", req: "PostRequest",
                    accel_idx: int) -> bool:
        """Per-accelerator warmth: an active lease or a warm-weight
        cache entry holds the model resident on that accelerator."""
        if self._warm(server, req, accel_idx):
            return True
        return self.cache is not None and self.cache.covers(
            server.server_id, accel_idx, req.model_key, req.split)

    def warm_replica(self, server: "HapiServer",
                     req: "PostRequest") -> bool:
        """Routing/coalescing signal: is the request's model resident
        anywhere on this replica — active lease or cache entry?"""
        if self.cache is not None and self.cache.is_warm_server(
                server.server_id, req.model_key, req.split):
            return True
        return self._warm(server, req)

    def coalesce(self, fleet: "HapiFleet") -> int:
        """One coalescing pass: ship queued requests whose model is cold
        on their current replica to a routable replica already holding
        it loaded. The receiving replica re-runs Eq. 4 admission against
        its own HBM budget, so the move can never overcommit it.

        A move must be a latency win too, not just a reload win: the
        receiver's accelerator must be free *no later* than the
        sender's (replicas run in parallel on the virtual clock, so
        shipping work to a busier-but-warm replica would serialize the
        fleet for microseconds of reload savings), and the move may not
        leave the receiver's queue deeper than the sender's. Warm-lease
        reload savings on a replica's *own* queue need no move at all —
        they come from the warm-accelerator assignment in
        :meth:`server_round`. Returns #moved.

        With the warm-weight cache enabled the pass runs even when
        ``coalescing`` is off and also recognizes cache residency as
        warmth — the cache's stated fallback for requests the router
        placed cold (races against entries created after routing)."""
        if not self.coalescing and self.cache is None:
            return 0
        routable = fleet._routable()
        if len(routable) < 2:
            return 0

        def avail(s):
            return min(a.busy_until for a in s.accels)

        moved = 0
        for src in sorted(routable, key=lambda s: s.server_id):
            for req in list(src.queue):
                if self.warm_replica(src, req):
                    continue
                targets = [s for s in routable
                           if s is not src and self.warm_replica(s, req)
                           and s.queue_depth() + 1 <= src.queue_depth()
                           and avail(s) <= avail(src)]
                if not targets:
                    continue
                dst = min(targets, key=lambda s: (s.queue_depth(),
                                                  s.server_id))
                src.queue.remove(req)
                dst.submit(req)
                fleet._inflight[req.req_id] = dst.server_id
                self.coalesced += 1
                moved += 1
                fleet.sim.record(
                    fleet._vtime, "coalesce",
                    f"t{req.tenant} {req.object_name} "
                    f"s{src.server_id} -> s{dst.server_id}")
                mx = fleet.sim.metrics
                mx.inc("coalesce_total", tenant=req.tenant)
        return moved

    # -- per-server admission round -------------------------------------------
    def server_round(self, server: "HapiServer",
                     now: float = 0.0) -> Tuple[List["PostResponse"], float]:
        """One coalescing-window + batch-adaptation scheduling round for
        ``server`` (the code that was ``HapiServer.drain_round``).

        Returns ``(responses, next_now)``. The fleet steps replicas one
        round at a time so control events (kills, restarts, autoscaling)
        interleave with serving in deterministic event order; a bare
        server just loops this inside :meth:`HapiServer.drain`.
        """
        if not server.queue or not server.alive:
            return [], now
        responses: List["PostResponse"] = []
        t = max(now, min(r.arrival for r in server.queue)) + \
            server.wait_window
        server._free_expired(t)
        if self.cache is not None:
            # Expired leases above may have transferred model bytes into
            # the cache; now drop entries idle past the keep-warm window
            # and publish the replica's resident footprint.
            self.cache.expire(server, t)
            if server.sim is not None:
                mx = server.sim.metrics
                mx.gauge_set("cache_resident_bytes",
                             self.cache.resident_bytes(server.server_id),
                             server=server.server_id)
        arrived = [r for r in server.queue if r.arrival <= t]
        if not arrived:
            return [], min(r.arrival for r in server.queue)

        # Distribute evenly over accelerators (paper §5.5), adapt per
        # accel with the requests' service-class weights: when HBM is
        # scarce, gold keeps larger COS batches and bronze defers first.
        # Under coalescing, a request whose model is already warm on one
        # of this server's accelerators goes there instead of round-robin
        # — residency is per-accelerator HBM, so a blind assignment would
        # squander the warm lease the request was shipped here for.
        per_accel: Dict[int, List["PostRequest"]] = {}
        for r in arrived:
            if self.coalescing or self.cache is not None:
                warm_ais = [i for i in range(len(server.accels))
                            if self._warm_accel(server, r, i)]
                if warm_ais:
                    per_accel.setdefault(warm_ais[0], []).append(r)
                    continue
            idx = server._rr % len(server.accels)
            server._rr += 1
            per_accel.setdefault(idx, []).append(r)

        progressed = False
        planned = []            # (queue_position, req, batch, mem, accel)
        pos = {r.req_id: i for i, r in enumerate(arrived)}
        covered_ids: set = set()   # requests admitted on a cache entry
        for ai, reqs in per_accel.items():
            accel = server.accels[ai]
            # Warm-weight cache: a request whose model is cache-resident
            # on this accelerator is admitted with mem_model = 0 — the
            # bytes are already charged (once) by the entry, so Eq. 4
            # sees hbm_free = capacity - activations - warm_weights and
            # never double-counts the prefix.
            covered = {
                r.req_id for r in reqs
                if self.cache is not None and self.cache.covers(
                    server.server_id, ai, r.model_key, r.split)
            }
            covered_ids |= covered
            if self.cache is not None:
                # Release warm bytes under pressure *before* Eq. 4 would
                # shrink batches: if the round's full demand exceeds the
                # free budget, evict idle entries (never ones pinned by
                # leases or needed by this round) until it fits.
                want = sum(
                    (0.0 if r.req_id in covered
                     else r.profile.prefix_param_bytes[r.split])
                    + r.b_max * server._mem_per_sample(r)
                    for r in reqs)
                free = accel.hbm - accel.mem_used
                if want > free:
                    self.cache.release(server, ai, want - free, t,
                                       keep={r.model_key for r in reqs})
            budget = accel.hbm - accel.mem_used
            adapt_reqs = [
                AdaptRequest(
                    req_id=r.req_id,
                    mem_per_sample=server._mem_per_sample(r),
                    mem_model=0.0 if r.req_id in covered
                    else r.profile.prefix_param_bytes[r.split],
                    b_max=r.b_max,
                    b_min_override=0 if r.adaptable else r.b_max,
                    weight=r.compute_weight,
                )
                for r in reqs
            ]
            res = server.adapt(adapt_reqs, budget)
            by_id = {r.req_id: r for r in reqs}
            for a in res.assignments:
                req = by_id[a.req_id]
                planned.append((pos[req.req_id], req, a.batch, a.mem, ai))
            # dropped requests stay queued for the next round
        # Execute in queue order (not accelerator-major): admitted requests
        # hit the shared storage nodes in their arrival interleaving, so one
        # accelerator's batch cannot monopolize the read path.
        ordered = sorted(planned, key=lambda p: p[0])
        if server.sim is not None and arrived:
            # One admission span per scheduling round: the wait window plus
            # the Eq. 4 plan, labelled with admitted/deferred counts.
            tr = server.sim.tracer
            tr.emit("admission", t - server.wait_window, t, tier="compute",
                    track=f"s{server.server_id}",
                    labels=(("admitted", str(len(ordered))),
                            ("deferred", str(len(arrived) - len(ordered)))))
        # Batch window: the round's storage reads resolve as one
        # transfer_concurrent batch (weighted by tenant class) whenever
        # they would actually share a storage link; read_batch returns
        # None otherwise and each request reads on its own, exactly as
        # before.
        reads = server.store.read_batch(
            [p[1].object_name for p in ordered], t,
            [p[1].network_weight for p in ordered],
            parents=[p[1].span_id for p in ordered]) if len(ordered) > 1 \
            else None
        for i, (_, req, batch, mem, ai) in enumerate(ordered):
            # Warm hit: the model prefix is already resident on this
            # accelerator — via an active lease (coalescing) or a
            # warm-weight cache entry — so the stateless reload charge
            # is skipped. Cache hits were admitted with mem_model = 0
            # (the entry holds the charge); lease hits keep the
            # conservative double-charge the coalescer always had.
            nbytes = req.profile.prefix_param_bytes[req.split]
            cache_hit = req.req_id in covered_ids
            warm = cache_hit or (
                (self.coalescing or self.cache is not None)
                and self._warm(server, req, ai))
            mx = server.sim.metrics if server.sim is not None else None
            if warm:
                self.reload_saved_bytes += nbytes
                if cache_hit:
                    self.cache.touch(server.server_id, ai, req.model_key, t)
                if server.sim is not None:
                    server.sim.record(t, "warm-hit",
                                      f"s{server.server_id} t{req.tenant} "
                                      f"{req.object_name}")
                if mx is not None:
                    mx.inc("warm_hit_total", tenant=req.tenant,
                           model=req.model_key)
                    mx.inc("reload_saved_bytes_total", nbytes,
                           server=server.server_id, model=req.model_key)
            else:
                self.reload_bytes += nbytes
                if mx is not None:
                    mx.inc("reload_bytes_total", nbytes,
                           server=server.server_id, model=req.model_key)
            resp = server._execute(req, batch, mem, ai, t,
                                   pre_read=reads[i] if reads else None,
                                   charge_load=not warm,
                                   model_bytes=0.0 if cache_hit
                                   or self.cache is None else nbytes)
            if cache_hit:
                # The lease rides the entry: pin it so pressure eviction
                # cannot pull the weights out from under the admitted
                # batch; expiry unpins (see WeightCache.on_lease_expired).
                self.cache.pin(server.server_id, ai, req.model_key)
            responses.append(resp)
            server.queue.remove(req)
            progressed = True

        if not progressed:
            # Nothing fit: wait for the earliest lease to expire.
            if server.leases:
                now = min(l.end for l in server.leases)
            else:  # pathological: shrink by dropping the newest request
                victim = max(arrived, key=lambda r: r.arrival)
                server.queue.remove(victim)
                server.log.add(t, "reject", victim.object_name)
                if server.sim is not None:
                    server.sim.record(t, "reject",
                                      f"s{server.server_id} "
                                      f"{victim.object_name}")
        return responses, now
