"""Pluggable fleet policies: routing, placement, scaling.

A copy of ``repro/api/policies.py``: the same decisions from the same
state, so a fleet of either package routes, places and scales alike.

The fleet's control decisions used to be hard-coded inside
:mod:`repro_torch.cos.fleet`. They are now three small strategy protocols —
the shape the disaggregation literature converges on (tf.data service's
disaggregated input processing, bring-your-own-model storage placement):
one service facade, swappable policy modules behind it.

* :class:`RoutingPolicy` — which alive replica serves a POST.
* :class:`PlacementPolicy` — which storage nodes hold an object's
  replicas, both at ``put_dataset`` time and (for demand-aware policies)
  as re-replication while the fleet runs.
* :class:`ScalingPolicy` — when the fleet grows or shrinks.
* :class:`~repro_torch.cos.scheduler.SchedulerPolicy` — the compute-tier
  dispatch order (weighted deficit round-robin vs FIFO); defined with
  the :class:`~repro_torch.cos.scheduler.ComputeScheduler` subsystem and
  re-exported here with its registry.

Every policy must be **deterministic**: decisions may depend only on
fleet/store state reachable from the arguments (queue depths, demand
counters, the event log), never on wall-clock time or unseeded
randomness. The cross-policy determinism test asserts that the same seed
reproduces a byte-identical event log under any policy combination.

Policies hold their own mutable state (demand counters, cooldowns) and
are therefore owned by exactly one fleet; reusing an instance across
fleets leaks state between runs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import (Dict, List, Optional, Protocol, Tuple, TYPE_CHECKING,
                    runtime_checkable)

from repro_torch.cos.scheduler import (
    ComputeScheduler,
    FifoScheduling,
    SchedulerPolicy,
    WdrrScheduling,
)

if TYPE_CHECKING:  # avoid import cycle: fleet imports this module
    from repro_torch.cos.fleet import HapiFleet
    from repro_torch.cos.objectstore import ObjectStore
    from repro_torch.cos.server import HapiServer, PostRequest, PostResponse


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------
@runtime_checkable
class RoutingPolicy(Protocol):
    """Chooses the replica that serves a POST request."""

    name: str

    def route(self, fleet: "HapiFleet", req: "PostRequest",
              alive: List["HapiServer"]) -> "HapiServer":
        """Pick one of ``alive`` (non-empty). Must be deterministic."""
        ...


@dataclass
class ReplicaAwareRouting:
    """The fleet's historical default: prefer replicas co-located with a
    storage node holding the object (server *i* sits next to storage node
    ``i % n_nodes``, Swift-style); among candidates pick the least-loaded,
    spreading each tenant across replicas under fair queueing."""

    name: str = "replica-aware"

    def _candidates(self, fleet: "HapiFleet", req: "PostRequest",
                    alive: List["HapiServer"]) -> List["HapiServer"]:
        n_nodes = len(fleet.store.nodes)
        replicas = set(fleet.store.replicas(req.object_name))
        colocated = [s for s in alive if s.server_id % n_nodes in replicas]
        return colocated or alive

    def _load(self, fleet: "HapiFleet", req: "PostRequest",
              s: "HapiServer") -> tuple:
        # Least-loaded with tenant spreading: under fair queueing, prefer
        # the replica holding the fewest of this tenant's requests so every
        # replica's queue interleaves tenants (one tenant must not own a
        # whole replica while sharing the storage tier); then queue depth,
        # earliest accelerator availability, id.
        tenant_here = (s.tenant_queue_depth(req.tenant)
                       if fleet.fair_queueing else 0)
        return (tenant_here, s.queue_depth(),
                min(a.busy_until for a in s.accels), s.server_id)

    def route(self, fleet: "HapiFleet", req: "PostRequest",
              alive: List["HapiServer"]) -> "HapiServer":
        return min(self._candidates(fleet, req, alive),
                   key=lambda s: self._load(fleet, req, s))


@dataclass
class LeastLoadedRouting:
    """Pure least-loaded: ignore replica locality entirely and send every
    POST to the shallowest queue. The right policy when the storage tier's
    internal network is fast enough that co-location stops mattering."""

    name: str = "least-loaded"

    def route(self, fleet: "HapiFleet", req: "PostRequest",
              alive: List["HapiServer"]) -> "HapiServer":
        return min(alive, key=lambda s: (
            s.queue_depth(), min(a.busy_until for a in s.accels), s.server_id))


@dataclass
class HashRouting:
    """Stateless O(1) routing for scale-out sweeps: request id modulo the
    alive-replica count. No queue scans, no locality — every replica gets
    a uniform slice of the stream, which is exactly what a 100s-of-replicas
    throughput experiment wants when routing overhead (not placement
    quality) is the variable under study."""

    name: str = "hash"

    def route(self, fleet: "HapiFleet", req: "PostRequest",
              alive: List["HapiServer"]) -> "HapiServer":
        return alive[req.req_id % len(alive)]


@dataclass
class WarmAwareRouting(ReplicaAwareRouting):
    """Warmth-first routing for the fleet-wide weight cache: send a
    request to a replica *because* its model is already resident there —
    active lease or cache entry (``ComputeScheduler.warm_replica``) —
    instead of letting locality pick a cold replica and the coalescer
    fix it up with an after-the-fact extra hop.

    A warm replica is only taken when it isn't materially busier than
    the best cold candidate: its queue may run at most ``depth_slack``
    deeper than the shallowest alive queue, and an accelerator there
    must be free no later than ``busy_slack`` seconds after the idlest
    replica fleet-wide could start the request — otherwise chasing
    warmth would trade reload bytes for queueing delay (the benchmark's
    p99 guardrail). Among warm candidates the usual least-loaded order
    decides; with no acceptable warm replica the policy degrades to
    plain replica-aware routing, and the coalescer remains the fallback
    for requests that went cold anyway (races with entries created
    after routing)."""

    name: str = "warm"
    depth_slack: int = 2
    busy_slack: float = 0.0

    def route(self, fleet: "HapiFleet", req: "PostRequest",
              alive: List["HapiServer"]) -> "HapiServer":
        sched = fleet.scheduler
        warm = [s for s in alive if sched.warm_replica(s, req)]
        if warm:
            floor = min(s.queue_depth() for s in alive)
            free_at = min(min(a.busy_until for a in s.accels)
                          for s in alive)
            horizon = max(req.arrival, free_at) + self.busy_slack
            ok = [s for s in warm
                  if s.queue_depth() <= floor + self.depth_slack
                  and min(a.busy_until for a in s.accels) <= horizon]
            if ok:
                return min(ok, key=lambda s: self._load(fleet, req, s))
        return super().route(fleet, req, alive)


@dataclass
class FabricAwareRouting(ReplicaAwareRouting):
    """Replica-aware routing that also watches the storage network
    (ROADMAP: fold fabric state into routing): among the co-located
    candidates, prefer replicas whose storage ingress link is *idle* at
    the request's arrival — a replica behind a still-draining storage
    link will wait on its reads no matter how shallow its queue is. The
    ingress timeline exists on every deployment (fabric port or private
    Link), so the policy works either way; it only differs from plain
    replica-aware when some ingress actually has a backlog."""

    name: str = "fabric-aware"

    def _load(self, fleet: "HapiFleet", req: "PostRequest",
              s: "HapiServer") -> tuple:
        ingress = fleet.store.nodes[s.server_id % len(fleet.store.nodes)]
        return (ingress.busy_until > req.arrival,) + \
            super()._load(fleet, req, s)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------
@runtime_checkable
class PlacementPolicy(Protocol):
    """Decides which storage nodes hold an object's replicas."""

    name: str

    def initial(self, index: int, n_nodes: int, replication: int) -> List[int]:
        """Node indices for object #``index`` of a dataset at put time."""
        ...

    def observe(self, resp: "PostResponse") -> None:
        """Called for every served POST (demand signal)."""
        ...

    def rebalance(self, fleet: "HapiFleet") -> List[Tuple[str, int]]:
        """Extra ``(object_name, node)`` replicas to create now. Called
        once per fleet scheduling round — must be cheap when idle."""
        ...


@dataclass
class RoundRobinPlacement:
    """The historical default: object *i*'s replicas land on nodes
    ``(i + r) % n_nodes`` — static, demand-blind, never re-replicates."""

    name: str = "round-robin"

    def initial(self, index: int, n_nodes: int, replication: int) -> List[int]:
        return [(index + r) % n_nodes for r in range(replication)]

    def observe(self, resp: "PostResponse") -> None:
        pass

    def rebalance(self, fleet: "HapiFleet") -> List[Tuple[str, int]]:
        return []


@dataclass
class DemandAwarePlacement:
    """Demand-aware re-replication (ROADMAP: richer placement signals):
    start round-robin, track per-object demand, and when asked to
    rebalance add replicas for the hottest under-replicated objects on
    the least-subscribed nodes — and *drop* the replicas this policy
    created once their object's demand has gone cold.

    Demand signal: each served POST contributes the bytes it served
    (``act_bytes / byte_unit`` demand points) and the whole table decays
    with a virtual-time half-life, so a burst of tiny objects cannot
    outweigh a steady stream of large ones and yesterday's hot object
    does not stay over-replicated forever. The original raw POST-count
    behavior — no byte weighting, no decay, no cold-drop — is the
    documented default-off path::

        DemandAwarePlacement(weight_by_bytes=False,
                             half_life=float("inf"), cold_threshold=0.0)

    ``max_new_per_round`` bounds churn per rebalance call;
    ``hot_threshold`` is the minimum demand before an object is worth
    another copy (cold data never spreads); ``cold_threshold`` is where
    a policy-added replica is dropped again (keep it below
    ``hot_threshold`` for hysteresis)."""

    name: str = "demand-aware"
    max_new_per_round: int = 8
    hot_threshold: float = 2
    weight_by_bytes: bool = True      # False = legacy raw POST counting
    byte_unit: float = 1e6            # bytes served per demand point
    half_life: float = 5.0            # virtual secs to halve; inf = no decay
    cold_threshold: float = 0.5       # policy-added replicas drop below this
    demand: Dict[str, float] = field(default_factory=dict)
    _added: List[Tuple[str, int]] = field(default_factory=list)
    _decayed_at: float = 0.0

    def initial(self, index: int, n_nodes: int, replication: int) -> List[int]:
        return [(index + r) % n_nodes for r in range(replication)]

    def observe(self, resp: "PostResponse") -> None:
        inc = resp.act_bytes / self.byte_unit if self.weight_by_bytes else 1.0
        self.demand[resp.object_name] = \
            self.demand.get(resp.object_name, 0.0) + inc

    def _decay_to(self, now: float) -> None:
        """Exponential recency decay on the fleet's virtual clock —
        deterministic because virtual time is."""
        if now <= self._decayed_at:
            return
        if self.half_life != float("inf"):
            f = 0.5 ** ((now - self._decayed_at) / self.half_life)
            for k in self.demand:
                self.demand[k] *= f
        self._decayed_at = now

    def _drop_cold(self, fleet: "HapiFleet") -> None:
        """Remove replicas this policy added whose demand has decayed
        below ``cold_threshold`` (never the object's last replica —
        the store refuses that)."""
        if not self.cold_threshold or not self._added:
            return
        kept: List[Tuple[str, int]] = []
        for oname, node in self._added:
            if self.demand.get(oname, 0.0) < self.cold_threshold:
                fleet.store.remove_replica(oname, node, t=fleet._vtime)
            else:
                kept.append((oname, node))
        self._added = kept

    def rebalance(self, fleet: "HapiFleet") -> List[Tuple[str, int]]:
        self._decay_to(fleet._vtime)
        self._drop_cold(fleet)
        # Called every scheduling round: bail out before building the
        # node-subscription map unless something is actually hot.
        if not any(c >= self.hot_threshold for c in self.demand.values()):
            return []
        store = fleet.store
        n_nodes = len(store.nodes)
        # Node subscription = how many objects each node already holds.
        holds = [0] * n_nodes
        for oname in store.objects:
            for node in store.replicas(oname):
                holds[node] += 1
        # Hottest first; ties broken by name for determinism.
        hot = sorted(self.demand.items(), key=lambda kv: (-kv[1], kv[0]))
        new: List[Tuple[str, int]] = []
        for oname, count in hot:
            if len(new) >= self.max_new_per_round:
                break
            if count < self.hot_threshold:
                break
            have = set(store.replicas(oname))
            missing = [n for n in range(n_nodes) if n not in have]
            if not missing:
                continue
            target = min(missing, key=lambda n: (holds[n], n))
            holds[target] += 1
            new.append((oname, target))
        self._added.extend(new)
        return new


def learned_features(demand: float, wdemand: float,
                     recency: float) -> Tuple[float, float, float]:
    """The learned-placement feature vector for one object at decision
    time: log-compressed decayed demand points, recency in (0, 1], and
    log-compressed class-weighted demand. One function shared by
    inference here and offline training in :mod:`repro_torch.replay.learned`,
    so the two can never drift apart."""
    return (math.log1p(demand), recency, math.log1p(wdemand))


@dataclass
class LearnedPlacement:
    """Placement driven by a model trained offline on replayed traces
    (:func:`repro_torch.replay.learned.train_placement_model`).

    Same actuation as :class:`DemandAwarePlacement` — add replicas for
    hot objects on the least-subscribed nodes, drop policy-added
    replicas that went cold — but the hot/cold decision is a learned
    *prediction of next-window demand* instead of a decayed counter
    against a hand-picked threshold. The demand signal per object is
    three features (see :func:`learned_features`) over a window-scale
    half-life; the model is a linear head ``bias + w . (f - mean)/std``
    predicting ``log1p`` of the object's demand points over the next
    window. Longer windows than DemandAware's 5 s half-life make the
    estimate stable on diurnal, heavy-tailed traffic: the Zipf head and
    mid-tail stay replicated through rate troughs instead of flapping
    around the threshold (the p99 win the JAX package's
    ``benchmarks/replay_policy_search.py`` measures).

    Inference is stdlib-only (no torch at decision time) and fully
    deterministic; the untrained defaults reduce to a sane heuristic —
    score ~ log demand plus a recency nudge — so the policy is usable
    straight from the registry (``PLACEMENT_POLICIES["learned"]``)."""

    name: str = "learned"
    max_new_per_round: int = 8
    window: float = 300.0             # virtual secs: decay half-life + horizon
    byte_unit: float = 1e6            # bytes served per demand point
    hot_score: float = 1.5            # predicted log1p points to add a copy
    cold_score: float = 0.75          # policy-added replicas drop below this
    weights: Tuple[float, float, float] = (1.0, 0.2, 0.0)
    bias: float = 0.0
    feature_mean: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    feature_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    demand: Dict[str, float] = field(default_factory=dict)
    wdemand: Dict[str, float] = field(default_factory=dict)
    last_seen: Dict[str, float] = field(default_factory=dict)
    _added: List[Tuple[str, int]] = field(default_factory=list)
    _decayed_at: float = 0.0

    def initial(self, index: int, n_nodes: int, replication: int) -> List[int]:
        return [(index + r) % n_nodes for r in range(replication)]

    def observe(self, resp: "PostResponse") -> None:
        inc = resp.act_bytes / self.byte_unit
        o = resp.object_name
        self.demand[o] = self.demand.get(o, 0.0) + inc
        self.wdemand[o] = self.wdemand.get(o, 0.0) + \
            inc * getattr(resp, "compute_weight", 1.0)
        self.last_seen[o] = resp.finished

    def _decay_to(self, now: float) -> None:
        if now <= self._decayed_at:
            return
        f = 0.5 ** ((now - self._decayed_at) / self.window)
        for k in self.demand:
            self.demand[k] *= f
            self.wdemand[k] *= f
        self._decayed_at = now

    def score(self, oname: str, now: float) -> float:
        """Predicted ``log1p`` demand points over the next window."""
        seen = self.last_seen.get(oname)
        recency = 0.5 ** ((now - seen) / self.window) if seen is not None \
            else 0.0
        f = learned_features(self.demand.get(oname, 0.0),
                             self.wdemand.get(oname, 0.0), recency)
        s = self.bias
        for fi, wi, mi, sdi in zip(f, self.weights, self.feature_mean,
                                   self.feature_std):
            s += wi * (fi - mi) / (sdi if sdi else 1.0)
        return s

    def _drop_cold(self, fleet: "HapiFleet") -> None:
        if not self._added:
            return
        now = fleet._vtime
        kept: List[Tuple[str, int]] = []
        for oname, node in self._added:
            if self.score(oname, now) < self.cold_score:
                fleet.store.remove_replica(oname, node, t=now)
            else:
                kept.append((oname, node))
        self._added = kept

    def rebalance(self, fleet: "HapiFleet") -> List[Tuple[str, int]]:
        self._decay_to(fleet._vtime)
        self._drop_cold(fleet)
        now = fleet._vtime
        scored = [(self.score(o, now), o) for o in self.demand]
        if not any(s >= self.hot_score for s, _ in scored):
            return []
        store = fleet.store
        n_nodes = len(store.nodes)
        holds = [0] * n_nodes
        for oname in store.objects:
            for node in store.replicas(oname):
                holds[node] += 1
        hot = sorted(scored, key=lambda so: (-so[0], so[1]))
        new: List[Tuple[str, int]] = []
        for s, oname in hot:
            if len(new) >= self.max_new_per_round:
                break
            if s < self.hot_score:
                break
            have = set(store.replicas(oname))
            missing = [n for n in range(n_nodes) if n not in have]
            if not missing:
                continue
            target = min(missing, key=lambda n: (holds[n], n))
            holds[target] += 1
            new.append((oname, target))
        self._added.extend(new)
        return new


# ---------------------------------------------------------------------------
# Scaling
# ---------------------------------------------------------------------------
@runtime_checkable
class ScalingPolicy(Protocol):
    """Decides fleet growth/shrink on every controller tick."""

    name: str
    min_servers: int
    max_servers: int

    def observe(self, resp: "PostResponse") -> None:
        """Called for every served POST (latency/SLO signal)."""
        ...

    def decide(self, fleet: "HapiFleet") -> int:
        """+1 = add a replica, -1 = retire one, 0 = hold."""
        ...


@dataclass
class QueueDepthScaling:
    """The historical default: hysteresis on mean waiting POSTs per alive
    replica, with a cooldown between actions."""

    name: str = "queue-depth"
    min_servers: int = 1
    max_servers: int = 8
    scale_up_depth: float = 8.0
    scale_down_depth: float = 0.5
    cooldown_rounds: int = 4
    _cooldown: int = 0

    def observe(self, resp: "PostResponse") -> None:
        pass

    def _hold_scale_up(self, fleet: "HapiFleet") -> bool:
        """Veto hook: a subclass may cancel a scale-up the depth signal
        asked for (e.g. when some other resource is the bottleneck).
        Holding does not consume the cooldown — the condition is
        re-checked every tick."""
        return False

    def decide(self, fleet: "HapiFleet") -> int:
        if self._cooldown > 0:
            self._cooldown -= 1
            return 0
        # Capacity = routable replicas: cordoned ones are still draining
        # but take no new work, so they must not dilute the depth signal
        # (and scale-up may reclaim them, so they don't cap growth).
        routable = fleet.n_routable
        waiting = fleet.waiting_posts()
        depth = waiting / max(routable, 1)
        if depth > self.scale_up_depth and routable < self.max_servers:
            if self._hold_scale_up(fleet):
                return 0
            self._cooldown = self.cooldown_rounds
            return +1
        if depth < self.scale_down_depth and routable > self.min_servers:
            self._cooldown = self.cooldown_rounds
            return -1
        return 0


@dataclass
class SloScaling:
    """SLO-miss-aware scaling (ROADMAP: signals beyond queue depth).

    Watches the queueing delay of recently served POSTs — exactly what the
    event log records — and scales up when the miss rate over the last
    ``window`` responses exceeds ``up_miss_rate``, *or* when the storage
    tier's accelerators ran ``util_scale_up`` busy since the last
    controller evaluation with work still waiting (``accel-util`` trace
    events): a compute-saturated fleet is guaranteed to start missing
    soon, so it grows before the misses accumulate instead of after
    (ROADMAP: fold storage-node utilization into scaling). The signal is
    *windowed* — busy-time accrued between evaluations over the virtual
    time elapsed between them — so an idle hour does not dilute a fresh
    saturating burst (which a lifetime mean would). ``util_scale_up=0``
    disables the utilization path. Scales down only when the recent
    window is entirely within SLO *and* the fleet is idle enough that a
    replica's queue is empty."""

    name: str = "slo"
    min_servers: int = 1
    max_servers: int = 8
    slo_delay: float = 0.5          # seconds of queueing a POST may absorb
    up_miss_rate: float = 0.2       # >20% recent misses -> add a replica
    util_scale_up: float = 0.9      # accel busy fraction that preempts misses
    window: int = 32                # responses considered "recent"
    cooldown_rounds: int = 4
    _delays: List[float] = field(default_factory=list)
    _cooldown: int = 0
    _u_busy: float = 0.0            # busy-time snapshot at last evaluation
    _u_vtime: float = 0.0           # virtual-time snapshot at last evaluation

    def observe(self, resp: "PostResponse") -> None:
        self._delays.append(resp.queue_delay)
        if len(self._delays) > self.window:
            del self._delays[: len(self._delays) - self.window]

    def _recent_utilization(self, fleet: "HapiFleet") -> Optional[float]:
        """Accelerator busy fraction since the last evaluation (None
        until the virtual clock advances past the previous snapshot).
        Reserve-ahead accounting can overshoot a window, so the value is
        clamped to [0, 1]."""
        accels = [a for s in fleet._alive() for a in s.accels]
        busy = sum(a.busy_time for a in accels)
        dt = fleet._vtime - self._u_vtime
        if not accels or dt <= 0.0:
            return None
        util = (busy - self._u_busy) / (len(accels) * dt)
        self._u_busy, self._u_vtime = busy, fleet._vtime
        util = min(max(util, 0.0), 1.0)
        # Replay policies run against a sim shim without metrics.
        mx = getattr(fleet.sim, "metrics", None)
        if mx is not None:
            mx.gauge_set("accel_utilization", util)
        return util

    def decide(self, fleet: "HapiFleet") -> int:
        if self._cooldown > 0:
            self._cooldown -= 1
            return 0
        routable = fleet.n_routable         # draining replicas aren't capacity
        if (self.util_scale_up and routable < self.max_servers
                and fleet.waiting_posts() > 0):
            util = self._recent_utilization(fleet)
            if util is not None and util >= self.util_scale_up:
                fleet.sim.record(fleet._vtime, "accel-util",
                                 f"{util:.3f} >= {self.util_scale_up:g}")
                self._cooldown = self.cooldown_rounds
                return +1
        if self._delays:
            misses = sum(1 for d in self._delays if d > self.slo_delay)
            rate = misses / len(self._delays)
        else:
            rate = 0.0
        if rate > self.up_miss_rate and routable < self.max_servers:
            self._cooldown = self.cooldown_rounds
            return +1
        if (rate == 0.0 and routable > self.min_servers
                and fleet.waiting_posts() == 0):
            self._cooldown = self.cooldown_rounds
            return -1
        return 0


@dataclass
class FabricAwareScaling(QueueDepthScaling):
    """Queue-depth scaling that refuses to fight the network (ROADMAP:
    fold fabric state into scaling). The storage tier is only worth
    growing when *compute* is the bottleneck; when the WAN egress trunk
    is saturated — the tenants' measured (EWMA) bandwidths sum to
    ``trunk_saturation`` of its capacity — another replica can't serve a
    byte faster, so a scale-up the queue-depth signal asks for is held
    (and recorded as a ``scale-hold`` trace event). Scale-*down* is
    untouched: shedding idle compute is always safe. On private-link
    deployments there is no fabric and the policy degrades to plain
    queue-depth scaling."""

    name: str = "fabric"
    trunk_saturation: float = 0.85

    def _trunk_bound(self, fleet: "HapiFleet") -> bool:
        fabric = getattr(fleet, "fabric", None)
        if fabric is None:
            return False
        observed = [p.observed_bw for p in fabric.ports.values()
                    if p.tenant is not None and p.observed_bw]
        if not observed:
            return False
        return sum(observed) >= self.trunk_saturation * fabric.trunk.capacity

    def _hold_scale_up(self, fleet: "HapiFleet") -> bool:
        if not self._trunk_bound(fleet):
            return False
        fleet.sim.record(fleet._vtime, "scale-hold", "trunk-bound")
        return True


DEFAULT_ROUTING = ReplicaAwareRouting
DEFAULT_PLACEMENT = RoundRobinPlacement
DEFAULT_SCALING = QueueDepthScaling
DEFAULT_SCHEDULER = WdrrScheduling

# Name -> factory registries (CLI/config selection; factories accept the
# dataclass fields of the respective policy as keyword arguments).
ROUTING_POLICIES = {
    "replica-aware": ReplicaAwareRouting,
    "least-loaded": LeastLoadedRouting,
    "fabric-aware": FabricAwareRouting,
    "warm": WarmAwareRouting,
    "hash": HashRouting,
}
PLACEMENT_POLICIES = {
    "round-robin": RoundRobinPlacement,
    "demand-aware": DemandAwarePlacement,
    "learned": LearnedPlacement,
}
SCALING_POLICIES = {
    "queue-depth": QueueDepthScaling,
    "slo": SloScaling,
    "fabric": FabricAwareScaling,
}
SCHEDULER_POLICIES = {
    "wdrr": WdrrScheduling,
    "fifo": FifoScheduling,
}

__all__ = [
    "RoutingPolicy", "ReplicaAwareRouting", "LeastLoadedRouting",
    "FabricAwareRouting", "WarmAwareRouting", "HashRouting",
    "PlacementPolicy", "RoundRobinPlacement", "DemandAwarePlacement",
    "LearnedPlacement", "learned_features",
    "ScalingPolicy", "QueueDepthScaling", "SloScaling", "FabricAwareScaling",
    "SchedulerPolicy", "WdrrScheduling", "FifoScheduling", "ComputeScheduler",
    "ROUTING_POLICIES", "PLACEMENT_POLICIES", "SCALING_POLICIES",
    "SCHEDULER_POLICIES",
]
