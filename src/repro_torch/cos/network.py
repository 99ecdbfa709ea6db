"""Flow-level shared-bandwidth network fabric (ROADMAP: simulated WAN
contention between clients; paper §7.7).

A copy of ``repro/cos/network.py``, operation for operation (the
vectorized max-min water-fill included), so a fabric of either package
resolves the same flows at the same virtual times and logs the same
events.

Until now every client owned a private :class:`~repro_torch.cos.clock.Link`
with the full nominal bandwidth, so no tenant-interference scenario was
expressible. This module models the storage<->compute network as a
*topology of shared links*:

    per-tenant NIC  ->  shared WAN egress trunk  ->  per-storage-node ingress

Transfers are **flows**. A flow occupies its port serially (the
historical ``Link`` semantics: one NIC, one transfer at a time) and
shares any trunk on its path with every other concurrently-active flow
under deterministic **max-min fair bandwidth sharing**, recomputed at
flow start/finish events.

Two resolution paths:

* :meth:`NetworkFabric.transfer` — the synchronous, ``Link``-compatible
  call the clients and the object store issue. The flow is scheduled
  against the *committed* rate profiles of already-resolved flows
  (earlier flows keep their announced completion times — causality over
  a sequential simulation). A single flow on an uncontended path
  reproduces ``Link.transfer`` byte-for-byte, trace events included
  (asserted by the JAX package's tests/test_network.py).
* :meth:`NetworkFabric.transfer_concurrent` — batch resolution with true
  max-min water-filling across the batch: rates are recomputed at every
  flow start/finish and at every committed-profile breakpoint (the
  fair-share convergence tests drive this directly). Sharing is
  **weighted**: every flow carries a weight (its port's
  ``weight`` — the tenant's service class — unless the request
  overrides it) and a bottleneck link's residual is divided
  proportionally, share-per-unit-weight = residual / Σweights. Weight 1
  everywhere reproduces the unweighted schedules bit-for-bit, so
  existing event logs are unchanged until someone actually buys a
  gold tier.

Contended *epochs* are driven by :func:`run_concurrently`, which steps
per-tenant :class:`~repro_torch.cos.client.EpochRun` objects
least-advanced-first so flows from different tenants interleave on the
fabric in virtual-time order. The client closes the loop: it folds the
measured per-transfer bandwidth into an EWMA
(:func:`repro_torch.core.cost_model.effective_bandwidth`) and periodically
re-runs Algorithm 1 with it, migrating the split toward the storage tier
when the trunk saturates.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cos.clock import Link, Simulator

_EPS = 1e-12


@dataclass(frozen=True)
class NetworkSpec:
    """Topology parameters for the shared fabric.

    ``trunk_bandwidth`` is the shared WAN egress capacity every tenant
    NIC funnels through; ``storage_trunk_bandwidth`` optionally puts the
    storage-node ingress links behind a shared internal trunk as well
    (``None`` keeps them private, the historical model)."""
    trunk_bandwidth: float = 1e9 / 8          # bytes/s (paper: 1 Gbps testbed)
    trunk_latency: float = 0.0
    storage_trunk_bandwidth: Optional[float] = None


class SharedLink:
    """A contended link: a capacity plus the committed piecewise-constant
    bandwidth already promised to resolved flows."""

    def __init__(self, name: str, capacity: float, latency: float = 0.0) -> None:
        self.name = name
        self.capacity = float(capacity)
        self.latency = float(latency)
        self.horizon = 0.0            # history before this has been pruned
        self._segments: List[Tuple[float, float, float]] = []  # (t0, t1, rate)

    def commit(self, t0: float, t1: float, rate: float) -> None:
        if t1 - t0 > _EPS and rate > _EPS:
            self._segments.append((t0, t1, rate))

    def prune(self, before: float) -> None:
        """Drop committed segments that end at or before ``before``.
        Every future flow through the fabric starts at or after its
        port's ``busy_until``, so segments fully behind the minimum
        ``busy_until`` of the trunk's ports can never shape another
        schedule — without pruning, long contended runs scan the whole
        transfer history per flow (quadratic). ``horizon`` remembers how
        far history has been forgotten: ports created later start there
        (a tenant admitted now cannot transfer in the pruned past)."""
        self.horizon = max(self.horizon, before)
        if self._segments and any(b <= before for (_a, b, _r) in self._segments):
            self._segments = [s for s in self._segments if s[1] > before]

    def used(self, t: float) -> float:
        return sum(r for (a, b, r) in self._segments if a <= t < b)

    def residual(self, t: float) -> float:
        return max(self.capacity - self.used(t), 0.0)

    def overlaps(self, a: float, b: float) -> bool:
        """Any committed segment intersecting the open interval (a, b)?"""
        return any(s0 < b - _EPS and s1 > a + _EPS
                   for (s0, s1, _r) in self._segments)

    def next_change(self, t: float) -> float:
        """Earliest committed-segment boundary strictly after ``t``."""
        nxt = math.inf
        for a, b, _ in self._segments:
            if a > t + _EPS:
                nxt = min(nxt, a)
            if b > t + _EPS:
                nxt = min(nxt, b)
        return nxt


@dataclass
class FabricPort(Link):
    """``Link``-compatible endpoint whose transfers run through the
    fabric. Synchronous transfers serialize on the port
    (``busy_until``), so the *shared* resource is always the trunk
    behind them; flows batched into one ``transfer_concurrent`` call may
    overlap on their port and then share its rate max-min like any other
    link (fluid-flow semantics — ``busy_time`` counts the union of the
    overlapping windows, not their sum)."""
    fabric: Optional["NetworkFabric"] = None
    trunk: Optional[SharedLink] = None
    tenant: Optional[int] = None
    weight: float = 1.0                     # service class (gold > bronze)
    bytes_moved: float = 0.0
    observed_bw: Optional[float] = None     # EWMA of achieved bandwidth
    ewma_alpha: float = 0.25

    def transfer(self, start: float, nbytes: float) -> Tuple[float, float]:
        return self.fabric.transfer(self, start, float(nbytes))

    def observe(self, nbytes: float, seconds: float) -> None:
        """Fold one achieved-bandwidth sample into the port's EWMA."""
        self.bytes_moved += nbytes
        if seconds > _EPS and nbytes > 0:
            from repro_torch.core.cost_model import effective_bandwidth

            sample = nbytes / seconds
            prior = sample if self.observed_bw is None else self.observed_bw
            self.observed_bw = effective_bandwidth(prior, [sample],
                                                   alpha=self.ewma_alpha)
        if self.sim is not None and self.trunk is not None and nbytes > 0:
            mx = self.sim.metrics
            mx.inc("trunk_bytes_total", nbytes, link=self.trunk.name)
            # Saturation gauge: sum of the trunk ports' measured EWMA
            # bandwidths against the trunk's capacity, clamped to 1.
            shared = sum(
                p.observed_bw or 0.0
                for p in (self.fabric.ports.values() if self.fabric else ())
                if p.trunk is self.trunk)
            mx.gauge_set("trunk_utilization",
                         min(shared / self.trunk.capacity, 1.0),
                         link=self.trunk.name)


class _Flow:
    """One batch-resolved transfer (transfer_concurrent bookkeeping)."""

    def __init__(self, idx: int, port: FabricPort, start: float,
                 nbytes: float, weight: Optional[float] = None) -> None:
        self.idx = idx
        self.port = port
        self.start = start                       # port acquisition time
        lat = port.latency + (port.trunk.latency if port.trunk else 0.0)
        self.tx0 = start + lat                   # transmission begins
        self.nbytes = nbytes
        self.remaining = nbytes
        self.weight = port.weight if weight is None else float(weight)
        self.end = math.inf
        self.segments: List[Tuple[float, float, float]] = []


class NetworkFabric:
    """The shared-bandwidth network between the storage and compute
    tiers. Owns the WAN egress trunk, the optional storage ingress
    trunk, and every port handed to tenants / storage nodes."""

    def __init__(self, spec: Optional[NetworkSpec] = None,
                 sim: Optional[Simulator] = None) -> None:
        self.spec = spec or NetworkSpec()
        self.sim = sim
        self.trunk = SharedLink("wan-trunk", self.spec.trunk_bandwidth,
                                self.spec.trunk_latency)
        self.storage_trunk = (
            SharedLink("storage-trunk", self.spec.storage_trunk_bandwidth)
            if self.spec.storage_trunk_bandwidth else None
        )
        self.ports: Dict[str, FabricPort] = {}

    def attach(self, sim: Simulator) -> "NetworkFabric":
        self.sim = sim
        for p in self.ports.values():
            p.attach(sim)
        return self

    # -- topology --------------------------------------------------------------
    def _add_port(self, port: FabricPort) -> FabricPort:
        if port.trunk is not None:
            # A port created after traffic starts at the trunk's pruned
            # horizon — it must not schedule flows into forgotten history
            # (that would overcommit the trunk's past).
            port.busy_until = port.trunk.horizon
        if self.sim is not None:
            port.attach(self.sim)
        self.ports[port.name] = port
        return port

    def tenant_port(self, tenant: int, bandwidth: float, *,
                    latency: float = 1e-3,
                    name: Optional[str] = None,
                    weight: float = 1.0) -> FabricPort:
        """The tenant's NIC: private ``bandwidth``, shared WAN trunk.
        ``weight`` is the tenant's service class — its flows' default
        share of any contended link under weighted max-min sharing."""
        return self._add_port(FabricPort(
            name=name or f"wan{tenant}", bandwidth=bandwidth, latency=latency,
            fabric=self, trunk=self.trunk, tenant=tenant,
            weight=float(weight)))

    def storage_port(self, index: int, bandwidth: float, *,
                     latency: float = 2e-4) -> FabricPort:
        """A storage node's ingress link (behind the storage trunk when
        the spec defines one, private otherwise)."""
        return self._add_port(FabricPort(
            name=f"storage{index}", bandwidth=bandwidth, latency=latency,
            fabric=self, trunk=self.storage_trunk))

    def effective_bandwidth(self, tenant: int) -> Optional[float]:
        """Measured (EWMA) bandwidth of a tenant's port; None before any
        transfer completed."""
        for p in self.ports.values():
            if p.tenant == tenant:
                return p.observed_bw
        return None

    # -- synchronous resolution (Link-compatible) -------------------------------
    def transfer(self, port: FabricPort, start: float,
                 nbytes: float) -> Tuple[float, float]:
        """Move ``nbytes`` through ``port`` (and its trunk). Returns
        ``(actual_start, end)`` like ``Link.transfer``. Already-resolved
        flows keep their committed schedules; this flow takes the
        residual trunk capacity (up to the port rate)."""
        trunk = port.trunk
        solo = port.latency + nbytes / port.bandwidth
        if trunk is None:
            # Private path: exact Link semantics (and trace events).
            return port.reserve(start, solo)
        self._prune(trunk)
        s = max(start, port.busy_until)
        tx0 = s + port.latency + trunk.latency
        e_solo = tx0 + nbytes / port.bandwidth
        if (trunk.capacity + _EPS >= port.bandwidth
                and not trunk.overlaps(tx0, e_solo)):
            # Uncontended fast path: byte-identical to Link.transfer
            # (same float expression, same recorded event).
            s2, e = port.reserve(start, solo + trunk.latency)
            trunk.commit(e - nbytes / port.bandwidth, e, port.bandwidth)
            port.observe(nbytes, e - s2 - port.latency - trunk.latency)
            return s2, e
        end, segs = self._fill(trunk, port.bandwidth, tx0, nbytes)
        for (a, b, r) in segs:
            trunk.commit(a, b, r)
        port.note(s, end)
        port.observe(nbytes, end - s - port.latency - trunk.latency)
        return s, end

    def _prune(self, trunk: SharedLink) -> None:
        """Garbage-collect trunk history behind every port: no flow can
        start before its port's ``busy_until``, so the minimum over the
        trunk's ports bounds all future schedules."""
        ports = [p for p in self.ports.values() if p.trunk is trunk]
        if ports:
            trunk.prune(min(p.busy_until for p in ports))

    def _fill(self, trunk: SharedLink, cap: float, t0: float,
              nbytes: float) -> Tuple[float, List[Tuple[float, float, float]]]:
        """Progressive filling of one flow against the trunk residual."""
        t, remaining = t0, nbytes
        floor = 1e-9 * max(nbytes, 1.0)
        segs: List[Tuple[float, float, float]] = []
        guard = 0
        while remaining > floor:
            guard += 1
            assert guard < 1_000_000, "fabric fill livelock"
            rate = min(cap, trunk.residual(t))
            nxt = trunk.next_change(t)
            if rate <= _EPS:
                assert nxt < math.inf, "trunk permanently saturated"
                t = nxt
                continue
            dt = remaining / rate
            if nxt < t + dt:
                segs.append((t, nxt, rate))
                remaining -= rate * (nxt - t)
                t = nxt
            else:
                segs.append((t, t + dt, rate))
                t += dt
                remaining = 0.0
        return t, segs

    # -- batch resolution: true max-min fair sharing ----------------------------
    def transfer_concurrent(
        self, requests: Sequence[Tuple]
    ) -> List[Tuple[float, float]]:
        """Resolve a batch of flows *together*: active flows share every
        link weighted-max-min (per-flow cap = port rate; trunk capacity
        net of committed profiles), with rates recomputed at every flow
        start/finish and committed breakpoint. ``requests`` is a list of
        ``(port, start, nbytes)`` or ``(port, start, nbytes, weight)``
        — an explicit weight overrides the port's (the storage batch
        window tags each read with the owning tenant's class this way);
        returns ``[(actual_start, end), ...]`` in request order."""
        norm = [(r[0], r[1], r[2], r[3] if len(r) > 3 else None)
                for r in requests]
        for trunk in {p.trunk for (p, _s, _n, _w) in norm if p.trunk}:
            self._prune(trunk)
        flows = [_Flow(i, port, max(start, port.busy_until), float(nbytes),
                       weight)
                 for i, (port, start, nbytes, weight) in enumerate(norm)]
        pending = sorted(flows, key=lambda f: (f.tx0, f.idx))
        active: List[_Flow] = []
        t = pending[0].tx0 if pending else 0.0
        done: List[_Flow] = []
        guard = 0
        while pending or active:
            guard += 1
            assert guard < 1_000_000, "fabric batch livelock"
            while pending and pending[0].tx0 <= t + _EPS:
                active.append(pending.pop(0))
            if not active:
                t = pending[0].tx0
                continue
            rates = self._max_min(active, t)
            nxt = pending[0].tx0 if pending else math.inf
            for trunk in {f.port.trunk for f in active if f.port.trunk}:
                nxt = min(nxt, trunk.next_change(t))
            for f in active:
                r = rates[f.idx]
                if r > _EPS:
                    nxt = min(nxt, t + f.remaining / r)
            assert nxt < math.inf, "no runnable flow and no future capacity"
            for f in active:
                r = rates[f.idx]
                if r > _EPS:
                    f.segments.append((t, nxt, r))
                    f.remaining -= r * (nxt - t)
            t = nxt
            still: List[_Flow] = []
            for f in active:
                if f.remaining <= 1e-9 * max(f.nbytes, 1.0):
                    f.end = t
                    done.append(f)
                else:
                    still.append(f)
            active = still
        out: List[Tuple[float, float]] = [(0.0, 0.0)] * len(flows)
        by_port: Dict[str, List[_Flow]] = {}
        for f in sorted(done, key=lambda f: f.idx):
            if f.port.trunk is not None:
                for (a, b, r) in f.segments:
                    f.port.trunk.commit(a, b, r)
            lat = f.port.latency + (f.port.trunk.latency if f.port.trunk else 0.0)
            f.port.observe(f.nbytes, f.end - f.start - lat)
            by_port.setdefault(f.port.name, []).append(f)
            out[f.idx] = (f.start, f.end)
        for name in sorted(by_port):
            port_flows = by_port[name]
            # Same-port batch flows overlap (they shared the port's
            # rate), so busy accounting takes the union of their windows.
            for a, b in _merge_intervals(
                    [(f.start, f.end) for f in port_flows]):
                port_flows[0].port.note(a, b)
        return out

    def _max_min(self, active: List[_Flow], t: float) -> Dict[int, float]:
        """Weighted max-min water-filling over the links the active flows
        touch, vectorized over numpy arrays (flow weights, link residuals,
        flow↔link incidence). Repeatedly freeze the flows of the
        bottleneck link — the one with the smallest fair share *per unit
        weight* (residual / Σweights of its unfrozen flows) — at that
        unit share scaled by each flow's weight. All weights 1 reduces to
        the classic equal-share fill bit-for-bit (Σ of ones is exactly
        the count, and ``share * 1.0`` is ``share``). Deterministic:
        links visited in sorted key order, flows in index order.

        Rates are bitwise identical to the JAX package's water-fill
        (property-tested in tests/test_torch_fleet.py): per-link weight
        sums use ``np.bincount`` and residual updates ``np.subtract.at``,
        the bottleneck selection runs over Python-float shares with the
        same ``_EPS`` comparison chain, and edges are laid out
        flow-major, port before trunk. Against the scalar loop kept as
        the oracle in the JAX package's tests/test_scale_core.py they
        can differ by one ulp: ``np.bincount`` sums the weights in
        another order on some flow sets (a fault this copy shares with
        the reference, whose digests it must reproduce)."""
        n = len(active)
        # Link universe in first-seen order; sorted() below fixes the
        # selection order exactly like the scalar `sorted(caps)`.
        caps: Dict[Tuple[str, str], float] = {}
        for f in active:
            pk = ("port", f.port.name)
            if pk not in caps:
                caps[pk] = f.port.bandwidth
            trunk = f.port.trunk
            if trunk is not None:
                tk = ("trunk", trunk.name)
                if tk not in caps:
                    caps[tk] = trunk.residual(t)
        skeys = sorted(caps)
        col = {k: j for j, k in enumerate(skeys)}
        n_links = len(skeys)
        residual = np.array([caps[k] for k in skeys], dtype=np.float64)
        w = np.empty(n, dtype=np.float64)
        ef: List[int] = []
        el: List[int] = []
        for i, f in enumerate(active):
            w[i] = f.weight
            ef.append(i)
            el.append(col[("port", f.port.name)])
            trunk = f.port.trunk
            if trunk is not None:
                ef.append(i)
                el.append(col[("trunk", trunk.name)])
        edge_flow = np.asarray(ef, dtype=np.intp)
        edge_link = np.asarray(el, dtype=np.intp)
        edge_w = w[edge_flow]
        rates = np.zeros(n, dtype=np.float64)
        unfrozen = np.ones(n, dtype=bool)
        remaining = n
        while remaining:
            em = unfrozen[edge_flow]
            links = edge_link[em]
            wsum = np.bincount(links, weights=edge_w[em], minlength=n_links)
            cnt = np.bincount(links, minlength=n_links)
            best_share: Optional[float] = None
            best_j = -1
            for j in range(n_links):
                if not cnt[j]:
                    continue
                share = max(float(residual[j]), 0.0) / float(wsum[j])
                if best_share is None or share < best_share - _EPS:
                    best_share, best_j = share, j
            assert best_j >= 0
            sel = edge_flow[em][links == best_j]
            rates[sel] = best_share * w[sel]
            unfrozen[sel] = False
            remaining -= len(sel)
            sel_mask = np.zeros(n, dtype=bool)
            sel_mask[sel] = True
            sel_edges = sel_mask[edge_flow]
            np.subtract.at(residual, edge_link[sel_edges],
                           rates[edge_flow[sel_edges]])
        return {f.idx: float(rates[i]) for i, f in enumerate(active)}


def measure_trunk_shares(weights: Sequence[float], trunk_bandwidth: float,
                         *, nbytes: float = 2e9) -> List[float]:
    """Empirically measure the trunk split of two backlogged service
    classes: one flow per class on a fresh fabric, started together with
    equal bytes, ports at the trunk rate. While both are active the
    trunk divides in weight proportion (weighted max-min water-filling);
    the single late finisher then owns the trunk for its solo tail, so
    its bytes inside the contended window are its total minus that tail
    — arithmetic that only holds for exactly two classes, hence the
    assert. Returns bytes/s of the trunk each class achieved during the
    contended window (the QoS benchmark asserts their ratio tracks the
    weight ratio; the contended-tenants example prints them)."""
    assert len(weights) == 2, "trunk-share probe compares exactly two classes"
    fabric = NetworkFabric(NetworkSpec(trunk_bandwidth=trunk_bandwidth))
    ports = [fabric.tenant_port(i, bandwidth=trunk_bandwidth, latency=0.0,
                                weight=w)
             for i, w in enumerate(weights)]
    ends = [e for _s, e in
            fabric.transfer_concurrent([(p, 0.0, nbytes) for p in ports])]
    window = min(ends)
    return [(nbytes - trunk_bandwidth * max(e - window, 0.0)) / window
            for e in ends]


def wan_link(tenant: int, bandwidth: float,
             fabric: Optional[NetworkFabric] = None, *,
             name: Optional[str] = None, latency: float = 1e-3,
             weight: float = 1.0) -> Link:
    """The one way a tenant's WAN link is built: a fabric port (shared
    trunk) when a fabric is given, a private fixed-rate :class:`Link`
    otherwise. Used by both clients and the cluster facade so the two
    models can never drift apart. ``weight`` is the tenant's service
    class; it only matters on a shared fabric (a private link has
    nothing to share)."""
    if fabric is not None:
        return fabric.tenant_port(tenant, bandwidth=bandwidth,
                                  latency=latency, name=name, weight=weight)
    return Link(name=name or f"wan{tenant}", bandwidth=bandwidth,
                latency=latency)


def _merge_intervals(
    intervals: List[Tuple[float, float]]
) -> List[Tuple[float, float]]:
    ivs = sorted(intervals)
    merged = [list(ivs[0])]
    for a, b in ivs[1:]:
        if a <= merged[-1][1] + _EPS:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def run_concurrently(runs: Sequence, *, max_steps: int = 1_000_000) -> List:
    """Co-schedule epoch runs: always step the least-advanced run
    (deterministic tie-break: position in ``runs``), so flows from
    different tenants hit the shared fabric in virtual-time order.
    Accepts any objects exposing ``t`` / ``done`` / ``step()`` /
    ``result()`` (see :class:`repro_torch.cos.client.EpochRun`); returns their
    results in input order."""
    live = [r for r in runs if not r.done]
    guard = 0
    while live:
        guard += 1
        assert guard < max_steps, "concurrent epoch scheduler livelock"
        nxt = min(live, key=lambda r: r.t)   # min() is stable: list order
        nxt.step()
        live = [r for r in live if not r.done]
    return [r.result() for r in runs]
