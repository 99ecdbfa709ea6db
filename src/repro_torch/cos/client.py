"""The Hapi client (paper §5.2/§5.4/§6) + the status-quo baseline client.

A copy of ``repro/cos/client.py`` over the port's planner: the same
requests, reordering, straggler re-issue and virtual-clock arithmetic, so
an epoch of either package on the same profile gives the same
``EpochResult``. The defaults are the port's ``HW`` (one H100). A shared
network fabric (``fabric=``) is ``repro_torch.cos.network``'s, imported
only when one is given.

The client: profiles the model once, chooses the split index (Alg. 1),
then per training iteration issues one POST per storage object, awaits
out-of-order completions, REORDERS them to preserve the learning
trajectory, re-issues stragglers, and runs the training phase (the
remaining frozen blocks + trainable suffix) at the training batch size.

The baseline client streams raw objects (GET) and computes everything
locally, pipelining transfer of batch i+1 with compute of batch i
(paper Fig. 6).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, TYPE_CHECKING

import numpy as np

from repro_torch.config import HW, HapiConfig
from repro_torch.core.cost_model import effective_bandwidth
from repro_torch.core.profiler import LayerProfile
from repro_torch.core.splitter import SplitDecision, choose_split
from repro_torch.cos.clock import Accelerator, EventLog, Link
from repro_torch.cos.objectstore import ObjectStore
from repro_torch.cos.server import HapiServer, PostRequest, PostResponse

if TYPE_CHECKING:
    from repro_torch.cos.network import NetworkFabric


@dataclass
class IterationStats:
    iteration: int
    t_start: float
    t_end: float
    wire_bytes: float
    n_posts: int
    reissued: int = 0
    served_by_server: Dict[int, int] = field(default_factory=dict)


@dataclass
class EpochResult:
    execution_time: float
    transferred_per_iter: float
    total_wire_bytes: float
    iterations: List[IterationStats]
    split: int
    oom: bool = False
    resplits: int = 0                  # contention-aware split migrations

    @property
    def n_iterations(self) -> int:
        return len(self.iterations)

    @property
    def served_by_server(self) -> Dict[int, int]:
        """POSTs served per fleet replica over the epoch (single servers
        report everything under id 0)."""
        out: Dict[int, int] = {}
        for it in self.iterations:
            for sid, n in it.served_by_server.items():
                out[sid] = out.get(sid, 0) + n
        return out


class HapiClient:
    """``server`` may be a single :class:`HapiServer` or a
    :class:`~repro_torch.cos.fleet.HapiFleet` — both expose the same
    ``store``/``submit``/``drain`` surface. When the server side carries a
    shared :class:`~repro_torch.cos.clock.Simulator`, the client joins it so
    its link and accelerator show up in the fleet-wide trace.

    ``link=None`` creates the tenant's WAN link from
    ``hapi.network_bandwidth`` — the common case, and what
    :meth:`repro_torch.api.HapiCluster.tenant` relies on. When a shared
    :class:`~repro_torch.cos.network.NetworkFabric` is given, the link is a
    fabric port instead: transfers become flows that contend with other
    tenants on the WAN egress trunk. Multi-tenant deployments should be
    stood up through the facade rather than by wiring clients to fleets
    by hand.

    ``resplit_every=k`` closes the contention loop: every ``k``
    iterations the client re-runs Algorithm 1 with the EWMA of its
    measured transfer bandwidth (instead of the nominal rate), so the
    split migrates toward the storage tier when the trunk saturates
    (paper §7.7's bandwidth-sensitive split behavior)."""

    def __init__(
        self,
        server: "HapiServer",
        link: Optional[Link],
        profile: LayerProfile,
        hapi: HapiConfig,
        model_key: str,
        *,
        client_flops: float = HW.peak_flops_bf16,
        client_hbm: float = HW.hbm_capacity,
        has_accelerator: bool = True,
        tenant: int = 0,
        straggler_factor: float = 3.0,
        train_fn: Optional[Callable] = None,   # live suffix training
        mxu_efficiency: float = 0.4,
        push_training: bool = False,           # ALL_IN_COS comparison mode
        fabric: Optional["NetworkFabric"] = None,
        resplit_every: int = 0,                # 0 = split fixed for the epoch
        bw_ewma_alpha: float = 0.25,
        network_weight: Optional[float] = None,  # service class; None adopts
                                                 # the link's (1.0 otherwise)
        compute_weight: Optional[float] = None,  # accelerator service class;
                                                 # None adopts network_weight
    ) -> None:
        self.server = server
        if link is None:
            from repro_torch.cos.network import wan_link

            link = wan_link(tenant, hapi.network_bandwidth, fabric,
                            weight=1.0 if network_weight is None
                            else network_weight)
        self.link = link
        if network_weight is None:
            network_weight = getattr(link, "weight", 1.0)
        self.network_weight = float(network_weight)
        self.compute_weight = float(self.network_weight
                                    if compute_weight is None
                                    else compute_weight)
        if self.compute_weight <= 0:
            raise ValueError(
                f"compute weight must be > 0, got {self.compute_weight}")
        self.profile = profile
        self.hapi = hapi
        self.model_key = model_key
        self.tenant = tenant
        self.straggler_factor = straggler_factor
        self.train_fn = train_fn
        self.push_training = push_training
        eff_flops = client_flops if has_accelerator else client_flops / 40.0
        self.accel = Accelerator(name=f"client{tenant}", flops=eff_flops, hbm=client_hbm)
        self.has_accelerator = has_accelerator
        self.mxu_efficiency = mxu_efficiency
        self.sim = getattr(server, "sim", None)
        if self.sim is not None:
            self.accel.attach(self.sim)
            self.link.attach(self.sim)
        # Private iteration log adopts the shared simulator's retention.
        self.log = EventLog(retention=self.sim.log.retention,
                            tail=self.sim.log.tail) if self.sim is not None \
            else EventLog()
        # Rendezvous for responses drained by the "wrong" tenant on a
        # shared server/fleet: strangers we drain are stashed here for
        # their owner, and we claim our own strays from it — never
        # silently dropped. The dict is the *server's* (shared by every
        # client of the deployment, which is what makes cross-tenant
        # delivery work); bare stub servers without one get a local dict.
        self.unclaimed: Dict[int, PostResponse] = \
            getattr(server, "unclaimed", None)
        if self.unclaimed is None:
            self.unclaimed = {}
        self._next_req = tenant * 1_000_000
        self.resplit_every = resplit_every
        self.bw_ewma_alpha = bw_ewma_alpha
        self.observed_bw: Optional[float] = None  # EWMA of achieved bandwidth
        if hasattr(self.link, "ewma_alpha"):
            # Fabric port: one estimator. The fabric maintains the EWMA
            # (same samples, path latency handled by the port) and the
            # client adopts it after every pull, so
            # fabric.effective_bandwidth(tenant) and client.observed_bw
            # can never drift apart.
            self.link.ewma_alpha = bw_ewma_alpha
        # Split once per application (paper: before start).
        self.decision: SplitDecision = choose_split(profile, hapi, train_batch=1)

    def choose_split_for(self, train_batch: int) -> SplitDecision:
        self.decision = choose_split(self.profile, self.hapi, train_batch)
        return self.decision

    # -- contention-aware split re-decision ------------------------------------
    def _observe_bandwidth(self, sample: float) -> None:
        prior = sample if self.observed_bw is None else self.observed_bw
        self.observed_bw = effective_bandwidth(prior, [sample],
                                               alpha=self.bw_ewma_alpha)

    def resplit(self, train_batch: int) -> SplitDecision:
        """Re-run Algorithm 1 with the measured (EWMA) bandwidth in place
        of the nominal rate — under trunk contention the threshold
        ``C = bw * window`` shrinks and the winner migrates toward the
        freeze index (more pushdown, smaller activations)."""
        bw = self.observed_bw if self.observed_bw else self.hapi.network_bandwidth
        hapi = dataclasses.replace(self.hapi, network_bandwidth=bw)
        self.decision = choose_split(self.profile, hapi, train_batch)
        return self.decision

    # ------------------------------------------------------------------
    def start_epoch(
        self,
        dataset: str,
        train_batch: int,
        *,
        t0: float = 0.0,
        max_iterations: Optional[int] = None,
    ) -> "EpochRun":
        """The epoch as an explicitly-steppable run — what
        :func:`repro_torch.cos.network.run_concurrently` drives so contending
        tenants' flows interleave in virtual-time order."""
        return EpochRun(self, dataset, train_batch, t0=t0,
                        max_iterations=max_iterations)

    def run_epoch(
        self,
        dataset: str,
        train_batch: int,
        *,
        t0: float = 0.0,
        max_iterations: Optional[int] = None,
    ) -> EpochResult:
        """One fine-tuning epoch over a dataset stored as COS objects
        (``start_epoch`` driven to completion)."""
        run = self.start_epoch(dataset, train_batch, t0=t0,
                               max_iterations=max_iterations)
        while not run.done:
            run.step()
        return run.result()

    def _run_iteration(self, it: int, t: float, group: List[str], split: int,
                       train_batch: int) -> Optional[IterationStats]:
        reqs = []
        for oname in group:
            self._next_req += 1
            b_max = (train_batch if self.push_training
                     else min(train_batch, self.hapi.cos_batch))
            reqs.append(PostRequest(
                req_id=self._next_req, tenant=self.tenant,
                model_key=self.model_key, split=split, object_name=oname,
                b_max=b_max,
                profile=self.profile, arrival=t,
                compress=self.hapi.compress_transfer,
                adaptable=not self.push_training,
                network_weight=self.network_weight,
                compute_weight=self.compute_weight,
            ))
            self.server.submit(reqs[-1])
        responses = self.server.drain(now=t)
        ours = {r.req_id for r in reqs}
        by_id = {}
        for resp in responses:
            if resp.req_id in ours:
                by_id[resp.req_id] = resp
            else:           # burst traffic sharing the fleet: surface it
                self.unclaimed[resp.req_id] = resp
        # A previous shared drain may have served one of ours already.
        for rid in ours - by_id.keys():
            if rid in self.unclaimed:
                by_id[rid] = self.unclaimed.pop(rid)
        if any(r.req_id not in by_id for r in reqs):
            return None  # rejected -> OOM

        # Straggler mitigation: anything beyond straggler_factor x median
        # completion is re-issued; the duplicate (fresh queue) wins.
        done = [by_id[r.req_id] for r in reqs if r.req_id in by_id]
        reissued = 0
        if len(done) >= 3:
            med = float(np.median([d.finished - d.arrival for d in done]))
            for i, d in enumerate(done):
                if d.finished - d.arrival > self.straggler_factor * med:
                    dup = reqs[i]
                    dup = PostRequest(
                        req_id=dup.req_id + 500_000, tenant=dup.tenant,
                        model_key=dup.model_key, split=dup.split,
                        object_name=dup.object_name, b_max=dup.b_max,
                        profile=dup.profile, arrival=d.arrival, compress=dup.compress,
                        adaptable=dup.adaptable,
                        network_weight=dup.network_weight,
                        compute_weight=dup.compute_weight,
                    )
                    self.server.submit(dup)
                    # A shared fleet may drain unrelated pending requests
                    # in the same call: select the duplicate's response by
                    # req_id (not position) and surface the rest for
                    # their owners instead of dropping them.
                    redo = self.server.drain(now=d.arrival)
                    dup_resp = None
                    for r in redo:
                        if r.req_id == dup.req_id:
                            dup_resp = r
                        else:
                            self.unclaimed[r.req_id] = r
                    if dup_resp is not None and dup_resp.finished < d.finished:
                        done[i] = dup_resp
                        reissued += 1

        # ``done`` is already in request order (built from ``reqs``; a
        # winning re-issue replaces its straggler in place), which is what
        # preserves the learning trajectory — sorting by req_id would file
        # re-issued duplicates (+500_000) at the end.

        # Pull activations over the bottleneck link. The achieved
        # bandwidth (including any queueing behind other tenants' flows
        # on a shared fabric trunk) feeds the EWMA the resplit loop uses.
        t_data = t
        wire = 0.0
        tr = self.sim.tracer if self.sim is not None else None
        for d in done:
            t_req = max(t_data, d.finished)
            _, t_data = self.link.transfer(t_req, d.act_bytes)
            wire += d.act_bytes
            if tr is not None:
                tr.emit("wire.transfer", t_req, t_data, tier="network",
                        track=self.link.name, parent=d.span_id,
                        labels=(("tenant", str(self.tenant)),
                                ("bytes", f"{d.act_bytes:.0f}")))
                tr.extend(d.span_id, t_data)
                mx = self.sim.metrics
                mx.observe("stage_seconds", t_data - t_req, stage="wire")
            port_bw = getattr(self.link, "observed_bw", None)
            if port_bw is not None:
                self.observed_bw = port_bw      # fabric-maintained EWMA
            else:
                dt = t_data - t_req - self.link.latency
                if d.act_bytes > 0 and dt > 0:
                    self._observe_bandwidth(d.act_bytes / dt)

        # Training phase at the training batch size (suffix fwd+bwd).
        prof = self.profile
        suffix_flops = 3.0 * (prof.total_flops - prof.cum_flops[split]) * train_batch
        t_suffix, t_end = self.accel.compute(t_data, suffix_flops,
                                             efficiency=self.mxu_efficiency)
        if self.train_fn is not None and all(d.acts is not None for d in done):
            self.train_fn([d.acts for d in done])
        self.log.add(t_end, "iteration", f"{it}")
        if self.sim is not None:
            self.sim.record(t_end, "iteration", f"t{self.tenant} it={it}")
            tr = self.sim.tracer
            it_sid = tr.emit("iteration", t, t_end, tier="client",
                             track=f"tenant{self.tenant}",
                             labels=(("tenant", str(self.tenant)),
                                     ("it", str(it)),
                                     ("split", str(split))))
            tr.emit("client.compute", t_suffix, t_end, tier="client",
                    track=self.accel.name, parent=it_sid,
                    labels=(("tenant", str(self.tenant)),
                            ("it", str(it))))
            mx = self.sim.metrics
            mx.observe("stage_seconds", t_end - t_suffix, stage="client")
        by_server: Dict[int, int] = {}
        for d in done:
            by_server[d.server_id] = by_server.get(d.server_id, 0) + 1
        return IterationStats(it, t, t_end, wire, len(group), reissued,
                              served_by_server=by_server)


class EpochRun:
    """One tenant's fine-tuning epoch as a steppable iteration sequence.

    ``HapiClient.run_epoch`` is exactly this driven to completion, so
    the uncontended path is unchanged; contended scenarios hand several
    runs to :func:`repro_torch.cos.network.run_concurrently`, which steps the
    least-advanced tenant first so their flows interleave on the shared
    fabric in virtual-time order. When the owning client has
    ``resplit_every`` set, the split is re-decided between iterations
    from the measured-bandwidth EWMA (and every migration is recorded as
    a ``resplit`` event in the shared trace)."""

    def __init__(self, client: "HapiClient", dataset: str, train_batch: int,
                 *, t0: float = 0.0,
                 max_iterations: Optional[int] = None) -> None:
        self.client = client
        self.dataset = dataset
        self.train_batch = train_batch
        store = client.server.store
        self._objects = store.object_names(dataset)
        if client.push_training:
            self.split = client.profile.n_boundaries - 1  # all in the COS
        else:
            self.split = client.choose_split_for(train_batch).split_index
        obj_size = store.objects[self._objects[0]].n_samples \
            if self._objects else 0
        self._per_iter = max(1, train_batch // max(obj_size, 1))
        self.t0 = t0
        self.t = t0                     # next iteration's start time
        self.max_iterations = max_iterations
        self.iterations: List[IterationStats] = []
        self.total_wire = 0.0
        self.oom = False
        self.resplits = 0
        self._oi = 0
        self._it = 0

    @property
    def done(self) -> bool:
        if self.oom or self._oi >= len(self._objects):
            return True
        return bool(self.max_iterations) and self._it >= self.max_iterations

    def step(self) -> Optional[IterationStats]:
        """Run the next iteration; returns its stats (None when the run
        is complete or the iteration OOMed)."""
        if self.done:
            return None
        c = self.client
        if (c.resplit_every and not c.push_training and self._it
                and self._it % c.resplit_every == 0):
            old = self.split
            new = c.resplit(self.train_batch).split_index
            if new != old:
                self.split = new
                self.resplits += 1
                if c.sim is not None:
                    c.sim.record(self.t, "resplit",
                                 f"t{c.tenant} it={self._it} {old}->{new} "
                                 f"bw={c.observed_bw:.3e}")
        group = self._objects[self._oi:self._oi + self._per_iter]
        self._oi += self._per_iter
        stats = c._run_iteration(self._it, self.t, group, self.split,
                                 self.train_batch)
        if stats is None:
            # Requests were rejected (cannot fit even alone) — the
            # paper's OOM 'X': a non-adaptable job at this batch size
            # simply cannot run in the COS.
            self.oom = True
            return None
        self.iterations.append(stats)
        self.total_wire += stats.wire_bytes
        self.t = stats.t_end
        self._it += 1
        return stats

    def result(self) -> EpochResult:
        if self.oom:
            return EpochResult(float("inf"), 0.0, 0.0, [], split=self.split,
                               oom=True)
        return EpochResult(
            execution_time=self.t - self.t0,
            transferred_per_iter=self.total_wire / max(len(self.iterations), 1),
            total_wire_bytes=self.total_wire,
            iterations=list(self.iterations),
            split=self.split,
            resplits=self.resplits,
        )


class BaselineClient:
    """Status quo: stream raw objects, run the whole DNN client-side,
    overlapping next-batch transfer with current-batch compute.

    Link handling matches :class:`HapiClient`: ``link`` is optional
    (``None`` self-constructs a private WAN link at ``bandwidth``, or a
    fabric port when a shared :class:`~repro_torch.cos.network.NetworkFabric`
    is given), so baseline runs can contend on the same trunk. Sim
    handling matches too: when the store carries a shared
    :class:`~repro_torch.cos.clock.Simulator` the client joins it, so baseline
    transfers and compute show up in the fleet-wide trace, and the
    accelerator is tenant-qualified (two baseline tenants must not
    collide on one timeline name)."""

    def __init__(self, store: ObjectStore, link: Optional[Link],
                 profile: LayerProfile,
                 *, client_flops: float = HW.peak_flops_bf16,
                 client_hbm: float = HW.hbm_capacity,
                 has_accelerator: bool = True,
                 mxu_efficiency: float = 0.4,
                 tenant: int = 0,
                 bandwidth: Optional[float] = None,
                 fabric: Optional["NetworkFabric"] = None,
                 network_weight: float = 1.0) -> None:
        self.store = store
        if link is None:
            bw = bandwidth if bandwidth is not None \
                else HapiConfig().network_bandwidth
            from repro_torch.cos.network import wan_link

            link = wan_link(tenant, bw, fabric, name=f"wan{tenant}-base",
                            weight=network_weight)
        self.link = link
        self.tenant = tenant
        self.profile = profile
        eff = client_flops if has_accelerator else client_flops / 40.0
        self.accel = Accelerator(name=f"client{tenant}-base", flops=eff,
                                 hbm=client_hbm)
        self.mxu_efficiency = mxu_efficiency
        self.sim = getattr(store, "sim", None)
        if self.sim is not None:
            self.accel.attach(self.sim)
            self.link.attach(self.sim)

    def run_epoch(self, dataset: str, train_batch: int, *, t0: float = 0.0,
                  freeze_index: Optional[int] = None,
                  max_iterations: Optional[int] = None) -> EpochResult:
        prof = self.profile
        fz = freeze_index if freeze_index is not None else prof.freeze_index
        objects = self.store.object_names(dataset)
        obj_size = self.store.objects[objects[0]].n_samples if objects else 1
        per_iter = max(1, train_batch // max(obj_size, 1))

        # OOM check (paper Fig. 6/10 'X'): full-model act memory at the
        # training batch size + weights must fit client HBM.
        need = prof.memory_estimate(prof.n_boundaries - 1, train_batch) + \
            prof.model_param_bytes * 2
        if need > self.accel.hbm:
            return EpochResult(float("inf"), 0.0, 0.0, [], split=0, oom=True)

        iters: List[IterationStats] = []
        t_compute = t0
        t_net = t0
        total = 0.0
        it = 0
        oi = 0
        while oi < len(objects):
            group = objects[oi: oi + per_iter]
            oi += per_iter
            nbytes = sum(self.store.objects[o].nbytes for o in group)
            n = sum(self.store.objects[o].n_samples for o in group)
            # pipelined: transfer batch i+1 during compute of batch i
            _, t_net = self.link.transfer(t_net, nbytes)
            flops = (prof.cum_flops[fz] + 3.0 * (prof.total_flops - prof.cum_flops[fz])) * n
            start = max(t_net, t_compute)
            _, t_compute = self.accel.compute(start, flops, self.mxu_efficiency)
            iters.append(IterationStats(it, start, t_compute, nbytes, len(group)))
            total += nbytes
            it += 1
            if max_iterations and it >= max_iterations:
                break
        return EpochResult(
            execution_time=t_compute - t0,
            transferred_per_iter=total / max(len(iters), 1),
            total_wire_bytes=total,
            iterations=iters,
            split=0,
        )
