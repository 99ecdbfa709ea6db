"""The :class:`HapiCluster` facade — one object that owns a whole HAPI
deployment: the shared discrete-event :class:`~repro_torch.cos.clock.Simulator`,
the :class:`~repro_torch.cos.objectstore.ObjectStore`, the
:class:`~repro_torch.cos.fleet.HapiFleet` of stateless server replicas, and the
per-tenant :class:`~repro_torch.cos.client.HapiClient` front-ends.

Before this facade existed every example and benchmark hand-wired those
five layers; now the builder is the single assembly point::

    cluster = (HapiCluster(seed=0)
               .with_servers(4, n_accelerators=2)
               .with_dataset("imagenet", n_samples=8000)
               .with_scaling(SloScaling(max_servers=8)))
    res = cluster.tenant(TenantSpec(model="alexnet")).run_epoch(
        "imagenet", train_batch=1000)

Builder calls (``with_*``) configure lazily; the deployment materializes
on first use (or an explicit :meth:`build`). Topology choices — servers,
storage, policies — are frozen at build time; datasets, executors and
tenants can keep being added to a live cluster.

Determinism: everything observable derives from ``seed`` — the same seed
reproduces a byte-identical event log under any policy combination.

A copy of ``repro/api/cluster.py``: the same deployment of either package
given the same seed and figures logs the same events (asserted by
tests/test_torch_fleet.py). The defaults are the port's ``HW`` (one H100),
and the paper's vision models are profiled on ``device="meta"``, so a
cluster that runs on the host needs no card.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.api.policies import (
    PlacementPolicy,
    RoutingPolicy,
    ScalingPolicy,
    SchedulerPolicy,
)
from repro_torch.cos.scheduler import FifoScheduling, WdrrScheduling
from repro_torch.config import HW, HapiConfig
from repro_torch.core.profiler import LayerProfile, profile_layered
from repro_torch.core.splitter import SplitDecision, choose_split
from repro_torch.cos.client import EpochResult, EpochRun, HapiClient
from repro_torch.cos.clock import DEFAULT_LOG_TAIL, Simulator
from repro_torch.cos.fleet import AutoscalePolicy, HapiFleet, TenantStats
from repro_torch.cos.network import (NetworkFabric, NetworkSpec, run_concurrently,
                               wan_link)
from repro_torch.cos.objectstore import ObjectStore, put_synthetic_dataset
from repro_torch.cos.server import PostRequest, PostResponse
from repro_torch.cos.weightcache import WeightCache


@dataclass(frozen=True)
class TenantSpec:
    """Everything the cluster needs to stand up one tenant's client.

    ``model`` names one of the paper's vision models
    (:data:`repro_torch.models.vision.PAPER_MODELS`) — its profile is built and
    cached by the cluster — or anything else if an explicit ``profile``
    is supplied."""
    model: str
    profile: Optional[LayerProfile] = None
    hapi: HapiConfig = field(default_factory=HapiConfig)
    tenant: Optional[int] = None          # auto-assigned when None
    # WAN link bytes/s; None uses hapi.network_bandwidth. Kept separate
    # from `hapi` so the split choice can model one bandwidth while the
    # wire runs another (paper Fig. 12's fast-testbed runs do exactly
    # that).
    bandwidth: Optional[float] = None
    client_flops: float = HW.peak_flops_bf16
    client_hbm: Optional[float] = None    # None -> HapiClient's default
    has_accelerator: bool = True
    straggler_factor: float = 3.0
    train_fn: Optional[Callable] = None
    push_training: bool = False           # ALL_IN_COS comparison mode
    n_classes: int = 1000                 # head size when profiling `model`
    # Contention-aware split re-decision: every k iterations re-run
    # Alg. 1 with the measured-bandwidth EWMA (0 = split fixed). Only
    # meaningful on a cluster with a shared network fabric.
    resplit_every: int = 0
    # Service class (QoS weight): this tenant's share of any contended
    # fabric link is proportional to its weight (gold=2 gets twice a
    # bronze=1 tenant's bandwidth under weighted max-min sharing, both
    # on the WAN trunk and for its storage-tier reads). Only meaningful
    # on a cluster with a shared network fabric.
    network_weight: float = 1.0
    # Service class on the *compute* side: weights the scheduler's
    # deficit-round-robin dispatch and the tenant's Eq. 4 batch share
    # when the COS accelerators, not the wire, are the scarce resource.
    # None adopts the network weight, so one service class shapes both
    # tiers unless explicitly decoupled.
    compute_weight: Optional[float] = None

    @property
    def effective_compute_weight(self) -> float:
        return self.network_weight if self.compute_weight is None \
            else self.compute_weight


@dataclass
class TenantHandle:
    """A tenant admitted to the cluster; thin wrapper over its client."""
    spec: TenantSpec
    client: HapiClient

    @property
    def tenant_id(self) -> int:
        return self.client.tenant

    def choose_split(self, train_batch: int) -> SplitDecision:
        return self.client.choose_split_for(train_batch)

    def run_epoch(self, dataset: str, train_batch: int, *, t0: float = 0.0,
                  max_iterations: Optional[int] = None) -> EpochResult:
        return self.client.run_epoch(dataset, train_batch, t0=t0,
                                     max_iterations=max_iterations)

    def start_epoch(self, dataset: str, train_batch: int, *, t0: float = 0.0,
                    max_iterations: Optional[int] = None) -> EpochRun:
        """A steppable epoch, for co-scheduled contended runs (see
        :meth:`HapiCluster.run_epochs`)."""
        return self.client.start_epoch(dataset, train_batch, t0=t0,
                                       max_iterations=max_iterations)

    def stats(self) -> Optional[TenantStats]:
        fleet = self.client.server
        return fleet.tenant_stats.get(self.tenant_id) \
            if isinstance(fleet, HapiFleet) else None


@dataclass
class ClusterReport:
    """Fleet-wide metrics snapshot (all times are virtual seconds)."""
    served: int
    makespan: float
    throughput: float                     # served samples / makespan
    n_alive: int
    n_servers: int
    reissued: int
    rejected: int
    served_by_server: Dict[int, int]
    tenant_throughput: Dict[int, float]
    scale_events: List[Tuple[float, str, str]]

    def as_dict(self) -> Dict[str, Any]:
        return {
            "served": self.served,
            "makespan": self.makespan,
            "throughput": self.throughput,
            "n_alive": self.n_alive,
            "n_servers": self.n_servers,
            "reissued": self.reissued,
            "rejected": self.rejected,
            "served_by_server": dict(self.served_by_server),
            "tenant_throughput": dict(self.tenant_throughput),
            "scale_events": [list(e) for e in self.scale_events],
        }


@dataclass
class _DatasetSpec:
    name: str
    columns: Optional[Dict[str, np.ndarray]]
    n_samples: int
    object_size: int
    img_bytes: Optional[int]
    n_classes: int
    content_seed: int


class HapiCluster:
    """Builder + facade for a full HAPI deployment (see module docstring)."""

    def __init__(self, seed: int = 0) -> None:
        self.seed = seed
        self._n_servers = 2
        self._server_kwargs: Dict[str, Any] = {}
        self._storage_kwargs: Dict[str, Any] = {}
        self._scheduler: Optional[SchedulerPolicy] = None
        self._coalescing = False
        self._weight_cache: Optional[WeightCache] = None
        self._routing: Optional[RoutingPolicy] = None
        self._placement: Optional[PlacementPolicy] = None
        self._scaling: Optional[ScalingPolicy] = None
        self._autoscale: Optional[AutoscalePolicy] = None
        self._datasets: List[_DatasetSpec] = []
        self._executors: Dict[str, Callable] = {}
        self._profiles: Dict[Tuple[str, int], LayerProfile] = {}
        self._next_tenant = 0
        # Burst request ids live far above any client-issued id (clients
        # number from tenant * 1_000_000, + 500_000 for re-issues), so the
        # two facade entry points can share one fleet without collisions.
        self._next_req = 1_000_000_000
        self._tenants: Dict[int, TenantHandle] = {}
        self._fleet: Optional[HapiFleet] = None
        self._network: Optional[NetworkSpec] = None
        self._fabric: Optional[NetworkFabric] = None
        self._tracing = True
        self._retention = "full"
        self._log_tail = DEFAULT_LOG_TAIL
        self._return_path = False
        self._return_bandwidth: Optional[float] = None

    # -- builder ---------------------------------------------------------------
    def _check_mutable(self, what: str) -> None:
        if self._fleet is not None:
            raise RuntimeError(
                f"{what} must be configured before the cluster is built")

    def with_servers(self, n: int, **server_kwargs) -> "HapiCluster":
        """Fleet size + per-replica knobs (``n_accelerators``,
        ``flops_per_accel``, ``hbm_per_accel``, ...)."""
        self._check_mutable("with_servers")
        self._n_servers = n
        self._server_kwargs.update(server_kwargs)
        return self

    def with_storage(self, n_nodes: int = 3, replication: int = 3,
                     internal_bandwidth: float = 5e9) -> "HapiCluster":
        self._check_mutable("with_storage")
        self._storage_kwargs = dict(
            n_storage_nodes=n_nodes, replication=replication,
            internal_bandwidth=internal_bandwidth)
        return self

    def with_fair_queueing(self, enabled: bool) -> "HapiCluster":
        """Deprecated alias for :meth:`with_scheduler` (one release of
        compat): True -> weighted deficit round-robin (the default),
        False -> FIFO arrival order."""
        warnings.warn(
            "HapiCluster.with_fair_queueing is deprecated; use "
            "with_scheduler(WdrrScheduling()) / "
            "with_scheduler(FifoScheduling()) instead",
            DeprecationWarning, stacklevel=2)
        return self.with_scheduler(
            WdrrScheduling() if enabled else FifoScheduling())

    def with_scheduler(self, policy: Optional[SchedulerPolicy] = None, *,
                       coalescing: Optional[bool] = None) -> "HapiCluster":
        """Compute-tier scheduling: the dispatch/admission policy
        (:class:`~repro_torch.cos.scheduler.WdrrScheduling` weighted deficit
        round-robin by default, :class:`~repro_torch.cos.scheduler.FifoScheduling`
        for arrival order) and the cross-server batch coalescer
        (``coalescing=True`` ships queued requests to replicas already
        holding their model loaded, cutting stateless reload bytes)."""
        self._check_mutable("with_scheduler")
        if policy is not None:
            self._scheduler = policy
        if coalescing is not None:
            self._coalescing = coalescing
        return self

    def with_weight_cache(self, window: float = 2.0,
                          policy="lru") -> "HapiCluster":
        """Enable the fleet-wide warm-weight cache
        (:class:`~repro_torch.cos.weightcache.WeightCache`): model weights
        stay resident on their accelerator for ``window`` virtual
        seconds past the last warm use, charged against that HBM budget
        (Eq. 4 admission plans around them) and evicted under pressure
        in ``policy`` order (``"lru"`` / ``"demand"``, or an eviction
        policy instance). Pair with ``with_routing(WarmAwareRouting())``
        to route requests *to* the warm bytes. Off by default — the
        cache-less event logs stay byte-identical."""
        self._check_mutable("with_weight_cache")
        self._weight_cache = WeightCache(window=window, policy=policy)
        return self

    def with_network(self, spec: Optional[NetworkSpec] = None,
                     **kwargs) -> "HapiCluster":
        """Put every tenant NIC and storage-node link on a shared
        :class:`~repro_torch.cos.network.NetworkFabric` (flow-level max-min
        bandwidth sharing on the WAN egress trunk) instead of private
        fixed-bandwidth links. ``kwargs`` build a
        :class:`~repro_torch.cos.network.NetworkSpec` when no spec is given."""
        self._check_mutable("with_network")
        self._network = spec if spec is not None else NetworkSpec(**kwargs)
        return self

    def with_routing(self, policy: RoutingPolicy) -> "HapiCluster":
        self._check_mutable("with_routing")
        self._routing = policy
        return self

    def with_placement(self, policy: PlacementPolicy) -> "HapiCluster":
        self._check_mutable("with_placement")
        self._placement = policy
        return self

    def with_scaling(self, policy: ScalingPolicy) -> "HapiCluster":
        self._check_mutable("with_scaling")
        self._scaling = policy
        return self

    def with_policies(self, *, routing: Optional[RoutingPolicy] = None,
                      placement: Optional[PlacementPolicy] = None,
                      scaling: Optional[ScalingPolicy] = None) -> "HapiCluster":
        if routing is not None:
            self.with_routing(routing)
        if placement is not None:
            self.with_placement(placement)
        if scaling is not None:
            self.with_scaling(scaling)
        return self

    def with_autoscale(self, policy: Optional[AutoscalePolicy] = None,
                       **kwargs) -> "HapiCluster":
        """Queue-depth autoscaling via the back-compat parameter block
        (use :meth:`with_scaling` for any other strategy)."""
        self._check_mutable("with_autoscale")
        self._autoscale = policy if policy is not None else AutoscalePolicy(**kwargs)
        return self

    def with_dataset(self, name: str,
                     columns: Optional[Dict[str, np.ndarray]] = None, *,
                     n_samples: int = 8000, object_size: int = 1000,
                     img_bytes: Optional[int] = 110_000,
                     n_classes: int = 1000,
                     content_seed: int = 0) -> "HapiCluster":
        """Register a dataset. With ``columns`` the given arrays are stored
        (live mode reads the real payload); without, a synthetic
        ImageNet-shaped workload is generated — tiny arrays whose on-wire
        size is forced to ``img_bytes`` per sample, the paper's ~110 KB
        (pass ``img_bytes=None`` to keep true payload sizes)."""
        spec = _DatasetSpec(name, columns, n_samples, object_size,
                            img_bytes, n_classes, content_seed)
        if self._fleet is not None:
            self._put(spec)
        else:
            self._datasets.append(spec)
        return self

    def with_tracing(self, enabled: bool) -> "HapiCluster":
        """Toggle structured-span collection (:class:`repro_torch.obs.Tracer`).
        On by default — tracing is purely additive, the golden event-log
        digests are byte-identical either way; turn it off only for
        maximum-throughput sweeps. Metrics stay on regardless (reports
        and benchmarks read them)."""
        self._check_mutable("with_tracing")
        self._tracing = enabled
        return self

    def with_retention(self, mode: str,
                       tail: int = DEFAULT_LOG_TAIL) -> "HapiCluster":
        """Event-log retention policy. ``"full"`` (default) keeps every
        event materialized — golden digests, replay recording and
        post-hoc log mining all work. ``"compact"`` keeps a bounded tail
        (``tail`` events) plus a streaming digest and O(1) per-kind
        counters, and bounds the tracer — the scale-out mode for
        100s-of-replicas sweeps where the full log would dominate RSS.
        Same seed in either mode produces identical ``stream_digest()``,
        metrics totals and replay decisions."""
        self._check_mutable("with_retention")
        if mode not in ("full", "compact"):
            raise ValueError(f"retention must be 'full' or 'compact', "
                             f"got {mode!r}")
        self._retention = mode
        self._log_tail = tail
        return self

    def with_return_path(self, enabled: bool = True,
                         bandwidth: Optional[float] = None) -> "HapiCluster":
        """Model the burst return path: after each drain round the served
        activation bytes are pulled back over the tenants' NICs (and the
        shared trunk under :meth:`with_network`) as concurrent flows,
        extending per-tenant finish times and spans. Off by default —
        the historical model hands activations over for free."""
        self._check_mutable("with_return_path")
        self._return_path = enabled
        self._return_bandwidth = bandwidth
        return self

    def with_executor(self, model_key: str, fn: Callable) -> "HapiCluster":
        """Register a live forward ``fn(payload, split, cos_batch)``
        fleet-wide (current and future replicas): a torch forward that
        runs on the card and returns host arrays, such as
        ``core.tier_split.make_vision_executor(vm, compress=...)``."""
        self._executors[model_key] = fn
        if self._fleet is not None:
            self._fleet.register_executor(model_key, fn)
        return self

    # -- lifecycle -------------------------------------------------------------
    def build(self) -> "HapiCluster":
        """Materialize the deployment; idempotent."""
        if self._fleet is not None:
            return self
        sim = Simulator(self.seed, retention=self._retention,
                        log_tail=self._log_tail)
        sim.tracer.enabled = self._tracing
        store = ObjectStore(placement=self._placement, **self._storage_kwargs)
        self._fleet = HapiFleet(
            store, n_servers=self._n_servers, sim=sim,
            scheduler=self._scheduler, coalescing=self._coalescing,
            weight_cache=self._weight_cache,
            autoscale=self._autoscale,
            routing=self._routing, placement=self._placement,
            scaling=self._scaling,
            return_path=self._return_path,
            return_bandwidth=self._return_bandwidth,
            **self._server_kwargs,
        )
        if self._network is not None:
            self._fabric = NetworkFabric(self._network, sim=sim)
            store.use_fabric(self._fabric)
        for spec in self._datasets:
            self._put(spec)
        for key, fn in self._executors.items():
            self._fleet.register_executor(key, fn)
        return self

    def _put(self, spec: _DatasetSpec) -> None:
        store = self.store
        if spec.columns is not None:
            store.put_dataset(spec.name, spec.columns,
                              object_size=spec.object_size)
            return
        put_synthetic_dataset(store, spec.name, n_samples=spec.n_samples,
                              object_size=spec.object_size,
                              img_bytes=spec.img_bytes,
                              n_classes=spec.n_classes,
                              seed=spec.content_seed)

    @property
    def fleet(self) -> HapiFleet:
        self.build()
        return self._fleet

    @property
    def sim(self) -> Simulator:
        return self.fleet.sim

    @property
    def store(self) -> ObjectStore:
        return self.fleet.store

    @property
    def fabric(self) -> Optional[NetworkFabric]:
        """The shared network fabric, or None when tenants own private
        links (no :meth:`with_network`)."""
        self.build()
        return self._fabric

    # -- model registry --------------------------------------------------------
    def profile(self, model_key: str, n_classes: int = 1000) -> LayerProfile:
        """Cached per-layer profile: one of the paper's vision models
        (:data:`repro_torch.models.vision.PAPER_MODELS`), or any architecture
        from the config registry (:data:`repro_torch.configs.ARCH_IDS`) via
        the analytic LM profiler — that is what lets benchmarks build a
        multi-model catalog from ``src/repro_torch/configs/``. A vision
        model is built on ``device="meta"``: profiling reads shapes only,
        so no weights are drawn and no card is needed."""
        key = (model_key, n_classes)
        if key not in self._profiles:
            from repro_torch.models.vision import PAPER_MODELS

            if model_key in PAPER_MODELS:
                self._profiles[key] = profile_layered(
                    PAPER_MODELS[model_key](n_classes, device="meta"))
            else:
                from repro_torch.configs import get_config
                from repro_torch.core.profiler import profile_lm

                self._profiles[key] = profile_lm(get_config(model_key),
                                                 seq_len=512)
        return self._profiles[key]

    @property
    def weight_cache(self) -> Optional[WeightCache]:
        """The fleet's warm-weight cache (None unless enabled)."""
        return self._weight_cache

    def split_for(self, model_key: str, train_batch: int,
                  hapi: Optional[HapiConfig] = None,
                  n_classes: int = 1000) -> SplitDecision:
        return choose_split(self.profile(model_key, n_classes),
                            hapi or HapiConfig(), train_batch)

    # -- tenants ---------------------------------------------------------------
    def tenant(self, spec: TenantSpec) -> TenantHandle:
        """Admit a tenant: build its profile, split choice and client."""
        self.build()
        tid = spec.tenant
        if tid is None:
            tid = self._next_tenant
        self._next_tenant = max(self._next_tenant, tid) + 1
        prof = spec.profile or self.profile(spec.model, spec.n_classes)
        # NIC rate: the tenant's own bandwidth, nominal otherwise; on a
        # fabric cluster the link is a port on the shared trunk.
        bw = spec.bandwidth if spec.bandwidth is not None \
            else spec.hapi.network_bandwidth
        link = wan_link(tid, bw, self._fabric, weight=spec.network_weight)
        extra = {}
        if spec.client_hbm is not None:
            extra["client_hbm"] = spec.client_hbm
        client = HapiClient(
            self._fleet, link, prof, spec.hapi, spec.model, tenant=tid,
            client_flops=spec.client_flops,
            has_accelerator=spec.has_accelerator,
            straggler_factor=spec.straggler_factor,
            train_fn=spec.train_fn, push_training=spec.push_training,
            resplit_every=spec.resplit_every,
            network_weight=spec.network_weight,
            compute_weight=spec.effective_compute_weight,
            **extra,
        )
        # Pin the tenant's compute class on the fleet scheduler so WDRR
        # dispatch weights it even across re-issues and mixed workloads.
        self._fleet.scheduler.set_weight(tid, spec.effective_compute_weight)
        handle = TenantHandle(spec=spec, client=client)
        self._tenants[tid] = handle
        return handle

    @property
    def tenants(self) -> Dict[int, TenantHandle]:
        return dict(self._tenants)

    def run_epochs(self, jobs: List[Tuple[TenantHandle, str, int]], *,
                   t0: float = 0.0,
                   max_iterations: Optional[int] = None) -> List[EpochResult]:
        """Run several tenants' epochs *concurrently* in virtual time:
        each ``(handle, dataset, train_batch)`` job becomes a steppable
        :class:`~repro_torch.cos.client.EpochRun` and the least-advanced tenant
        always steps next, so their transfers contend on the shared
        fabric the way §7.7's testbed tenants do. Results are returned
        in job order. (Sequential ``run_epoch`` calls would serialize
        the epochs instead — fine for throughput accounting, but no
        interference is expressible that way.)"""
        self.build()
        runs = [h.start_epoch(ds, tb, t0=t0, max_iterations=max_iterations)
                for (h, ds, tb) in jobs]
        return run_concurrently(runs)

    # -- benchmark-style raw workloads ----------------------------------------
    def submit_burst(self, dataset: str, model_key: str, *, tenant: int,
                     train_batch: int = 1000,
                     hapi: Optional[HapiConfig] = None,
                     split: Optional[int] = None,
                     jitter: float = 0.005,
                     b_max: Optional[int] = None,
                     adaptable: bool = True,
                     limit: Optional[int] = None,
                     n_classes: int = 1000,
                     network_weight: float = 1.0,
                     compute_weight: Optional[float] = None) -> List[int]:
        """Submit one POST per object of ``dataset`` (first ``limit`` of
        them if given) for ``tenant`` — the burst workload of the serving
        driver and the scaling benchmark. Arrival is a single seeded-RNG
        jitter per burst; the split is Alg. 1's unless given; ``b_max`` /
        ``adaptable=False`` pin the COS batch (the paper's BA-off
        comparison); ``compute_weight`` is the burst's accelerator
        service class (defaults to ``network_weight``, mirroring
        :attr:`TenantSpec.compute_weight`). Returns the request ids."""
        self.build()
        if compute_weight is None:
            compute_weight = network_weight
        if compute_weight <= 0:
            raise ValueError(
                f"compute weight must be > 0, got {compute_weight}")
        hapi = hapi or HapiConfig()
        prof = self.profile(model_key, n_classes)
        if split is None:
            split = choose_split(prof, hapi, train_batch).split_index
        if b_max is None:
            b_max = min(train_batch, hapi.cos_batch)
        arrival = float(self.sim.rng.uniform(0.0, jitter)) if jitter else 0.0
        ids = []
        for oname in self.store.object_names(dataset)[:limit]:
            self._next_req += 1
            req = PostRequest(
                req_id=self._next_req, tenant=tenant, model_key=model_key,
                split=split, object_name=oname, b_max=b_max, profile=prof,
                arrival=arrival, compress=hapi.compress_transfer,
                adaptable=adaptable, network_weight=network_weight,
                compute_weight=compute_weight,
            )
            self._fleet.submit(req)
            ids.append(req.req_id)
        return ids

    def submit_request(self, object_name: str, model_key: str, *,
                       tenant: int, arrival: float = 0.0,
                       train_batch: int = 1000,
                       hapi: Optional[HapiConfig] = None,
                       split: Optional[int] = None,
                       b_max: Optional[int] = None,
                       adaptable: bool = True,
                       n_classes: int = 1000,
                       network_weight: float = 1.0,
                       compute_weight: Optional[float] = None) -> int:
        """Submit a single POST for one object at an explicit arrival
        time — the open-loop entry point catalog-scale benchmarks drive
        (each request carries its own model and arrival, unlike
        :meth:`submit_burst`'s one-model one-jitter burst). Returns the
        request id."""
        self.build()
        if compute_weight is None:
            compute_weight = network_weight
        if compute_weight <= 0:
            raise ValueError(
                f"compute weight must be > 0, got {compute_weight}")
        hapi = hapi or HapiConfig()
        prof = self.profile(model_key, n_classes)
        if split is None:
            split = choose_split(prof, hapi, train_batch).split_index
        if b_max is None:
            b_max = min(train_batch, hapi.cos_batch)
        self._next_req += 1
        req = PostRequest(
            req_id=self._next_req, tenant=tenant, model_key=model_key,
            split=split, object_name=object_name, b_max=b_max, profile=prof,
            arrival=float(arrival), compress=hapi.compress_transfer,
            adaptable=adaptable, network_weight=network_weight,
            compute_weight=compute_weight,
        )
        self._fleet.submit(req)
        return req.req_id

    def drain(self, now: float = 0.0) -> List[PostResponse]:
        """Serve everything pending/in-flight across the fleet."""
        return self.fleet.drain(now=now)

    # -- fleet control ---------------------------------------------------------
    def kill(self, server_id: int) -> None:
        self.fleet.kill(server_id)

    def restart(self, server_id: int) -> None:
        self.fleet.restart(server_id)

    @property
    def n_alive(self) -> int:
        return self.fleet.n_alive

    # -- metrics ---------------------------------------------------------------
    def report(self) -> ClusterReport:
        fleet = self.fleet
        served = fleet.served_total()
        samples = sum(ts.samples for ts in fleet.tenant_stats.values())
        makespan = fleet.makespan()
        return ClusterReport(
            served=served,
            makespan=makespan,
            throughput=samples / makespan if makespan > 0 else 0.0,
            n_alive=fleet.n_alive,
            n_servers=len(fleet.servers),
            reissued=fleet.reissued,
            rejected=len(fleet.rejected),
            served_by_server=dict(sorted(fleet.served_by_server.items())),
            tenant_throughput={t: s.throughput
                               for t, s in sorted(fleet.tenant_stats.items())},
            scale_events=fleet.scale_events(),
        )

    @property
    def tracer(self):
        """The cluster-wide :class:`repro_torch.obs.Tracer` (structured spans;
        export with :func:`repro_torch.obs.write_trace`)."""
        return self.sim.tracer

    def metrics(self):
        """The cluster-wide :class:`repro_torch.obs.MetricsRegistry` — query
        with ``total()``/``percentile()`` or snapshot with
        ``snapshot()``/``dump()``."""
        return self.sim.metrics

    def event_digest(self) -> Tuple[Tuple[float, str, str], ...]:
        """Hashable event-log snapshot for determinism checks."""
        return self.fleet.sim.log.digest()
