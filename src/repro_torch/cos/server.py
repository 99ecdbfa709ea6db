"""The Hapi server (paper §5.2/§5.5/§6) — stateless, queue-driven, with
batch adaptation per accelerator.

A copy of ``repro/cos/server.py``: the virtual-clock arithmetic runs
operation for operation as there, so a server of either package given the
same profile and constants logs the same events at the same times. The
defaults are the port's ``HW`` (one H100); the modelling constants
(``mxu_efficiency``, the fill term of 128 rows) stay the reference's.

Requests are lightweight fixed-size POSTs. The server:
  1. waits a small window for request coalescing,
  2. runs Eq. 4 batch adaptation over the queue per accelerator
     (admitted requests get a COS batch size; overflow defers),
  3. reads the objects from the storage nodes (replica-balanced; on a
     shared network fabric the round's reads resolve as one concurrent
     batch, sharing contended storage links weighted by tenant class),
  4. executes feature extraction up to the split index — real compute on
     the card when an executor is registered (such as
     ``core.tier_split.make_vision_executor``), always charged on the
     virtual clock from profiled FLOPs,
  5. emits the split-layer activations for the client to pull.

Statelessness (the paper's design): nothing survives between requests —
models are "re-loaded" (charged) per request, so any server can be
restarted or horizontally scaled by just adding queues. ``kill()`` +
``restart()`` in tests exercise exactly that.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.config import HW
from repro_torch.core.batch_adapt import AdaptRequest, AdaptResult, adapt_batches
from repro_torch.core.profiler import LayerProfile
from repro_torch.cos.clock import Accelerator, EventLog, Simulator
from repro_torch.cos.objectstore import ObjectStore
from repro_torch.cos.scheduler import ComputeScheduler
from repro_torch.kernels.ops import INT8_WIRE_RATIO


@dataclass(slots=True)
class PostRequest:
    req_id: int
    tenant: int
    model_key: str
    split: int
    object_name: str
    b_max: int
    profile: LayerProfile
    arrival: float
    compress: bool = False
    adaptable: bool = True      # False: ALL_IN_COS — batch cannot shrink
    network_weight: float = 1.0  # tenant service class (weighted fabric share)
    compute_weight: float = 1.0  # tenant service class on the accelerators
                                 # (WDRR dispatch + class-aware Eq. 4)
    span_id: int = -1            # root span of the request's causal tree
                                 # (set by fleet intake; -1 = untraced)


@dataclass(slots=True)
class PostResponse:
    req_id: int
    tenant: int
    object_name: str
    acts: Optional[Any]            # live activations (or None in timing mode)
    act_bytes: float
    cos_batch: int
    arrival: float
    started: float
    finished: float
    server_id: int = 0             # replica that served the request
    span_id: int = -1              # causal-tree root carried from the request
    delivered: Optional[float] = None  # return-path wire completion (None
                                       # unless the fleet models delivery)

    @property
    def queue_delay(self) -> float:
        return self.started - self.arrival


class TenantQueue(List[PostRequest]):
    """A request queue (list-compatible: the scheduler removes served
    requests in place, rebalancing pops, kill clears) that additionally
    maintains per-tenant depth counters, so the routing hot path's
    ``tenant_queue_depth`` — called once per candidate replica per
    request — is an O(1) dict lookup instead of an O(queue) scan."""

    __slots__ = ("_by_tenant",)

    def __init__(self) -> None:
        super().__init__()
        self._by_tenant: Dict[int, int] = {}

    def append(self, req: PostRequest) -> None:
        bt = self._by_tenant
        bt[req.tenant] = bt.get(req.tenant, 0) + 1
        list.append(self, req)

    def remove(self, req: PostRequest) -> None:
        list.remove(self, req)
        self._by_tenant[req.tenant] -= 1

    def pop(self, index: int = -1) -> PostRequest:
        req = list.pop(self, index)
        self._by_tenant[req.tenant] -= 1
        return req

    def clear(self) -> None:
        list.clear(self)
        self._by_tenant.clear()

    def tenant_depth(self, tenant: int) -> int:
        return self._by_tenant.get(tenant, 0)


class _Lease(NamedTuple):
    end: float
    nbytes: float
    accel: int
    # What the lease holds resident: while active, requests for the same
    # model with a split no deeper than `split` find the weights already
    # in HBM — the coalescer's "warm replica" signal. (NamedTuple: one
    # lease per executed request, never mutated — tuple construction is
    # far cheaper than a dataclass __init__ on the serve hot path.)
    model_key: str = ""
    split: int = 0
    # Model-prefix bytes inside `nbytes` that the warm-weight cache may
    # retain when the lease expires (0.0: nothing to retain — either the
    # cache is off, or the request rode an existing cache entry and only
    # unpins it on expiry).
    model_bytes: float = 0.0


class HapiServer:
    def __init__(
        self,
        store: ObjectStore,
        n_accelerators: int = 2,
        hbm_per_accel: float = HW.hbm_capacity,
        flops_per_accel: float = HW.peak_flops_bf16,
        wait_window: float = 0.01,
        b_min: int = 25,               # paper §5.5
        decoupled: bool = True,        # Table 3: proxy-embedded vs decoupled
        mxu_efficiency: float = 0.4,
        server_id: int = 0,
        sim: Optional[Simulator] = None,
        scheduler: Optional[ComputeScheduler] = None,
    ) -> None:
        self.store = store
        # Admission/dispatch live in the ComputeScheduler subsystem; a
        # fleet shares one across its replicas, a bare server owns one.
        self.scheduler = scheduler if scheduler is not None \
            else ComputeScheduler()
        self.server_id = server_id
        self.sim = sim
        self.accels = [
            Accelerator(name=f"s{server_id}-accel{i}", flops=flops_per_accel,
                        hbm=hbm_per_accel, sim=sim)
            for i in range(n_accelerators)
        ]
        self.wait_window = wait_window
        self.b_min = b_min
        self.decoupled = decoupled
        self.mxu_efficiency = mxu_efficiency
        self.queue: TenantQueue = TenantQueue()
        self.leases: List[_Lease] = []
        # Warm-lease index by model_key: `ComputeScheduler._warm` used to
        # rescan every active lease per queued request per drain round —
        # O(queue x leases) at fleet scale. The index is maintained on
        # lease grant (`_execute`) and expiry (`_free_expired`); the
        # length check in `warm_leases` catches out-of-band mutation
        # (tests appending to `leases` directly) and rebuilds.
        self.lease_index: Dict[str, List[_Lease]] = {}
        self._lease_index_n = 0
        # Served responses a *different* caller drained on the owner's
        # behalf (shared-server bursts): clients stash strangers here and
        # claim their own, so no response is ever silently dropped. Lives
        # on the server because it is the rendezvous all tenants share.
        self.unclaimed: Dict[int, PostResponse] = {}
        self.executors: Dict[str, Callable] = {}
        # The private per-server log adopts the shared simulator's
        # retention mode: a compact fleet must not regrow unbounded
        # traces one replica at a time. The per-replica tail is kept
        # small — at 100s of replicas, N x tail dominates the shared
        # log's own window otherwise.
        self.log = EventLog(retention=sim.log.retention,
                            tail=min(sim.log.tail, 32)
                            if sim.log.retention == "compact"
                            else sim.log.tail) if sim is not None \
            else EventLog()
        # Adaptation history: full list by default (Table 5 stats read
        # it); a compact-retention fleet keeps a bounded recent window —
        # per-replica unbounded growth defeats the bounded log.
        compact = sim is not None and sim.log.retention == "compact"
        self.adapt_results = deque(maxlen=64) if compact else []
        self._rr = 0
        self.alive = True

    # -- model execution registry (live mode) --------------------------------
    def register_executor(self, model_key: str, fn: Callable) -> None:
        """fn(payload: dict of np arrays, split: int, cos_batch: int) -> acts,
        a host array or a tuple, list or dict of them (int8 leaves count
        as the measured wire)."""
        self.executors[model_key] = fn

    # -- fault tolerance -------------------------------------------------------
    def kill(self) -> None:
        """Crash: the queue is lost (clients re-issue), leases vanish —
        and so does every warm-weight cache entry on this replica's HBM."""
        self.alive = False
        self.queue.clear()
        self.leases.clear()
        self.lease_index.clear()
        self._lease_index_n = 0
        cache = getattr(self.scheduler, "cache", None)
        if cache is not None:
            cache.drop_server(self)
        for a in self.accels:
            a.mem_used = 0.0

    def restart(self) -> None:
        self.alive = True  # stateless: nothing to recover

    # -- request intake ----------------------------------------------------------
    def submit(self, req: PostRequest) -> None:
        if not self.alive:
            raise ConnectionError("hapi server down")
        self.queue.append(req)

    # -- serving -------------------------------------------------------------------
    def _free_expired(self, t: float) -> None:
        cache = getattr(self.scheduler, "cache", None)
        kept = []
        expired = False
        for lease in self.leases:
            if lease.end <= t:
                # Warm-weight cache: ownership of the model-prefix bytes
                # can transfer from the lease to a cache entry — only the
                # remainder (activations + non-retained model bytes) is
                # freed. With the cache off, retained is 0 and this is
                # the historical full free.
                retained = cache.on_lease_expired(self, lease, t) \
                    if cache is not None else 0.0
                self.accels[lease.accel].free(lease.nbytes - retained)
                expired = True
            else:
                kept.append(lease)
        self.leases = kept
        if expired:
            self._rebuild_lease_index()

    def _rebuild_lease_index(self) -> None:
        idx: Dict[str, List[_Lease]] = {}
        for lease in self.leases:
            idx.setdefault(lease.model_key, []).append(lease)
        self.lease_index = idx
        self._lease_index_n = len(self.leases)

    def warm_leases(self, model_key: str) -> List[_Lease]:
        """Active leases holding ``model_key`` resident (possibly empty).
        O(1) lookup on the scheduler hot path; the length check repairs
        the index after out-of-band `leases` mutation."""
        if self._lease_index_n != len(self.leases):
            self._rebuild_lease_index()
        return self.lease_index.get(model_key, [])

    def drain(self, now: float = 0.0) -> List[PostResponse]:
        """Serve everything currently queued; returns responses (virtual-
        clock timed). Repeated batch-adaptation rounds (paper: removed
        requests 'become part of the next batch assignment round')."""
        responses: List[PostResponse] = []
        guard = 0
        while self.queue and self.alive:
            guard += 1
            assert guard < 10_000, "scheduler livelock"
            served, now = self.drain_round(now)
            responses.extend(served)
        return responses

    def drain_round(self, now: float = 0.0) -> Tuple[List[PostResponse], float]:
        """One coalescing-window + batch-adaptation scheduling round,
        delegated to the :class:`~repro_torch.cos.scheduler.ComputeScheduler`
        (which owns wait-window admission, class-aware Eq. 4 planning
        and queue-order execution).

        Returns ``(responses, next_now)``. The fleet steps replicas one
        round at a time so control events (kills, restarts, autoscaling)
        interleave with serving in deterministic event order; a bare
        server just loops this inside :meth:`drain`.
        """
        return self.scheduler.server_round(self, now)

    def adapt(self, requests: List[AdaptRequest], budget: float) -> AdaptResult:
        """Run Eq. 4 batch adaptation for one accelerator's round with
        this server's floor, recording the result (Table 5 stats)."""
        res = adapt_batches(requests, budget, b_min=self.b_min)
        self.adapt_results.append(res)
        return res

    def _mem_per_sample(self, req: PostRequest) -> float:
        """Forward working set; if training layers are pushed down
        (ALL_IN_COS), backward keeps every trained layer's activations
        resident (paper Fig. 4) — this is what kills COS concurrency."""
        prof = req.profile
        m = prof.act_peak_bytes[req.split]
        fz = prof.freeze_index
        if req.split > fz:
            m += sum(prof.out_bytes[fz + 1 : req.split + 1])
        return m * (1 + prof.headroom)

    def _execute(self, req: PostRequest, cos_batch: int, mem: float,
                 accel_idx: int, t: float,
                 pre_read: Optional[Tuple[Any, float]] = None,
                 charge_load: bool = True,
                 model_bytes: float = 0.0) -> PostResponse:
        accel = self.accels[accel_idx]
        obj, t_data = pre_read if pre_read is not None \
            else self.store.read(req.object_name, t, parent=req.span_id)

        n = obj.n_samples
        prof = req.profile
        # Per-request FLOPs: forward-only feature extraction up to the
        # freeze index; anything pushed down beyond it is *training*
        # (fwd+bwd, 3x) — this is what makes ALL_IN_COS fail to scale
        # (paper §5.1/§7.5).
        fz = min(req.split, prof.freeze_index)
        flops = prof.cum_flops[fz] * n
        if req.split > fz:
            flops += 3.0 * (prof.cum_flops[req.split] - prof.cum_flops[fz]) * n
        # Stateless model (re)load charged as HBM writes — skipped when
        # the coalescer found the model warm on this accelerator.
        load_time = (prof.prefix_param_bytes[req.split] / HW.hbm_bandwidth
                     if charge_load else 0.0)
        eff = self.mxu_efficiency if self.decoupled else self.mxu_efficiency * 0.55
        # Small COS batches under-fill the MXU (replaces paper assumption 4).
        eff *= min(1.0, cos_batch / 128.0)
        start, end = accel.compute(max(t_data, t), flops + 1e3, efficiency=eff)
        t_compute_end = end
        end += load_time
        # Eq. 4's whole point is that admission provably fits the HBM
        # budget; a failed allocation here means the adaptation invariant
        # broke upstream and must never be executed through silently.
        # (The allocation stays outside the assert so `python -O` still
        # accounts the memory.)
        allocated = accel.try_alloc(mem)
        assert allocated, (
            f"batch adaptation overcommitted {accel.name}: "
            f"alloc {mem:.3e} B with {accel.mem_used:.3e}/{accel.hbm:.3e} used"
        )
        lease = _Lease(end=end, nbytes=mem, accel=accel_idx,
                       model_key=req.model_key, split=req.split,
                       model_bytes=model_bytes)
        self.leases.append(lease)
        self.lease_index.setdefault(req.model_key, []).append(lease)
        self._lease_index_n += 1

        acts = None
        act_bytes = prof.out_bytes[req.split] * n
        quantized = False
        if req.model_key in self.executors:
            acts = self.executors[req.model_key](obj.payload, req.split, cos_batch)
            leaves = [np.asarray(a) for a in _leaves(acts)]
            act_bytes = float(sum(a.nbytes for a in leaves))
            # A live extract fn that already quantized (int8 + scales
            # leaves) produced the actual wire payload: its measured
            # nbytes IS the wire size. Applying the ratio again would
            # double-discount the transfer.
            quantized = any(a.dtype == np.int8 for a in leaves)
        if req.compress and not quantized:
            # The single authoritative int8(+per-tile scales) ratio —
            # identical to what Algorithm 1 predicted for this request
            # (see repro_torch.kernels.ops.compression_ratio).
            act_bytes *= INT8_WIRE_RATIO
        self.log.add(end, "served", f"{req.object_name} b={cos_batch}")
        if self.sim is not None:
            self.sim.record(end, "served",
                            f"s{self.server_id} t{req.tenant} "
                            f"{req.object_name} b={cos_batch}")
            tr = self.sim.tracer
            # emit_fast: these spans parent nothing (ids unused), so the
            # deferred path — one raw tuple now, Span construction and
            # validation on first query — keeps per-request tracing off
            # the serve hot loop. Materialization preserves order, so
            # digests match the eager path.
            tr.emit_fast("cos.compute", start, t_compute_end, "compute",
                         accel.name, parent=req.span_id,
                         labels=(("tenant", str(req.tenant)),
                                 ("model", req.model_key),
                                 ("split", str(req.split)),
                                 ("batch", str(cos_batch))))
            if load_time > 0.0:
                tr.emit_fast("model.load", t_compute_end, end, "compute",
                             accel.name, parent=req.span_id,
                             labels=(("model", req.model_key),))
            if req.compress and not quantized:
                tr.emit_fast("quantize", end, end, "compute",
                             accel.name, parent=req.span_id)
            mx = self.sim.metrics
            mx.observe("stage_seconds", end - start, stage="compute")
        return PostResponse(
            req_id=req.req_id, tenant=req.tenant, object_name=req.object_name,
            acts=acts, act_bytes=act_bytes, cos_batch=cos_batch,
            arrival=req.arrival, started=start, finished=end,
            server_id=self.server_id, span_id=req.span_id,
        )

    # -- metrics -----------------------------------------------------------------
    def gpu_memory_peak(self) -> float:
        return max((l.nbytes for l in self.leases), default=0.0)

    def queue_depth(self) -> int:
        """Routing/autoscaling signal: requests waiting on this replica."""
        return len(self.queue)

    def tenant_queue_depth(self, tenant: int) -> int:
        """Routing signal: this tenant's requests waiting on this replica
        (tenant-spreading routers keep it low on every replica). O(1):
        the queue maintains per-tenant counters."""
        return self.queue.tenant_depth(tenant)


def _leaves(x) -> list:
    """The leaves of an executor's result in ``jax.tree.leaves``' order:
    tuples and lists in order, dicts by sorted key, ``None`` empty. An
    executor returns host arrays; a tensor on the card is refused here
    rather than copied back behind the caller's back."""
    if x is None:
        return []
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    if getattr(x, "is_cuda", False):
        raise TypeError(
            f"an executor returned a tensor on {x.device}; it must return "
            f"host arrays (numpy), as make_vision_executor does")
    return [x]
