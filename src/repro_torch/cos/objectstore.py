"""Simulated cloud object store (Swift-like: proxy + replicated storage
nodes, fixed-size objects), with numpy payloads on the host.

A copy of ``repro/cos/objectstore.py``: the same reads, replica choice,
re-replication and event records, so a store of either package gives the
same bytes and the same trace.

Datasets are stored as equal-sized chunks (paper: 1000 images per object,
chosen to avoid small requests [40]). The proxy reads objects from storage
nodes over a fast internal network; the *external* link to the compute
tier is the bottleneck the whole system is built around.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cos.clock import Link, Simulator


@dataclass
class StoredObject:
    name: str
    payload: dict                  # column -> np.ndarray (leading dim = samples)
    nbytes: int
    n_samples: int


class ObjectStore:
    """``placement`` is any object with an
    ``initial(index, n_nodes, replication) -> List[int]`` method (the
    JAX package's ``repro.api.policies.PlacementPolicy``); the store stays
    dependency-free by duck-typing it and defaulting to the historical
    round-robin layout."""

    def __init__(
        self,
        n_storage_nodes: int = 3,
        replication: int = 3,
        internal_bandwidth: float = 5e9,   # NVMe-class per node
        placement=None,
    ) -> None:
        self.objects: Dict[str, StoredObject] = {}
        self.nodes = [
            Link(name=f"storage{i}", bandwidth=internal_bandwidth, latency=2e-4)
            for i in range(n_storage_nodes)
        ]
        self.replication = min(replication, n_storage_nodes)
        self.placement = placement
        self._placement: Dict[str, List[int]] = {}
        self.sim: Optional[Simulator] = None
        self.fabric = None          # set by use_fabric (NetworkFabric)

    def attach_sim(self, sim: Simulator) -> "ObjectStore":
        """Join a shared discrete-event simulation: storage-node reads are
        recorded into the fleet-wide trace."""
        self.sim = sim
        for node in self.nodes:
            node.attach(sim)
        return self

    def use_fabric(self, fabric) -> "ObjectStore":
        """Route storage-node reads through a shared
        :class:`~repro_torch.cos.network.NetworkFabric` (any object with
        its ``storage_port`` and ``transfer_concurrent``): each node becomes a
        fabric port (sharing the storage ingress trunk when the fabric's
        spec defines one). Uncontended reads stay byte-identical to the
        private-Link model, so a fabric-backed store reproduces the
        historical event log exactly until flows actually collide."""
        self.fabric = fabric
        self.nodes = [
            fabric.storage_port(i, bandwidth=node.bandwidth,
                                latency=node.latency)
            for i, node in enumerate(self.nodes)
        ]
        if self.sim is not None:
            for node in self.nodes:
                node.attach(self.sim)
        return self

    # -- data management ------------------------------------------------------
    def put_dataset(self, name: str, columns: Dict[str, np.ndarray],
                    object_size: int = 1000) -> List[str]:
        """Split a dataset into fixed-size objects. Returns object names."""
        n = len(next(iter(columns.values())))
        names = []
        for i, lo in enumerate(range(0, n, object_size)):
            hi = min(lo + object_size, n)
            payload = {k: v[lo:hi] for k, v in columns.items()}
            nbytes = sum(int(v.nbytes) for v in payload.values())
            oname = f"{name}/part-{i:05d}"
            self.objects[oname] = StoredObject(oname, payload, nbytes, hi - lo)
            if self.placement is not None:
                nodes = self.placement.initial(i, len(self.nodes), self.replication)
            else:
                nodes = [(i + r) % len(self.nodes) for r in range(self.replication)]
            self._placement[oname] = [n % len(self.nodes) for n in nodes]
            names.append(oname)
        return names

    def object_names(self, dataset: str) -> List[str]:
        return sorted(k for k in self.objects if k.startswith(dataset + "/"))

    def replicas(self, oname: str) -> List[int]:
        """Storage-node indices holding a replica of ``oname`` (used by the
        fleet's replica-aware router)."""
        return list(self._placement[oname])

    def add_replica(self, oname: str, node: int) -> bool:
        """Create an extra replica of ``oname`` on ``node`` (demand-aware
        re-replication). Charged as an internal copy from the currently
        least-busy existing replica; returns False if already present."""
        node = node % len(self.nodes)
        if node in self._placement[oname]:
            return False
        obj = self.objects[oname]
        src = min((self.nodes[r] for r in self._placement[oname]),
                  key=lambda nd: (nd.busy_until, nd.name))
        t0 = self.sim.now if self.sim is not None else src.busy_until
        _, read_done = src.transfer(t0, obj.nbytes)
        _, done = self.nodes[node].transfer(read_done, obj.nbytes)
        self._placement[oname].append(node)
        if self.sim is not None:
            self.sim.record(done, "store.replicate",
                            f"{oname} -> {self.nodes[node].name}")
        return True

    def remove_replica(self, oname: str, node: int, t: float = 0.0) -> bool:
        """Drop one replica of ``oname`` from ``node`` (demand-aware
        cold-replica reclamation). Refuses to drop the last replica;
        free — deleting local data moves no bytes."""
        node = node % len(self.nodes)
        reps = self._placement[oname]
        if node not in reps or len(reps) <= 1:
            return False
        reps.remove(node)
        if self.sim is not None:
            self.sim.record(t, "store.unreplicate",
                            f"{oname} -/- {self.nodes[node].name}")
        return True

    # -- storage request (proxy <- storage node) ------------------------------
    def read(self, oname: str, t: float, *,
             parent: int = -1) -> Tuple[StoredObject, float]:
        """Returns (object, time_ready). Reads from the least-busy replica.
        ``parent`` links the emitted storage.read span into the owning
        request's causal tree."""
        obj = self.objects[oname]
        replicas = self._placement[oname]
        # Manual first-minimal scan on (busy_until, name) — the lambda-key
        # min() was a per-request hotspot at fleet scale; strict-less
        # updates keep exactly min()'s first-of-equals choice.
        nodes = self.nodes
        node = nodes[replicas[0]]
        bu, bn = node.busy_until, node.name
        for ridx in replicas:
            nd = nodes[ridx]
            nbu = nd.busy_until
            if nbu < bu or (nbu == bu and nd.name < bn):
                node, bu, bn = nd, nbu, nd.name
        s, ready = node.transfer(t, obj.nbytes)
        if self.sim is not None:
            self.sim.record(ready, "store.read", f"{oname}@{node.name}")
            tr = self.sim.tracer
            # emit_fast: the read span's id is never used (children hang
            # off the request span), so the deferred raw-tuple path keeps
            # per-request tracing off the storage hot loop. Materialization
            # preserves order, so ids and digests match the eager path.
            tr.emit_fast("storage.read", s, ready, "storage",
                         node.name, parent=parent,
                         labels=(("object", oname),))
            mx = self.sim.metrics
            mx.observe("stage_seconds", ready - s, stage="storage")
        return obj, ready

    def read_batch(
        self, onames: List[str], t: float,
        weights: Optional[List[float]] = None,
        parents: Optional[List[int]] = None,
    ) -> Optional[List[Tuple[StoredObject, float]]]:
        """Resolve one drain round's reads *together* as a
        :meth:`~repro_torch.cos.network.NetworkFabric.transfer_concurrent`
        batch: reads that land on the same storage node (or behind a
        shared storage trunk) share its bandwidth instantaneously under
        weighted max-min — ``weights[i]`` is the owning tenant's service
        class — instead of serializing one-flow-at-a-time against
        committed profiles.

        Returns ``None`` when no two reads of the batch would actually
        share a link (no fabric, or every read has a contention-free
        node to itself): callers must then fall back to per-request
        :meth:`read` calls, whose event stream is byte-identical to the
        historical model — this is what keeps uncontended weight-1 runs
        reproducing existing logs exactly."""
        if self.fabric is None or len(onames) < 2:
            return None
        # Mirror read()'s least-busy replica choice, sequentially against
        # a projected busy horizon so the batch balances like the
        # one-at-a-time path would.
        projected = {i: nd.busy_until for i, nd in enumerate(self.nodes)}
        picks: List[int] = []
        for oname in onames:
            obj = self.objects[oname]
            r = min(self._placement[oname],
                    key=lambda i: (projected[i], self.nodes[i].name))
            picks.append(r)
            projected[r] = max(projected[r], t) + \
                self.nodes[r].latency + obj.nbytes / self.nodes[r].bandwidth
        shared_node = len(set(picks)) < len(picks)
        shared_trunk = getattr(self.fabric, "storage_trunk", None) is not None
        if not (shared_node or shared_trunk):
            return None
        if weights is None:
            weights = [1.0] * len(onames)
        reqs = [(self.nodes[r], t, self.objects[o].nbytes, w)
                for o, r, w in zip(onames, picks, weights)]
        resolved = self.fabric.transfer_concurrent(reqs)
        if parents is None:
            parents = [-1] * len(onames)
        out: List[Tuple[StoredObject, float]] = []
        for oname, r, (_s, ready), par in zip(onames, picks, resolved,
                                              parents):
            if self.sim is not None:
                self.sim.record(ready, "store.read",
                                f"{oname}@{self.nodes[r].name}")
                tr = self.sim.tracer
                tr.emit("storage.read", _s, ready, tier="storage",
                        track=self.nodes[r].name, parent=par,
                        labels=(("object", oname),))
                mx = self.sim.metrics
                mx.observe("stage_seconds", ready - _s, stage="storage")
            out.append((self.objects[oname], ready))
        return out

    def total_bytes(self, dataset: str) -> int:
        return sum(self.objects[o].nbytes for o in self.object_names(dataset))


def put_synthetic_dataset(
    store: ObjectStore,
    dataset: str = "imagenet",
    n_samples: int = 8000,
    object_size: int = 1000,
    img_bytes: Optional[int] = 110_000,
    n_classes: int = 1000,
    seed: int = 0,
) -> List[str]:
    """Store an ImageNet-shaped synthetic dataset in fixed-size objects,
    with on-wire object sizes forced to the paper's ~110 KB/image (payload
    arrays stay tiny so CPU runs are fast; ``img_bytes=None`` keeps true
    payload sizes). The single generator behind
    :func:`synthetic_image_store` and ``HapiCluster.with_dataset``."""
    rng = np.random.default_rng(seed)
    names = store.put_dataset(dataset, {
        "x": rng.normal(size=(n_samples, 8, 8, 3)).astype(np.float32),
        "y": rng.integers(0, n_classes, size=(n_samples,)).astype(np.int32),
    }, object_size=object_size)
    if img_bytes is not None:
        for oname in names:
            store.objects[oname].nbytes = \
                store.objects[oname].n_samples * img_bytes
    return names


def synthetic_image_store(
    dataset: str = "imagenet",
    n_samples: int = 8000,
    object_size: int = 1000,
    img_bytes: int = 110_000,
    n_classes: int = 1000,
    seed: int = 0,
) -> ObjectStore:
    """The benchmark/example/test workload (see
    :func:`put_synthetic_dataset`) on a fresh default store."""
    store = ObjectStore()
    put_synthetic_dataset(store, dataset, n_samples=n_samples,
                          object_size=object_size, img_bytes=img_bytes,
                          n_classes=n_classes, seed=seed)
    return store
