"""Object store (Swift-like: proxy + replicated storage nodes, fixed-size
objects) on the host, with numpy payloads.

Counterpart of ``repro/cos/objectstore.py``. Datasets are stored as
equal-sized chunks (paper: 1000 images per object, chosen to avoid small
requests). A read goes to the least busy replica's storage node, whose
``Link`` books it on the virtual clock. Joining a fleet's simulation
(``attach_sim``), a shared network fabric (``use_fabric``) and re-replication
wait for the simulator slice (ROADMAP Queue 1 item 4): until then no read
shares a link, and ``read_batch`` always leaves the reads to ``read``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cos.clock import Link


@dataclass
class StoredObject:
    name: str
    payload: dict                  # column -> np.ndarray (leading dim = samples)
    nbytes: int
    n_samples: int


class ObjectStore:
    """``placement`` is any object with an
    ``initial(index, n_nodes, replication) -> List[int]`` method; the default
    is the round-robin layout."""

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
        """Storage-node indices holding a replica of ``oname``."""
        return list(self._placement[oname])

    # -- storage request (proxy <- storage node) ------------------------------
    def read(self, oname: str, t: float) -> Tuple[StoredObject, float]:
        """Returns (object, time_ready). Reads from the least-busy replica,
        the first by name among equals."""
        obj = self.objects[oname]
        node = min((self.nodes[r] for r in self._placement[oname]),
                   key=lambda nd: (nd.busy_until, nd.name))
        _, ready = node.transfer(t, obj.nbytes)
        return obj, ready

    def read_batch(self, onames: List[str], t: float,
                   weights: Optional[List[float]] = None
                   ) -> Optional[List[Tuple[StoredObject, float]]]:
        """Reads that share a link are resolved together on a network fabric
        in the JAX package. The port has no fabric yet, so no two reads share
        one, and this returns None: callers make one ``read`` per object, as
        the JAX package's callers do without a fabric."""
        return None

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
    arrays stay tiny; ``img_bytes=None`` keeps true payload sizes)."""
    rng = np.random.default_rng(seed)
    names = store.put_dataset(dataset, {
        "x": rng.normal(size=(n_samples, 8, 8, 3)).astype(np.float32),
        "y": rng.integers(0, n_classes, size=(n_samples,)).astype(np.int32),
    }, object_size=object_size)
    if img_bytes is not None:
        for oname in names:
            store.objects[oname].nbytes = store.objects[oname].n_samples * img_bytes
    return names
