"""Object-store-aware input pipeline: sharded, prefetching, resumable.

Counterpart of ``repro/data/pipeline.py``, unchanged: batches are numpy
arrays on the host, and ``launch/train.py`` moves them to the device.

The pipeline reads fixed-size objects from the (simulated or real) COS,
assembles global batches in object order, and exposes a *checkpointable
cursor* — on restart, training resumes mid-epoch at the exact object
(fault tolerance, DESIGN.md §5). Host-side double buffering overlaps the
next batch's assembly with the current step (paper Fig. 6's pipelining).
Traced (``repro_torch.obs.program``), the consumer's wait is a ``data.wait``
span and each assembly a ``data.assemble`` span on the producer thread's
track ("cos-data").
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from queue import Queue
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.obs.program import TRACER


@dataclass
class PipelineState:
    """Checkpointable cursor."""
    epoch: int = 0
    next_object: int = 0
    seed: int = 0

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "next_object": self.next_object, "seed": self.seed}

    @staticmethod
    def from_dict(d: dict) -> "PipelineState":
        return PipelineState(**d)


def synthetic_dataset(cfg: ModelConfig, shape: ShapeConfig, n_samples: int,
                      seed: int = 0) -> Dict[str, np.ndarray]:
    """Synthetic token/frame/patch data matching an (arch, shape) cell."""
    rng = np.random.default_rng(seed)
    s = shape.seq_len
    if cfg.family == "encdec":
        return {
            "frames": rng.normal(size=(n_samples, s, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size, (n_samples, cfg.dec_seq)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (n_samples, cfg.dec_seq)).astype(np.int32),
        }
    if cfg.family == "vlm":
        st = s - cfg.n_patches
        return {
            "tokens": rng.integers(0, cfg.vocab_size, (n_samples, st)).astype(np.int32),
            "patches": rng.normal(size=(n_samples, cfg.n_patches, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (n_samples, st)).astype(np.int32),
        }
    toks = rng.integers(0, cfg.vocab_size, (n_samples, s)).astype(np.int32)
    return {"tokens": toks, "labels": toks.copy()}


class COSDataPipeline:
    """Iterates global batches assembled from COS objects."""

    def __init__(self, store, dataset: str, global_batch: int,
                 state: Optional[PipelineState] = None,
                 prefetch: int = 2,
                 host_id: int = 0, n_hosts: int = 1) -> None:
        """``host_id``/``n_hosts``: multihost sharded loading — each host
        reads a disjoint object stripe and assembles its 1/n_hosts slice
        of every global batch (all hosts share one cursor value, so the
        checkpointed state stays host-count independent)."""
        self.store = store
        self.dataset = dataset
        self.host_id, self.n_hosts = host_id, n_hosts
        self.objects = store.object_names(dataset)
        if n_hosts > 1:
            self.objects = self.objects[host_id::n_hosts]
            global_batch = global_batch // n_hosts
        if not self.objects:
            raise ValueError(f"no objects under {dataset}/")
        self.obj_size = store.objects[self.objects[0]].n_samples
        self.global_batch = global_batch
        self.per_batch = max(1, global_batch // self.obj_size)
        self.state = state or PipelineState()
        self.prefetch = prefetch

    def _assemble(self, start_obj: int) -> Optional[Dict[str, np.ndarray]]:
        group = self.objects[start_obj : start_obj + self.per_batch]
        if len(group) < self.per_batch:
            return None
        cols: Dict[str, list] = {}
        for oname in group:
            for k, v in self.store.objects[oname].payload.items():
                cols.setdefault(k, []).append(v)
        batch = {k: np.concatenate(v, axis=0)[: self.global_batch] for k, v in cols.items()}
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        q: Queue = Queue(maxsize=self.prefetch)
        stop = object()
        tr = TRACER

        def producer():
            i = self.state.next_object
            while True:
                with tr.span("data.assemble"):
                    b = self._assemble(i)
                if b is None:
                    q.put(stop)
                    return
                q.put((i + self.per_batch, b))
                i += self.per_batch

        th = threading.Thread(target=producer, daemon=True, name="cos-data")
        th.start()
        while True:
            with tr.span("data.wait"):
                item = q.get()
            if item is stop:
                self.state.epoch += 1
                self.state.next_object = 0
                return
            nxt, batch = item
            # Commit before handing out: a checkpoint taken after the step
            # that consumed this batch resumes at the NEXT batch
            # (exactly-once; a crash between next() and step() skips one).
            self.state.next_object = nxt
            yield batch

    def batches_per_epoch(self) -> int:
        return len(self.objects) // self.per_batch
