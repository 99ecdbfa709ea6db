"""The system under test, ``repro_torch``, as every cell sets it up: the
benchmark's seeded weights assigned to the program's model (built on the
meta device), the planner, the object store, and the benchmark's own spans
around its calls into the program. Each traffic kind (``kinds/<kind>.py``)
builds the entry its window drives from these.

From the program the benchmark takes only its entry points and its launch
counters.
"""
from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.config import HapiConfig, ModelConfig, ShapeConfig
from repro_torch.core.tier_split import TierPlan, plan_tiers, wire_bytes  # noqa: F401
from repro_torch.cos.objectstore import ObjectStore
from repro_torch.kernels import _build, ops  # noqa: F401  (ops: the launch counters)
from repro_torch.models.api import build_model
from repro_torch.train import steps as train_steps

from hapibench import families
from hapibench import traffic as T
from hapibench import weights as W


def model_config(config: dict) -> ModelConfig:
    return ModelConfig(**config["model"])


def build_kernels(config: dict) -> float:
    """Compiles what the cell runs that is not built yet (only the first run
    in a checkout does); returns the seconds it took."""
    return _build.build(families.of(config).SOURCES)


def plan(config: dict, traffic: dict) -> TierPlan:
    """``plan_tiers`` at the tenant's shape; the run fails unless it chose
    the configuration's split and the mix's COS batch, with int8."""
    cfg = model_config(config)
    rows = traffic.get("plan_rows", traffic["rows"])
    p = plan_tiers(cfg, ShapeConfig("bench", "train", traffic["seq"], rows),
                   HapiConfig(**traffic["hapi"]))
    want = (config["split"], traffic["hapi"]["cos_batch"], True)
    if (p.split, p.cos_batch, p.compress) != want:
        raise RuntimeError(f"plan_tiers chose split {p.split}, COS batch {p.cos_batch}, "
                           f"compress {p.compress}; the cell states {want}")
    return p


def model(config: dict, seed: int, device, blocks: Optional[range] = None):
    """The program's model with the benchmark's weights: all of them, or the
    embedding and ``blocks`` (the rest stays on meta)."""
    cfg = model_config(config)
    lm = build_model(cfg, device="meta", generator=torch.Generator())
    made = W.make(config, seed, device, blocks)
    missing, _ = lm.load_state_dict(made, strict=False, assign=True)
    if blocks is None and missing:
        raise RuntimeError(f"weights missing for {missing[:4]}")
    return lm


def store(config: dict, traffic: dict, seed: int) -> ObjectStore:
    """The mix's objects in an ``ObjectStore``, under the dataset "bench"."""
    s = ObjectStore()
    s.put_dataset("bench", T.columns(traffic, config["model"]["vocab_size"], seed),
                  object_size=T.object_rows(traffic))
    return s


def payload_bytes(out: tuple) -> int:
    return sum(int(np.asarray(x).nbytes) for x in out)


class Clock:
    """The benchmark's own spans around its calls into each layer: a
    ``record_function`` range that the device trace names idle gaps by, and
    in a traced run host seconds taken after a synchronize at each end.
    Within a train step, ``make_extract_fn``'s function and
    ``adamw_update`` are wrapped while the clock is installed (as
    ``chip_smoke.StepClock`` wraps them)."""

    def __init__(self, timed: bool, device):
        self.timed = timed and torch.device(device).type == "cuda"
        self.device = torch.device(device)
        self.seconds: dict = {}
        self._saved = None

    def snapshot(self) -> dict:
        """The seconds of each span so far, apart from later calls."""
        return {k: list(v) for k, v in self.seconds.items()}

    def _sync(self):
        if self.timed:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False):
        with torch.profiler.record_function("hapibench." + name):
            if sync:
                self._sync()
            t0 = time.perf_counter()
            yield
            if sync:
                self._sync()
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def _wrap(self, fn, name):
        def run(*a, **k):
            with self.span(name, sync=True):
                return fn(*a, **k)
        return run

    def install(self):
        """Wraps the train step's extraction and AdamW."""
        extract_fn, adamw = train_steps.make_extract_fn, train_steps.adamw_update
        self._saved = (extract_fn, adamw)
        train_steps.make_extract_fn = lambda p: self._wrap(extract_fn(p), "extract")
        train_steps.adamw_update = self._wrap(adamw, "adamw")
        return self

    def remove(self):
        if self._saved:
            train_steps.make_extract_fn, train_steps.adamw_update = self._saved
            self._saved = None


@contextlib.contextmanager
def extract_capture(into: list):
    """While inside, each payload a train step's extraction emits is
    appended to ``into``, on the host."""
    make = train_steps.make_extract_fn

    def capturing(p):
        fn = make(p)

        def run(prefix, batch):
            out = fn(prefix, batch)
            into.append(tuple(x.detach().cpu() for x in out))
            return out
        return run

    train_steps.make_extract_fn = capturing
    try:
        yield into
    finally:
        train_steps.make_extract_fn = make
