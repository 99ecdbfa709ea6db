"""Open-loop workload generator: production-shaped request streams.

A copy of ``repro/replay/workload.py``: the same spec gives the same
trace in either package.

Emits :class:`~repro_torch.replay.trace.Trace` objects in the same versioned
format recorded runs use, so synthetic and recorded workloads are
interchangeable replay inputs. The shape follows the disaggregated
multi-job sharing scenarios of the tf.data-service line of work:

* **diurnal arrival** — a sinusoidal rate profile over the day (trough
  at t=0), so the fleet sees quiet nights and busy afternoons;
* **heavy-tailed popularity** — model/object demand is Zipf over the
  architecture catalog in :mod:`repro_torch.configs` (each model contributes
  ``objects_per_model`` dataset shards; a seeded permutation assigns
  ranks), so a handful of hot objects carry most of the traffic;
* **request bursts** — Gaussian rate spikes at seeded times, the tail
  events that actually stress placement and scaling policies.

Everything is driven by **one** :class:`numpy.random.Generator` built
from ``spec.seed`` — no bare ``random``/wall-clock calls — so the same
spec produces a byte-identical trace (asserted by the determinism
regression in the JAX package's tests/test_replay.py, and against it by
tests/test_torch_replay.py).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np

from repro_torch.replay.schema import RequestRecord, TraceHeader
from repro_torch.replay.trace import Trace


@dataclass(frozen=True)
class WorkloadSpec:
    """Knobs of one generated day. ``models=()`` uses the full
    :data:`repro_torch.configs.ARCH_IDS` catalog."""

    n_requests: int = 100_000
    seed: int = 0
    duration: float = 86_400.0          # one virtual day
    # tenants: ids 0..n-1; QoS weights cycled over them (gold/bronze mix)
    n_tenants: int = 16
    tenant_weights: Tuple[float, ...] = (4.0, 2.0, 1.0, 1.0)
    # catalog
    models: Tuple[str, ...] = ()
    objects_per_model: int = 48
    object_bytes: int = 110_000 * 1000  # paper-shaped: 1000 x ~110KB images
    zipf_exponent: float = 1.1
    # arrival shape
    diurnal_amplitude: float = 0.6
    diurnal_period: float = 86_400.0
    n_bursts: int = 12
    burst_gain: float = 4.0
    burst_width: float = 600.0
    bin_seconds: float = 60.0
    # service model (per-request accelerator seconds)
    base_service: float = 0.18
    service_jitter: float = 0.35
    act_bytes: float = 6.0e6            # split-boundary activations served
    # deployment the trace is replayed against
    n_servers: int = 8
    n_accels: int = 2
    n_nodes: int = 8
    replication: int = 2
    internal_bandwidth: float = 2.5e9
    storage_latency: float = 2e-4

    def scaled(self, n_requests: int, seed: int = None) -> "WorkloadSpec":
        """Same workload *shape* at a different size (and seed): duration
        scales with the request count so the arrival rate — what actually
        stresses the fleet — is preserved, and the burst count scales
        with duration so burst density (hence the peak-to-mean ratio) is
        preserved too. A 10k-request smoke run and the million-request
        sweep then see the same contention level."""
        ratio = n_requests / self.n_requests
        return replace(self, n_requests=n_requests,
                       duration=self.duration * ratio,
                       n_bursts=max(1, round(self.n_bursts * ratio)),
                       seed=self.seed if seed is None else seed)


def catalog_objects(spec: WorkloadSpec) -> Tuple[str, ...]:
    """The object catalog: every model's dataset shards, in catalog
    order (model order x shard index)."""
    models = spec.models
    if not models:
        from repro_torch.configs import ARCH_IDS
        models = tuple(ARCH_IDS)
    return tuple(f"{m}/part-{j:05d}"
                 for m in models for j in range(spec.objects_per_model))


def zipf_popularity(rng: np.random.Generator, n: int,
                    exponent: float = 1.1) -> np.ndarray:
    """Heavy-tailed popularity over ``n`` items: Zipf(``exponent``) mass
    assigned by a seeded permutation (rank *r* gets ``(1+r)^-exponent``,
    normalized). The one popularity sampler every catalog-scale workload
    shares — the trace generator here and the coalescing/weight-cache
    benchmarks draw from the same distribution family, so their
    "catalog scale" means the same thing."""
    ranks = rng.permutation(n).astype(np.float64)
    pop = (1.0 + ranks) ** -exponent
    pop /= pop.sum()
    return pop


def generate(spec: WorkloadSpec) -> Trace:
    """One seeded open-loop day as a replayable :class:`Trace`."""
    rng = np.random.default_rng(spec.seed)
    objects = catalog_objects(spec)
    n_obj = len(objects)
    n = spec.n_requests

    # -- popularity: Zipf over a seeded permutation of the catalog --------
    pop = zipf_popularity(rng, n_obj, spec.zipf_exponent)

    # -- arrival profile: diurnal + seeded bursts, binned -----------------
    nbins = max(1, int(round(spec.duration / spec.bin_seconds)))
    bin_w = spec.duration / nbins
    centers = (np.arange(nbins) + 0.5) * bin_w
    rate = 1.0 + spec.diurnal_amplitude * np.sin(
        2.0 * np.pi * centers / spec.diurnal_period - 0.5 * np.pi)
    burst_at = rng.uniform(0.0, spec.duration, size=spec.n_bursts)
    for c in burst_at:
        rate += spec.burst_gain * np.exp(
            -0.5 * ((centers - c) / spec.burst_width) ** 2)
    rate = np.clip(rate, 1e-9, None)
    counts = rng.multinomial(n, rate / rate.sum())
    arrival = np.empty(n, dtype=np.float64)
    pos = 0
    for b, c in enumerate(counts):
        if c:
            arrival[pos:pos + c] = b * bin_w + bin_w * np.sort(rng.random(c))
            pos += c

    # -- per-request draws ------------------------------------------------
    obj_idx = rng.choice(n_obj, size=n, p=pop)
    tenants = rng.integers(0, spec.n_tenants, size=n)
    # per-model service multiplier (bigger backbones extract slower)
    n_models = n_obj // spec.objects_per_model
    model_mult = 0.5 + rng.random(n_models)
    service = (spec.base_service
               * model_mult[obj_idx // spec.objects_per_model]
               * (1.0 + spec.service_jitter * (2.0 * rng.random(n) - 1.0)))

    weights = spec.tenant_weights or (1.0,)
    tenant_weights = {t: float(weights[t % len(weights)])
                      for t in range(spec.n_tenants)}
    requests = [
        RequestRecord(
            req_id=i, tenant=t, object_name=objects[o],
            model_key=objects[o].split("/", 1)[0],
            arrival=a, service=s, act_bytes=spec.act_bytes,
            network_weight=tenant_weights[t], compute_weight=tenant_weights[t],
        )
        for i, (t, o, a, s) in enumerate(zip(
            tenants.tolist(), obj_idx.tolist(),
            arrival.tolist(), service.tolist()))
    ]
    header = TraceHeader(
        seed=spec.seed, mode="open-loop",
        n_servers=spec.n_servers, n_accels=spec.n_accels,
        n_nodes=spec.n_nodes, replication=spec.replication,
        internal_bandwidth=spec.internal_bandwidth,
        storage_latency=spec.storage_latency,
        tenant_weights=tenant_weights,
        placement={o: tuple((i + r) % spec.n_nodes
                            for r in range(spec.replication))
                   for i, o in enumerate(objects)},
        object_bytes={o: spec.object_bytes for o in objects},
    )
    return Trace(header, requests)


__all__ = ["WorkloadSpec", "generate", "catalog_objects",
           "zipf_popularity"]
