"""The splitting algorithm (paper §5.4, Algorithm 1).

Counterpart of ``repro/core/splitter.py``: ``candidate_boundaries``,
``choose_split`` and ``choose_split_cost_optimal``.

Phase 1 — candidate selection: boundaries whose per-sample output is no
larger than the application input, and not after the freeze index.
Phase 2 — winner selection: the *earliest* candidate whose batch-scaled
output fits through the network within ``window_s`` seconds
(C = bandwidth x window). Defaults to the freeze index when no candidate
qualifies (Alg. 1 line 13).

With ``compress_transfer`` the wire bytes are scaled by the port's own
:data:`repro_torch.kernels.ops.INT8_WIRE_RATIO` (0.515625 for bf16 with
per-128 f32 scales), the ratio of the bytes ``extract`` emits.

Beyond the paper, as in the reference: ``choose_split_cost_optimal`` takes
the argmin of the roofline-corrected §4 cost model (``core/cost_model.py``)
over every boundary up to the freeze index, 0 (no pushdown) included.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.config import HapiConfig
from repro_torch.core.profiler import LayerProfile
from repro_torch.kernels.ops import INT8_WIRE_RATIO


@dataclass(frozen=True)
class SplitDecision:
    split_index: int                 # boundary index: prefix = blocks [0, split)
    bytes_per_sample: float          # uncompressed boundary bytes
    wire_bytes_per_iter: float       # after compression, x train batch
    candidates: List[int]
    reason: str


def candidate_boundaries(profile: LayerProfile, freeze_index: Optional[int] = None) -> List[int]:
    """Alg. 1 phase 1: output <= app input, index <= freeze index."""
    fz = profile.freeze_index if freeze_index is None else freeze_index
    return [
        i
        for i in range(1, fz + 1)
        if profile.out_bytes[i] <= profile.input_bytes
    ]


def choose_split(
    profile: LayerProfile,
    hapi: HapiConfig,
    train_batch: int,
    freeze_index: Optional[int] = None,
) -> SplitDecision:
    """Faithful Algorithm 1."""
    fz = profile.freeze_index if freeze_index is None else freeze_index
    cands = candidate_boundaries(profile, fz)
    compress = INT8_WIRE_RATIO if hapi.compress_transfer else 1.0
    threshold = hapi.network_bandwidth * hapi.window_s

    winner, reason = fz, "default: freeze index (no candidate under C)"
    for i in cands:
        wire = profile.out_bytes[i] * train_batch * compress
        if wire < threshold:
            winner, reason = i, f"earliest candidate with wire bytes {wire:.3e} < C {threshold:.3e}"
            break

    if not cands:
        # Token-input LMs: every boundary activation exceeds the raw token
        # bytes, so phase 1 is empty and the paper's default (freeze index)
        # applies — maximal pushdown, minimal+equal wire bytes.
        reason = "no candidate (input smaller than every boundary); freeze index"

    return SplitDecision(
        split_index=winner,
        bytes_per_sample=profile.out_bytes[winner],
        wire_bytes_per_iter=profile.out_bytes[winner] * train_batch * compress,
        candidates=cands,
        reason=reason,
    )


def choose_split_cost_optimal(
    profile: LayerProfile,
    hapi: HapiConfig,
    train_batch: int,
    *,
    cos_flops: float,
    client_flops: float,
    n_tenants: int = 1,
    dataset_size: Optional[int] = None,
    freeze_index: Optional[int] = None,
    measured_bandwidth: Optional[float] = None,
) -> SplitDecision:
    """Argmin of the roofline-corrected §4 cost model over all boundaries
    (including 0 = no pushdown), at the HBM rate of the port's ``HW``.
    ``measured_bandwidth`` feeds the model a live bandwidth estimate (see
    :func:`repro_torch.core.cost_model.effective_bandwidth`) instead of the
    provisioned rate."""
    from repro_torch.core.cost_model import roofline_epoch_time

    fz = profile.freeze_index if freeze_index is None else freeze_index
    compress = INT8_WIRE_RATIO if hapi.compress_transfer else 1.0
    d = dataset_size or train_batch * 32

    best_i, best_t = 0, float("inf")
    for i in range(0, fz + 1):
        t = roofline_epoch_time(
            profile, i, d, train_batch,
            bandwidth=hapi.network_bandwidth,
            cos_flops=cos_flops, client_flops=client_flops,
            n_tenants=n_tenants, compress=compress,
            measured_bandwidth=measured_bandwidth,
        ).total
        if t < best_t - 1e-12:
            best_i, best_t = i, t

    return SplitDecision(
        split_index=best_i,
        bytes_per_sample=profile.out_bytes[best_i],
        wire_bytes_per_iter=profile.out_bytes[best_i] * train_batch * compress,
        candidates=list(range(0, fz + 1)),
        reason=f"cost-optimal: epoch time {best_t:.3f}s",
    )
