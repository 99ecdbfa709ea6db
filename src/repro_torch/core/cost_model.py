"""The theoretical cost model (paper §4, Eqs. 1–3) + roofline-corrected form.

A copy of ``repro/core/cost_model.py`` (numpy only): the port imports
nothing of ``repro``. The HBM rates default to the port's ``HW``, one H100
(3.35 TB/s); the int8 ratio is the port's ``kernels.ops.INT8_WIRE_RATIO``.

Paper form (literal):
    C_COS    = |R| * (|D|/B_cos)   * (C11*B_cos*(l0 + l_split) + C12*L_cos)
    C_client =       (|D|/B_cli)   * (C21*B_cli*l_split        + C22*L_cli)
    T_data   = l_split * |D| / BW
    epoch    = C_COS + C_client + T_data                       (Eq. 3 objective)

Roofline-corrected form (replaces paper assumptions 3+4):
per-stage time = max(FLOPs/peak_flops, bytes/HBM_bw); tenancy multiplies
COS queue time; stages overlap (pipelined epoch ≈ max of stage times with
a one-iteration fill), matching how the real system double-buffers.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.config import HW
from repro_torch.core.profiler import LayerProfile


@dataclass(frozen=True)
class EpochTime:
    cos: float
    client: float
    network: float
    overlapped: bool

    @property
    def total(self) -> float:
        if self.overlapped:
            stages = (self.cos, self.client, self.network)
            m = max(stages)
            return m + (sum(stages) - m) / 16.0  # dominant stage + fill
        return self.cos + self.client + self.network


@dataclass(frozen=True)
class PaperConstants:
    """C11/C12/C21/C22 of Table 2 — fit from profiling runs."""
    c11: float
    c12: float
    c21: float
    c22: float


def paper_epoch_time(
    profile: LayerProfile,
    split: int,
    dataset: int,
    b_cos: int,
    b_client: int,
    bandwidth: float,
    consts: PaperConstants,
    n_tenants: int = 1,
) -> EpochTime:
    """Eqs. 1–3, literally."""
    l0 = profile.input_bytes
    l_split = profile.out_bytes[split]
    l_cos = split
    l_client = profile.n_boundaries - 1 - split

    cos = n_tenants * (dataset / max(b_cos, 1)) * (
        consts.c11 * b_cos * (l0 + l_split) + consts.c12 * l_cos
    ) if split > 0 else 0.0
    client = (dataset / max(b_client, 1)) * (
        consts.c21 * b_client * l_split + consts.c22 * l_client
    )
    net = l_split * dataset / bandwidth
    return EpochTime(cos, client, net, overlapped=False)


def fit_constants(
    measurements: Sequence[tuple],  # (batch, bytes, n_layers, seconds) per run
):
    """Least-squares fit of one tier's pair — (C11, C12) or (C21, C22) —
    from profiling runs of the form t = C_a * B * bytes + C_b * L.
    Returns (c_a, c_b)."""
    a = np.array([[b * by, l] for (b, by, l, _t) in measurements], dtype=np.float64)
    t = np.array([m[-1] for m in measurements], dtype=np.float64)
    coef, *_ = np.linalg.lstsq(a, t, rcond=None)
    return float(coef[0]), float(coef[1])


def effective_bandwidth(nominal: float, samples: Sequence[float] = (),
                        alpha: float = 0.25) -> float:
    """EWMA fold of observed per-transfer bandwidth samples into a prior
    (usually the nominal link rate). Pure and deterministic; with no
    samples the nominal rate is returned unchanged.

    This is the estimator behind contention-aware split re-decision: the
    clients feed it the achieved bandwidth of every activation pull over
    the shared fabric, and re-run Algorithm 1 / the §4 cost model with
    the result instead of the provisioned rate."""
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    bw = float(nominal)
    for s in samples:
        bw = alpha * float(s) + (1.0 - alpha) * bw
    return bw


def roofline_epoch_time(
    profile: LayerProfile,
    split: int,
    dataset: int,
    train_batch: int,
    *,
    bandwidth: float,
    cos_flops: float,
    client_flops: float,
    n_tenants: int = 1,
    compress: float = 1.0,
    cos_hbm_bw: float = HW.hbm_bandwidth,
    client_hbm_bw: float = HW.hbm_bandwidth,
    overlap: bool = True,
    measured_bandwidth: Optional[float] = None,
) -> EpochTime:
    """Roofline-corrected §4 model. FLOP counts come from the profile;
    the COS serves ``n_tenants`` concurrent jobs (spatial sharing).
    ``measured_bandwidth`` (e.g. an :func:`effective_bandwidth` estimate
    from live transfers) replaces the nominal ``bandwidth`` in the
    network term — the contention-aware form of the model. ``compress``
    is the wire-byte ratio of boundary compression; pass
    :data:`repro_torch.kernels.ops.INT8_WIRE_RATIO` (what
    :func:`repro_torch.core.splitter.choose_split_cost_optimal` does) so the
    model charges the same bytes the server does."""
    prefix_flops = profile.cum_flops[split]
    suffix_fwd = profile.total_flops - prefix_flops
    # Training suffix: fwd + bwd ~ 3x fwd on trainable part.
    suffix_flops = 3.0 * suffix_fwd

    cos_bytes = profile.prefix_param_bytes[split] + profile.out_bytes[split] + profile.input_bytes
    cli_bytes = (profile.model_param_bytes - profile.prefix_param_bytes[split]) * 3

    cos = dataset * n_tenants * max(
        prefix_flops / cos_flops, cos_bytes / max(cos_hbm_bw, 1.0) / max(train_batch, 1)
    ) if split > 0 else 0.0
    client = dataset * max(
        suffix_flops / client_flops, cli_bytes / max(client_hbm_bw, 1.0) / max(train_batch, 1)
    )
    wire = profile.out_bytes[split] if split > 0 else profile.input_bytes
    bw = measured_bandwidth if measured_bandwidth else bandwidth
    net = wire * compress * dataset / bw
    return EpochTime(cos, client, net, overlapped=overlap)


def wire_bytes_per_iteration(profile: LayerProfile, split: int,
                             train_batch: int, *,
                             compressed: bool = False) -> float:
    """The bytes one iteration puts on the storage<->compute trunk — the
    paper's Fig. 13 metric, and the single wire-byte figure Algorithm 1,
    the roofline model, the simulated server and the benchmarks all
    agree on. ``compressed`` applies the authoritative int8(+scales)
    ratio (:data:`repro_torch.kernels.ops.INT8_WIRE_RATIO`)."""
    from repro_torch.kernels.ops import INT8_WIRE_RATIO

    ratio = INT8_WIRE_RATIO if compressed else 1.0
    return transferred_per_iteration(profile, split, train_batch,
                                     compress=ratio)


def transferred_per_iteration(profile: LayerProfile, split: int, train_batch: int,
                              compress: float = 1.0) -> float:
    """Raw-ratio form of :func:`wire_bytes_per_iteration` (``compress``
    is an explicit multiplier; prefer the boolean wrapper so the ratio
    can never drift from the kernels')."""
    wire = profile.out_bytes[split] if split > 0 else profile.input_bytes
    return wire * train_batch * compress
