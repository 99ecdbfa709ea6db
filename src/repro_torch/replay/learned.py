"""Offline training for :class:`repro_torch.api.policies.LearnedPlacement`.

A copy of ``repro/replay/learned.py``; the ridge fit runs in torch, in
float32 as the reference's JAX fit does, so both packages featurize the
same trace into the same rows and fit weights that agree to float32
rounding.

The training loop is replay-native: featurize a trace's demand into
per-object windows, fit a small linear model in torch (ridge regression,
closed form) that predicts each object's *next-window* demand from its
current decayed-demand features, and package the fit as a
:class:`PlacementModel` whose :meth:`~PlacementModel.to_policy` drops
straight into the ``PLACEMENT_POLICIES`` registry slot. Inference stays
stdlib-only inside the policy — the model is three weights, a bias and
the standardization constants — so training cost is paid once, offline,
and fleet decision paths never import torch.

Featurization is exactly the policy's own
(:func:`repro_torch.api.policies.learned_features` over a ``window``-half-life
decayed demand table), computed at every window boundary of the trace:
one (features, next-window-demand) row per object per window. Hot/cold
actuation thresholds are picked from the training distribution itself —
the ``hot_quantile`` of predicted scores — so the policy replicates
roughly the same fraction of the catalog the trace's head occupied,
whatever the absolute traffic scale.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.api.policies import LearnedPlacement, learned_features
from repro_torch.replay.trace import Trace


@dataclass(frozen=True)
class PlacementModel:
    """A trained linear placement head + everything inference needs."""

    weights: Tuple[float, float, float]
    bias: float
    feature_mean: Tuple[float, float, float]
    feature_std: Tuple[float, float, float]
    window: float
    byte_unit: float
    hot_score: float
    cold_score: float
    train_rows: int = 0
    train_rmse: float = 0.0

    def to_policy(self, **overrides) -> LearnedPlacement:
        kw = dict(
            window=self.window, byte_unit=self.byte_unit,
            weights=self.weights, bias=self.bias,
            feature_mean=self.feature_mean, feature_std=self.feature_std,
            hot_score=self.hot_score, cold_score=self.cold_score,
        )
        kw.update(overrides)
        return LearnedPlacement(**kw)


def featurize(trace: Trace, *, window: float = 300.0,
              byte_unit: float = 1e6):
    """Per-object demand windows -> (features, label) rows.

    Pass 1 bins each request's demand points (``act_bytes/byte_unit``,
    class-weighted variant alongside) into windows; pass 2 walks the
    window boundaries keeping the same decayed tables the live policy
    keeps (half-life = one window) and emits, for every object seen so
    far, its feature vector at the boundary and ``log1p`` of its demand
    in the *next* window — the quantity the policy's score predicts.
    Returns ``(X, y)`` as lists of tuples/floats (caller picks the
    array backend)."""
    horizon = max(r.arrival for r in trace.requests) if trace.requests else 0.0
    n_windows = int(horizon / window) + 1
    pts: List[Dict[str, float]] = [dict() for _ in range(n_windows)]
    wpts: List[Dict[str, float]] = [dict() for _ in range(n_windows)]
    last: List[Dict[str, float]] = [dict() for _ in range(n_windows)]
    for r in trace.requests:
        k = int(r.arrival / window)
        inc = r.act_bytes / byte_unit
        pts[k][r.object_name] = pts[k].get(r.object_name, 0.0) + inc
        wpts[k][r.object_name] = wpts[k].get(r.object_name, 0.0) + \
            inc * r.compute_weight
        last[k][r.object_name] = max(last[k].get(r.object_name, 0.0),
                                     r.arrival)
    X: List[Tuple[float, float, float]] = []
    y: List[float] = []
    demand: Dict[str, float] = {}
    wdemand: Dict[str, float] = {}
    seen: Dict[str, float] = {}
    for k in range(n_windows - 1):
        # decay by one half-life, then absorb window k — identical to the
        # policy decaying at the boundary after observing the window.
        for o in demand:
            demand[o] *= 0.5
            wdemand[o] *= 0.5
        for o, v in pts[k].items():
            demand[o] = demand.get(o, 0.0) + v
            wdemand[o] = wdemand.get(o, 0.0) + wpts[k][o]
        seen.update(last[k])
        boundary = (k + 1) * window
        nxt = pts[k + 1]
        for o in seen:
            recency = 0.5 ** ((boundary - seen[o]) / window)
            X.append(learned_features(demand.get(o, 0.0),
                                      wdemand.get(o, 0.0), recency))
            y.append(math.log1p(nxt.get(o, 0.0)))
    return X, y


def _fit_ridge(X, y, l2: float):
    """Closed-form ridge on standardized features, in float32 on the host
    (the reference's JAX fit runs in float32 too: JAX without x64).
    The std is the population std, as ``jnp.std``'s."""
    import torch

    Xa = torch.tensor(X, dtype=torch.float32)
    ya = torch.tensor(y, dtype=torch.float32)
    mean = Xa.mean(dim=0)
    std = Xa.std(dim=0, correction=0)
    std = torch.where(std > 1e-9, std, torch.ones_like(std))
    Z = (Xa - mean) / std
    n, d = Z.shape
    A = Z.T @ Z + l2 * n * torch.eye(d, dtype=Xa.dtype)
    b = Z.T @ (ya - ya.mean())
    w = torch.linalg.solve(A, b)
    bias = ya.mean()
    pred = Z @ w + bias
    rmse = float(torch.sqrt(((pred - ya) ** 2).mean()))
    return ([float(v) for v in w], float(bias),
            [float(v) for v in mean], [float(v) for v in std],
            [float(v) for v in pred], rmse)


def train_placement_model(trace: Trace, *, window: float = 300.0,
                          byte_unit: float = 1e6, l2: float = 1e-3,
                          hot_quantile: float = 0.85,
                          cold_fraction: float = 0.5) -> PlacementModel:
    """Fit the placement head on ``trace`` and pick actuation thresholds.

    ``hot_quantile`` sets how much of the catalog the policy targets for
    extra replicas: the hot threshold is that quantile of the model's
    scores over the training rows (≈ the trace's Zipf head + mid-tail);
    the cold threshold is ``cold_fraction`` of it for hysteresis."""
    X, y = featurize(trace, window=window, byte_unit=byte_unit)
    if not X:
        raise ValueError("trace has no requests to train on")
    w, bias, mean, std, pred, rmse = _fit_ridge(X, y, l2)
    scores = sorted(pred)
    hot = scores[min(len(scores) - 1, int(hot_quantile * len(scores)))]
    return PlacementModel(
        weights=tuple(w), bias=bias,
        feature_mean=tuple(mean), feature_std=tuple(std),
        window=window, byte_unit=byte_unit,
        hot_score=float(hot), cold_score=float(cold_fraction * hot),
        train_rows=len(y), train_rmse=rmse,
    )


__all__ = ["PlacementModel", "featurize", "train_placement_model"]
