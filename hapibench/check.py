"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each held to its limit in ``limits/<cell>.json``.

Boundary (every cell): the int8 codes and scales the program emitted for a
microbatch, dequantized, against the reference's f32 prefix output at the
same rows. ``code_gap`` is the largest error of an element in steps of the
reference's quantization step for its tile (max|x| / 127), so one altered
code shows; ``boundary_rel_l2`` is the whole payload's relative L2 error.

Fine-tune (train cells), against the reference following the same first
steps on the same rows: ``loss_gap``, the largest relative gap of a step's
loss; ``grad_gap``, over the leaves, the largest gap between the norms of
the first step's gradient as the optimizer got it (worked out from its
first moment after one step and the step's reported gradient norm, which
undoes the clipping) and the reference's, over the larger of the
reference's norm of that leaf and of the median leaf; ``change_gap``, the
same for the norm of each leaf's change over the checked steps;
``leaf_grad_gap``, the first gradient's gap again, over that leaf's own
reference norm alone, so that a small leaf (mamba2's ``A_log``, ``D``,
``dt_bias``, a norm's scale) read wrong shows as plainly as a large one.
Leaves whose reference gradient is under a thousandth of the median leaf's
are left out of all three (their change is round-off).
"""
from __future__ import annotations

import statistics
from typing import Dict, Iterable, Tuple

import torch

from hapibench.reference.common import quantize_int8

NEGLIGIBLE_GRAD = 1e-3


def boundary_numbers(codes: torch.Tensor, scales: torch.Tensor,
                     ref: torch.Tensor) -> Dict[str, float]:
    """``code_gap`` and ``boundary_rel_l2`` of one payload against the
    reference's f32 boundary ``ref`` (same shape as ``codes``)."""
    *lead, d = codes.shape
    tile = d // scales.shape[-1]
    ref = ref.float()
    codes, scales = codes.to(ref.device), scales.to(ref.device)
    got = (codes.float().reshape(*lead, d // tile, tile) * scales.float()[..., None])
    _, ref_step = quantize_int8(ref, tile)
    err = (got - ref.reshape(*lead, d // tile, tile)).abs() / ref_step[..., None]
    rel = float((got.reshape(ref.shape) - ref).norm() / ref.norm().clamp(min=1e-30))
    return {"code_gap": float(err.max()), "boundary_rel_l2": rel}


def worst(readings: Iterable[Dict[str, float]]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keep,
              floor_at_median: bool = True) -> Dict[str, float]:
    """|got - want| of each leaf in ``keep`` over max(want, median of want),
    or over want alone."""
    med = statistics.median(want[k] for k in keep) if floor_at_median else 0.0
    return {k: abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keep}


def norm_gap(got: Dict[str, float], want: Dict[str, float], keep,
             floor_at_median: bool = True) -> Tuple[float, str]:
    """The largest of ``leaf_gaps`` and its leaf."""
    gaps = leaf_gaps(got, want, keep, floor_at_median)
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def kept_leaves(ref_grads: Dict[str, float]):
    med = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= NEGLIGIBLE_GRAD * med]


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref`` each hold ``losses`` (a step's loss),
    ``grad_norms`` (first step, by leaf) and ``change_norms`` (by leaf).
    Returns the numbers, and the leaf each gap was read at with the leaves
    left out."""
    keep = kept_leaves(ref["grad_norms"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_leaf = norm_gap(prog["grad_norms"], ref["grad_norms"], keep)
    change_gap, change_leaf = norm_gap(prog["change_norms"], ref["change_norms"], keep)
    own = leaf_gaps(prog["grad_norms"], ref["grad_norms"], keep, floor_at_median=False)
    own_leaf = max(own, key=own.get)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "leaf_grad_gap": own[own_leaf]}, \
        {"grad_gap": grad_leaf, "change_gap": change_leaf, "leaf_grad_gap": own_leaf,
         "by_kind": by_kind(own, ref["grad_norms"], keep),
         "left_out": sorted(set(ref["grad_norms"]) - set(keep))}


def by_kind(own: Dict[str, float], ref_grads: Dict[str, float], keep) -> Dict[str, list]:
    """For the log: each kind of leaf (its name less the block index), the
    largest own-norm gradient gap over its leaves and the smallest of their
    reference norms over the median leaf's."""
    med = statistics.median(ref_grads[k] for k in keep)
    out: Dict[str, list] = {}
    for k in keep:
        kind = k.split(".", 2)[-1] if k.startswith("blocks.") else k
        gap, rel = out.get(kind, [0.0, float("inf")])
        out[kind] = [max(gap, own[k]), min(rel, ref_grads[k] / med)]
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """Whether every number is within its limit, and each beside its limit.
    A number missing or not finite fails."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        shown[name] = {"value": value, "limit": limit}
    return ok, shown
