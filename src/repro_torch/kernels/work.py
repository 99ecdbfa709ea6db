"""The work of each hand-written kernel: the bytes it must move and the
operations it must do, one formula a kernel.

``chip_smoke.py`` turns these into each kernel's bound (``bound``: the
larger of the bytes over the memory rate and the operations over the peak
rate of their type), and the dry-run's counter (``launch/cost_analysis.py``)
adds them to a program's FLOPs and HBM bytes: the kernel wrappers call
``tally`` each time they launch a kernel, and on meta tensors each entry
point of ``kernels/ops.py`` tallies the same formula instead of launching.
A plain version's work is not the kernel's (the plain flash repeats its
tiles step by step), so the plain versions tally nothing; the counter sees
their PyTorch ops instead.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.config import HW

Work = Tuple[float, float]     # (bytes moved, operations done)

_COUNTERS: List[Callable[[str, float, float], None]] = []


def tally(kernel: str, work: Work) -> None:
    """Tell every active counter that ``kernel`` did ``work``."""
    for add in _COUNTERS:
        add(kernel, *work)


def bound(bytes_moved: float, ops_done: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = bytes_moved / HW.hbm_bandwidth
    t_ops = ops_done / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def live_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs the mask leaves live: the work a flash kernel needs."""
    q = np.arange(s)
    lo = np.maximum(q - window, 0) if window is not None else np.zeros(s, np.int64)
    hi = q if causal else np.full(s, s - 1)
    return int((hi - lo + 1).sum())


def flash_work(b, s, h, hkv, hd, causal, window, itemsize, hdv=None) -> Work:
    """Bytes: q, k, v read and the output written once; operations: S =
    Q K^T at 2 hd FLOP and O = P V at 2 hdv per live (query, key) pair and
    head. ``hdv`` is V's head dim (the output's), by default ``hd``."""
    hdv = hd if hdv is None else hdv
    return ((b * s * h * (hd + hdv) + b * s * hkv * (hd + hdv)) * itemsize,
            2 * (hd + hdv) * b * h * live_pairs(s, causal, window))


def flash_bwd_work(b, s, h, hkv, hd, causal, window, itemsize, hdv=None) -> Work:
    """Bytes: q, k, v, o, dO read and dq, dk, dv written once, the
    log-sum-exp read once; operations: five products per live (query, key)
    pair and head, S, dK and dQ at 2 hd FLOP, dP and dV at 2 hdv (V's head
    dim, by default ``hd``)."""
    hdv = hd if hdv is None else hdv
    return ((b * s * h * (2 * hd + 3 * hdv) + 2 * b * s * hkv * (hd + hdv)) * itemsize
            + 4 * b * h * s,
            2 * (3 * hd + 2 * hdv) * b * h * live_pairs(s, causal, window))


def decode_work(b, hq, hkv, hd, length, itemsize) -> Work:
    """Each live K and V row read once, q read and the output written once;
    4 hd FLOP per (query head, live key)."""
    return ((2 * b * length * hkv * hd + 2 * b * hq * hd) * itemsize,
            4 * hd * b * hq * length)


def ssd_work(b, s, h, p, n, q, itemsize) -> Work:
    """Bytes: x, B, C in their type, dtA and dt in f32 read once; y and the
    state written once in f32. Operations: the least the chunked form needs,
    with the within-chunk products over the lower triangle only: per chunk
    C.B^T once per batch row, and per head the masked (C.B^T * L).(x dt),
    the carried state's C.state and the state update B^T.(x dt)."""
    nbytes = (b * s * h * p + 2 * b * s * n) * itemsize + 2 * b * s * h * 4 \
        + (b * s * h * p + b * h * n * p) * 4
    tri = q * (q + 1) // 2
    chunks = -(-s // q)
    return nbytes, b * chunks * (2 * tri * n + h * (2 * tri * p + 4 * q * n * p))


def ssd_bwd_work(b, s, h, p, n, q, itemsize) -> Work:
    """Bytes: x, B, C in their type, dtA and dt in f32, the states and dy in
    f32 read once; dx, dB, dC in the inputs' type and d dtA, d dt in f32
    written once. Operations: per chunk and batch row C.B^T once over the
    lower triangle; per head the four triangle products (dy.xs^T, (S L)^T.dy,
    (M L).B, (M L)^T.C) and the five with the state (C.h, h.dy, B.dh, dh.xs,
    C^T.dy)."""
    chunks = -(-s // q)
    nbytes = (2 * b * s * h * p + 4 * b * s * n) * itemsize + 4 * b * s * h * 4 \
        + (b * chunks * h * n * p + b * s * h * p) * 4
    tri = q * (q + 1) // 2
    return nbytes, b * chunks * (2 * tri * n + h * (2 * tri * (2 * p + 2 * n) + 10 * q * n * p))


def quantize_work(n: int, itemsize: int, n_scales: int) -> Work:
    """x read, the codes and f32 scales written; about 5 operations an
    element (abs, max, divide, round, clamp)."""
    return n * (itemsize + 1) + n_scales * 4, 5 * n


def dequantize_work(n: int, out_itemsize: int, n_scales: int) -> Work:
    """The codes and f32 scales read, the output written; one multiply an
    element."""
    return n * (1 + out_itemsize) + n_scales * 4, n


def split3_work(n: int) -> Work:
    """The f32 gradient read, its three bf16 terms written; five operations
    an element (three roundings, two subtractions)."""
    return n * (4 + 3 * 2), 5 * n


def decode_live(length: int, window: Optional[int]) -> int:
    """Live keys of one decode query at ``length`` cached positions."""
    return length if window is None else min(length, window + 1)
