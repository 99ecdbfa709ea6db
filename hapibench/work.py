"""The benchmark's yardstick of work: each hand-written kernel's bytes and
operations, and the card's peaks.

The kernel formulas are a frozen copy of ``repro_torch/kernels/work.py`` as
it stood when the benchmark was written; the program may change its own copy,
this one stays. The peaks are NVIDIA's data sheet for one H100 SXM (dense
rates, no sparsity). Nothing here imports the program.

Model FLOPs are counted from a configuration's widths by its family
(``families/<family>.py``) and its traffic kind (``kinds/<kind>.py``).
"""
from __future__ import annotations

from typing import Tuple

PEAK_BF16 = 989e12        # FLOP/s, tensor cores, dense
PEAK_TF32 = 495e12        # FLOP/s, tensor cores, dense
PEAK_F32 = 67e12          # FLOP/s, outside the tensor cores
HBM_BYTES_S = 3.35e12     # bytes/s
HBM_BYTES = 80e9

Work = Tuple[float, float]     # (bytes moved, operations done)
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def bound_s(work: Work, peak: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak of their type."""
    nbytes, ops = work
    return max(nbytes / HBM_BYTES_S, ops / peak)


def live_pairs(s: int, causal: bool) -> int:
    """(query, key) pairs a causal or full mask leaves live in one sequence."""
    return s * (s + 1) // 2 if causal else s * s


def flash_work(b, s, h, hkv, hd, causal, itemsize) -> Work:
    """q, k, v read and the output written once; two products of 2 hd FLOP
    per live pair and head."""
    return ((2 * b * s * h * hd + 2 * b * s * hkv * hd) * itemsize,
            4 * hd * b * h * live_pairs(s, causal))


def flash_bwd_work(b, s, h, hkv, hd, causal, itemsize) -> Work:
    """q, k, v, o, dO read and dq, dk, dv written once, the log-sum-exp read
    once; five products of 2 hd FLOP per live pair and head."""
    return ((5 * b * s * h * hd + 4 * b * s * hkv * hd) * itemsize + 4 * b * h * s,
            10 * hd * b * h * live_pairs(s, causal))


def ssd_work(b, s, h, p, n, q, itemsize) -> Work:
    """x, B, C in their type, dtA and dt in f32 read once; y and the state
    written once in f32. Operations: per chunk C.B^T over the lower triangle
    once per batch row, and per head the masked (C.B^T * L).(x dt), the
    carried state's C.state and the state update B^T.(x dt)."""
    nbytes = (b * s * h * p + 2 * b * s * n) * itemsize + 2 * b * s * h * 4 \
        + (b * s * h * p + b * h * n * p) * 4
    tri = q * (q + 1) // 2
    chunks = -(-s // q)
    return nbytes, b * chunks * (2 * tri * n + h * (2 * tri * p + 4 * q * n * p))


def ssd_bwd_work(b, s, h, p, n, q, itemsize) -> Work:
    """x, B, C, dtA, dt, the chunk states and dy read once; dx, dB, dC,
    d dtA, d dt written once. Operations: per chunk and row C.B^T over the
    triangle; per head four triangle products and five with the state."""
    chunks = -(-s // q)
    nbytes = (2 * b * s * h * p + 4 * b * s * n) * itemsize + 4 * b * s * h * 4 \
        + (b * chunks * h * n * p + b * s * h * p) * 4
    tri = q * (q + 1) // 2
    return nbytes, b * chunks * (2 * tri * n + h * (2 * tri * (2 * p + 2 * n) + 10 * q * n * p))


def quantize_work(n: int, itemsize: int, n_scales: int) -> Work:
    """x read, the codes and f32 scales written; about 5 operations an element."""
    return n * (itemsize + 1) + n_scales * 4, 5 * n


def dequantize_work(n: int, out_itemsize: int, n_scales: int) -> Work:
    """The codes and f32 scales read, the output written; one multiply an element."""
    return n * (1 + out_itemsize) + n_scales * 4, n
