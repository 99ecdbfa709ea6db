"""Mamba-2 layers (the program's ``ssm`` family): a pre-norm SSD mixer and no
MLP. Its mixer runs the program's SSD scan kernels."""
from __future__ import annotations

import math
from typing import List

import torch

from hapibench import work
from hapibench.reference.mamba2 import block  # noqa: F401  (the family's reference)

SOURCES = ("int8_transfer", "ssd_scan", "ssd_scan_bwd")
KERNELS = {"forward": "ssd_scan", "backward": "ssd_scan_bwd"}
ROOFLINE = "ssd"
TRACE_NAMES = ("ssd_scan", "ssd_bwd")


def n_heads(m: dict) -> int:
    return m["ssm_expand"] * m["d_model"] // m["ssm_headdim"]


def block_leaves(m: dict, i: int) -> List[tuple]:
    d, n, p, w = m["d_model"], m["ssm_state"], m["ssm_headdim"], m.get("conv_width", 4)
    h = n_heads(m)
    pre = f"blocks.{i}.sub0."
    mx = pre + "mamba."
    return [(pre + "ln_mixer.scale", (d,), ("ones",)),
            (mx + "w_z", (d, h, p), ("normal", 1 / math.sqrt(d))),
            (mx + "w_x", (d, h, p), ("normal", 1 / math.sqrt(d))),
            (mx + "w_B", (d, n), ("normal", 1 / math.sqrt(d))),
            (mx + "w_C", (d, n), ("normal", 1 / math.sqrt(d))),
            (mx + "w_dt", (d, h), ("normal", 1 / math.sqrt(d))),
            (mx + "conv_x", (w, h, p), ("normal", 0.1)),
            (mx + "conv_x_b", (h, p), ("zeros",)),
            (mx + "conv_B", (w, n), ("normal", 0.1)),
            (mx + "conv_B_b", (n,), ("zeros",)),
            (mx + "conv_C", (w, n), ("normal", 0.1)),
            (mx + "conv_C_b", (n,), ("zeros",)),
            (mx + "A_log", (h,), ("f32", "A_log")),
            (mx + "D", (h,), ("f32", "D")),
            (mx + "dt_bias", (h,), ("f32", "dt_bias")),
            (mx + "norm_scale", (h, p), ("ones",)),
            (mx + "w_out", (h, p, d), ("normal", 1 / math.sqrt(h * p)))]


def f32_vector(kind: str, n: int, device) -> torch.Tensor:
    """The mixer's deterministic f32 vectors: A from 1 to 16 over the heads,
    D 1, dt 0.01 through softplus."""
    f32 = dict(dtype=torch.float32, device=device)
    if kind == "A_log":
        return torch.log(torch.linspace(1.0, 16.0, n, **f32))
    if kind == "D":
        return torch.ones(n, **f32)
    return torch.log(torch.expm1(torch.full((n,), 0.01, **f32)))


def block_matmul_params(m: dict) -> int:
    """Projection weights a token meets in one layer: the in-projection to z,
    x, B, C and dt, and the out-projection (the depthwise conv is not matmul
    work)."""
    d = m["d_model"]
    di = m["ssm_expand"] * d
    return d * (2 * di + 2 * m["ssm_state"] + n_heads(m)) + di * d


def _shape(m: dict, rows: int, seq: int) -> tuple:
    return (rows, seq, n_heads(m), m["ssm_headdim"], m["ssm_state"], m["ssm_chunk"],
            work.ITEMSIZE[m["compute_dtype"]])


def mixer_flops(m: dict, rows: int, seq: int, backward: bool) -> float:
    """The SSD scan's products as ``ssd_work`` (and ``ssd_bwd_work``) count them."""
    shape = _shape(m, rows, seq)
    return work.ssd_work(*shape)[1] + (work.ssd_bwd_work(*shape)[1] if backward else 0)


def kernel_work(m: dict, rows: int, seq: int, kernel: str) -> work.Work:
    fn = work.ssd_work if kernel == KERNELS["forward"] else work.ssd_bwd_work
    return fn(*_shape(m, rows, seq))
