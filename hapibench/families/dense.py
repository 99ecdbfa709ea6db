"""The dense decoder (Mistral's block): grouped-query attention with rotary
positions and a SwiGLU MLP. Its mixer runs the program's flash kernels."""
from __future__ import annotations

import math
from typing import List

from hapibench import work
from hapibench.reference.dense import block  # noqa: F401  (the family's reference)

SOURCES = ("int8_transfer", "flash_attention", "flash_attention_bwd")
KERNELS = {"forward": "flash_attention", "backward": "flash_attention_bwd"}
ROOFLINE = "flash"
TRACE_NAMES = ("flash_fwd", "bwd_dsum", "bwd_dkdv", "bwd_dq")


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // m["n_heads"]


def block_leaves(m: dict, i: int) -> List[tuple]:
    d, h, hkv, f = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_ff"]
    hd = head_dim(m)
    pre = f"blocks.{i}.sub0."
    return [(pre + "ln_mixer.scale", (d,), ("ones",)),
            (pre + "attn.wq", (d, h, hd), ("normal", 1 / math.sqrt(d))),
            (pre + "attn.wk", (d, hkv, hd), ("normal", 1 / math.sqrt(d))),
            (pre + "attn.wv", (d, hkv, hd), ("normal", 1 / math.sqrt(d))),
            (pre + "attn.wo", (h, hd, d), ("normal", 1 / math.sqrt(h * hd))),
            (pre + "ln_ffn.scale", (d,), ("ones",)),
            (pre + "mlp.w_gate", (d, f), ("normal", 1 / math.sqrt(d))),
            (pre + "mlp.w_up", (d, f), ("normal", 1 / math.sqrt(d))),
            (pre + "mlp.w_down", (f, d), ("normal", 1 / math.sqrt(f)))]


def block_matmul_params(m: dict) -> int:
    """Projection weights a token meets in one block."""
    d, hd = m["d_model"], head_dim(m)
    attn = d * (m["n_heads"] + 2 * m["n_kv_heads"]) * hd + m["n_heads"] * hd * d
    return attn + 3 * d * m["d_ff"]


def mixer_flops(m: dict, rows: int, seq: int, backward: bool) -> float:
    """Attention's two products over the causal live pairs: 4 hd h a pair
    forward, 10 hd h backward."""
    per_pair = (4 + (10 if backward else 0)) * head_dim(m) * m["n_heads"]
    return per_pair * rows * work.live_pairs(seq, True)


def kernel_work(m: dict, rows: int, seq: int, kernel: str) -> work.Work:
    shape = (rows, seq, m["n_heads"], m["n_kv_heads"], head_dim(m), True,
             work.ITEMSIZE[m["compute_dtype"]])
    fn = work.flash_work if kernel == KERNELS["forward"] else work.flash_bwd_work
    return fn(*shape)
