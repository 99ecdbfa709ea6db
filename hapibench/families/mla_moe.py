"""DeepSeek-V3's block (Moonlight's): multi-head latent attention with rotary
positions on a part of each head, then a SwiGLU MLP in the first
``first_k_dense`` blocks and a sigmoid-routed MoE of dropless experts beside
shared ones in the rest. Its mixer runs the program's flash kernels at a Q.K
head dim of nope + rope (192) and a V head dim of its own (128), counted
under the flash kernels' own launch counters."""
from __future__ import annotations

import math
from typing import List

import torch

from hapibench import work
from hapibench.reference.mla_moe import block  # noqa: F401  (the family's reference)

SOURCES = ("int8_transfer", "flash_attention", "flash_attention_bwd")
KERNELS = {"forward": "flash_attention", "backward": "flash_attention_bwd"}
ROOFLINE = "flash"
TRACE_NAMES = ("flash_fwd", "bwd_dsum", "bwd_dkdv", "bwd_dq")


def qk_dim(m: dict) -> int:
    return m["qk_nope_head_dim"] + m["qk_rope_head_dim"]


def block_leaves(m: dict, i: int) -> List[tuple]:
    d, h, r = m["d_model"], m["n_heads"], m["kv_lora_rank"]
    rope, dv = m["qk_rope_head_dim"], m["v_head_dim"]
    pre = f"blocks.{i}.sub0."
    out = [(pre + "ln_mixer.scale", (d,), ("ones",)),
           (pre + "attn.wq", (d, h, qk_dim(m)), ("normal", 1 / math.sqrt(d))),
           (pre + "attn.w_kv_a", (d, r + rope), ("normal", 1 / math.sqrt(d))),
           (pre + "attn.kv_norm.scale", (r,), ("ones",)),
           (pre + "attn.w_kv_b", (r, h, m["qk_nope_head_dim"] + dv),
            ("normal", 1 / math.sqrt(r))),
           (pre + "attn.wo", (h, dv, d), ("normal", 1 / math.sqrt(h * dv))),
           (pre + "ln_ffn.scale", (d,), ("ones",))]
    if i < m["first_k_dense"]:
        f = m["d_ff_dense"]
        return out + [(pre + "mlp.w_gate", (d, f), ("normal", 1 / math.sqrt(d))),
                      (pre + "mlp.w_up", (d, f), ("normal", 1 / math.sqrt(d))),
                      (pre + "mlp.w_down", (f, d), ("normal", 1 / math.sqrt(f)))]
    e, f = m["n_experts"], m["d_ff"]
    fs = m["n_shared_experts"] * f
    moe = pre + "moe."
    return out + [(moe + "router", (d, e), ("normal", 1 / math.sqrt(d))),
                  (moe + "e_score_correction_bias", (e,), ("f32", "bias")),
                  (moe + "w_gate", (e, d, f), ("normal", 1 / math.sqrt(d))),
                  (moe + "w_up", (e, d, f), ("normal", 1 / math.sqrt(d))),
                  (moe + "w_down", (e, f, d), ("normal", 1 / math.sqrt(f))),
                  (moe + "shared.w_gate", (d, fs), ("normal", 1 / math.sqrt(d))),
                  (moe + "shared.w_up", (d, fs), ("normal", 1 / math.sqrt(d))),
                  (moe + "shared.w_down", (fs, d), ("normal", 1 / math.sqrt(fs)))]


def f32_vector(kind: str, n: int, device) -> torch.Tensor:
    """The router's correction bias: 0.1 sin(2 e + 0.5) over the experts e,
    non-zero and uneven, so that a program that leaves it out of the choice
    routes otherwise."""
    if kind != "bias":
        raise ValueError(f"no f32 vector {kind!r}")
    e = torch.arange(n, dtype=torch.float32, device=device)
    return 0.1 * torch.sin(2.0 * e + 0.5)


def block_matmul_params(m: dict) -> int:
    """Projection weights a token meets in a MoE block: wq, w_kv_a, w_kv_b
    and wo with the latent's 512 norm scales (as the program's count has
    them), the router, its 6 experts and the shared experts: 83,100,160 at
    Moonlight's widths. The dense block 0 meets 82,969,088, 0.16% fewer;
    every block is counted at the MoE block's."""
    d, h, r = m["d_model"], m["n_heads"], m["kv_lora_rank"]
    dv = m["v_head_dim"]
    attn = (d * h * qk_dim(m) + d * (r + m["qk_rope_head_dim"]) + r
            + r * h * (m["qk_nope_head_dim"] + dv) + h * dv * d)
    f = m["d_ff"]
    moe = d * m["n_experts"] + 3 * d * f * (m["top_k"] + m["n_shared_experts"])
    return attn + moe


def mixer_flops(m: dict, rows: int, seq: int, backward: bool) -> float:
    """Attention's products over the causal live pairs: 2 (dqk + dv) a pair
    and head forward, 2 (3 dqk + 2 dv) backward."""
    dqk, dv = qk_dim(m), m["v_head_dim"]
    per_pair = 2 * (dqk + dv) + (2 * (3 * dqk + 2 * dv) if backward else 0)
    return per_pair * m["n_heads"] * rows * work.live_pairs(seq, True)


def kernel_work(m: dict, rows: int, seq: int, kernel: str) -> work.Work:
    """One launch's bytes and operations, ``work.flash_work`` and
    ``work.flash_bwd_work`` with V's head dim apart from Q.K's: forward, q
    and k at dqk and v and the output at dv, each read or written once;
    backward, the query side's 5 tensors as 2 at dqk and 3 at dv, the key
    side's 4 as 2 at dqk and 2 at dv, and the log-sum-exp once."""
    b, s, h = rows, seq, m["n_heads"]
    dqk, dv = qk_dim(m), m["v_head_dim"]
    item = work.ITEMSIZE[m["compute_dtype"]]
    pairs = b * h * work.live_pairs(s, True)
    if kernel == KERNELS["forward"]:
        return 2 * b * s * h * (dqk + dv) * item, 2 * (dqk + dv) * pairs
    return ((b * s * h * (2 * dqk + 3 * dv) + 2 * b * s * h * (dqk + dv)) * item
            + 4 * b * h * s, 2 * (3 * dqk + 2 * dv) * pairs)
