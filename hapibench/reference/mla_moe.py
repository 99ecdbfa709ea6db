"""Plain reference of DeepSeek-V3's block (Moonlight's): pre-norm multi-head
latent attention, then a pre-norm SwiGLU MLP (the first ``first_k_dense``
blocks) or a sigmoid-routed MoE beside shared experts, each added to the
residual stream.

Latent attention (``q_lora_rank`` null): q = x wq, H heads of nope + rope;
[c_kv | k_pe] = x w_kv_a, c_kv RMS-normed; [k_nope | v] = c_kv w_kv_b; rope
(theta from the configuration, the two halves of the rope part rotated) on
q's rope part and on k_pe, one head shared by all; causal softmax at scale
1/sqrt(nope + rope) over v, a block of queries at a time; then wo.

MoE: s = sigmoid(x router) with the router read as f32; the top ``top_k``
of s + b chosen, b the frozen correction bias, ties to the lower expert;
the weights the chosen s over their sum (plus 1e-20), times
``routed_scaling_factor``; each chosen expert's SwiGLU over its own tokens,
``ROWS`` tokens at a time, weighted and added; the shared experts one SwiGLU
of ``n_shared_experts * d_ff``, added unweighted. With one group
(``n_group`` = ``topk_group`` = 1) the group-limited choice keeps every
expert, so it is left out.

Weights are named as ``hapibench/weights.py`` names them. Nothing here
imports the program.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from hapibench.reference.common import Precision, rmsnorm, silu
from hapibench.reference.dense import rope

QUERY_BLOCK = 1024
ROWS = 4096


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """Causal softmax attention of q, k (B, S, H, dqk) over v (B, S, H, dv)."""
    b, s, h, dqk = q.shape
    qt, kt, vt = q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1), v.permute(0, 2, 1, 3)
    pos = torch.arange(s, device=q.device)
    outs = []
    for lo in range(0, s, QUERY_BLOCK):
        scores = prec.mm(qt[:, :, lo:lo + QUERY_BLOCK], kt) / math.sqrt(dqk)
        live = pos[None, :] <= pos[lo:lo + QUERY_BLOCK, None]
        scores = scores.masked_fill(~live, float("-inf"))
        outs.append(prec.mm(torch.softmax(scores, dim=-1), vt))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)                # (B, S, H, dv)


def mla(w: Dict[str, torch.Tensor], pre: str, x: torch.Tensor, m: dict,
        prec: Precision) -> torch.Tensor:
    b, s, _ = x.shape
    h, r, nope = m["n_heads"], m["kv_lora_rank"], m["qk_nope_head_dim"]
    theta = m["rope_theta"]
    q = prec.einsum("bsd,dhk->bshk", x, w[pre + "attn.wq"])
    kv_a = prec.mm(x, w[pre + "attn.w_kv_a"])
    c_kv = rmsnorm(w[pre + "attn.kv_norm.scale"], kv_a[..., :r], m["norm_eps"])
    kv = prec.einsum("bsc,chk->bshk", c_kv, w[pre + "attn.w_kv_b"])
    k_pe = rope(kv_a[..., None, r:], theta).expand(b, s, h, m["qk_rope_head_dim"])
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    out = attention(q, k, kv[..., nope:], prec)
    return prec.einsum("bshk,hkd->bsd", out, w[pre + "attn.wo"])


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    return prec.mm(silu(prec.mm(x, gate)) * prec.mm(x, up), down)


def moe(w: Dict[str, torch.Tensor], pre: str, x: torch.Tensor, m: dict,
        prec: Precision) -> torch.Tensor:
    b, s, d = x.shape
    p = pre + "moe."
    xt = x.reshape(b * s, d)
    scores = torch.sigmoid(prec.mm(xt, w[p + "router"]))
    bias = w[p + "e_score_correction_bias"].float()
    # A stable descending sort puts the lower expert first among equal sums.
    top_e = torch.sort(scores.detach() + bias.detach(), dim=-1, descending=True,
                       stable=True).indices[:, :m["top_k"]]
    # The bias is frozen: it enters the graph times zero only, so that a
    # trained block's bias gets a gradient of zero (the checks leave out a
    # leaf without gradient) and the weights are the chosen scores alone.
    wt = scores.gather(-1, top_e) + (0.0 * bias)[top_e]
    wt = wt / (wt.sum(dim=-1, keepdim=True) + 1e-20) * m["routed_scaling_factor"]
    y = torch.zeros_like(xt)
    for e in range(m["n_experts"]):
        tok, j = torch.nonzero(top_e == e, as_tuple=True)
        for lo in range(0, tok.numel(), ROWS):
            t, c = tok[lo:lo + ROWS], j[lo:lo + ROWS]
            out = swiglu(xt[t], w[p + "w_gate"][e], w[p + "w_up"][e], w[p + "w_down"][e], prec)
            y = y.index_add(0, t, out * wt[t, c, None])
    shared = torch.cat([swiglu(xt[lo:lo + ROWS], w[p + "shared.w_gate"], w[p + "shared.w_up"],
                               w[p + "shared.w_down"], prec)
                        for lo in range(0, xt.shape[0], ROWS)])
    return (y + shared).reshape(b, s, d)


def block(w: Dict[str, torch.Tensor], pre: str, h: torch.Tensor, m: dict,
          prec: Precision) -> torch.Tensor:
    eps = m["norm_eps"]
    h = h + mla(w, pre, rmsnorm(w[pre + "ln_mixer.scale"], h, eps), m, prec)
    x = rmsnorm(w[pre + "ln_ffn.scale"], h, eps)
    if int(pre.split(".")[1]) < m["first_k_dense"]:
        return h + swiglu(x, w[pre + "mlp.w_gate"], w[pre + "mlp.w_up"], w[pre + "mlp.w_down"],
                          prec)
    return h + moe(w, pre, x, m, prec)
