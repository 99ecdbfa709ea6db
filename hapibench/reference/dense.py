"""Plain reference of a dense decoder block: pre-norm grouped-query
attention with rotary positions, then a pre-norm SwiGLU MLP, each added to
the residual stream (Mistral's block).

Rotary positions rotate the two halves of each head (theta from the
configuration). Attention is causal with scale 1/sqrt(head_dim) and is
computed a block of queries at a time, so the (S, S) scores never all live.
Weights are named as ``hapibench/weights.py`` names them.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from hapibench.reference.common import Precision, rmsnorm, silu

QUERY_BLOCK = 1024


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd) rotated by its position along S."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    """Causal softmax attention of q (B, S, H, hd) over k, v (B, S, Hkv, hd);
    each group of H / Hkv query heads reads one KV head."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, hd).permute(0, 2, 3, 1, 4)   # (B, Hkv, G, S, hd)
    kt = k.permute(0, 2, 3, 1)[:, :, None]                           # (B, Hkv, 1, hd, S)
    vt = v.permute(0, 2, 1, 3)[:, :, None]                           # (B, Hkv, 1, S, hd)
    pos = torch.arange(s, device=q.device)
    outs = []
    for lo in range(0, s, QUERY_BLOCK):
        qb = qg[:, :, :, lo:lo + QUERY_BLOCK]
        scores = prec.mm(qb, kt) / math.sqrt(hd)
        live = pos[None, :] <= pos[lo:lo + QUERY_BLOCK, None]
        scores = scores.masked_fill(~live, float("-inf"))
        outs.append(prec.mm(torch.softmax(scores, dim=-1), vt))
    out = torch.cat(outs, dim=3)                                     # (B, Hkv, G, S, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, hd)


def block(w: Dict[str, torch.Tensor], pre: str, h: torch.Tensor, m: dict,
          prec: Precision) -> torch.Tensor:
    eps = m["norm_eps"]
    x = rmsnorm(w[pre + "ln_mixer.scale"], h, eps)
    q = rope(prec.einsum("bsd,dhk->bshk", x, w[pre + "attn.wq"]), m["rope_theta"])
    k = rope(prec.einsum("bsd,dhk->bshk", x, w[pre + "attn.wk"]), m["rope_theta"])
    v = prec.einsum("bsd,dhk->bshk", x, w[pre + "attn.wv"])
    h = h + prec.einsum("bshk,hkd->bsd", attention(q, k, v, prec), w[pre + "attn.wo"])
    x = rmsnorm(w[pre + "ln_ffn.scale"], h, eps)
    g = prec.mm(x, w[pre + "mlp.w_gate"])
    u = prec.mm(x, w[pre + "mlp.w_up"])
    return h + prec.mm(silu(g) * u, w[pre + "mlp.w_down"])
