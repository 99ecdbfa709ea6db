"""Plain reference of Moonlight-16B-A3B (DeepSeek-V3's block), independent of
the port's model code and kernels: float32 with TF32 off, no cache, no
grouped products, no batching tricks. The port's model is held to it.

The model as the port runs it:
  * token embeddings times sqrt(d_model), the port's choice for every family
    (the published model does not scale them);
  * each block: x = RMSNorm(h); h += MLA(x); x = RMSNorm(h); h += FFN(x);
  * MLA (``q_lora_rank`` null): q = x wq (H heads of nope + rope), [c_kv |
    k_pe] = x w_kv_a, c_kv RMS-normed, [k_nope | v] = c_kv w_kv_b; rope on
    q's rope part and on k_pe, one head shared by all; causal softmax at
    scale 1/sqrt(nope + rope) over v; then wo;
  * FFN: a SwiGLU of ``d_ff_dense`` in the first ``first_k_dense`` blocks,
    else the MoE: s = sigmoid(x router) in f32, the top ``top_k`` of s + b
    (b the frozen correction bias; ties to the lower expert), weights s of
    the chosen over their sum (plus 1e-20), times ``routed_scaling_factor``;
    each chosen expert's SwiGLU of ``d_ff``, weighted and summed; plus the
    shared experts, one SwiGLU of ``n_shared_experts * d_ff``, unweighted;
  * the final RMSNorm and the untied head, logits in f32 with the padded
    vocabulary masked; the mean next-token cross entropy.

Departures from the published model, each the port's too: rope rotates the
two halves of the rope part where the published code pairs neighbouring
dims (a fixed permutation of the rope columns of ``wq`` and ``w_kv_a``, the
same model); the embedding scale above; the correction bias frozen, its
update rule and the ``seq_aux`` balance loss (pretraining devices) left out
of the fine-tune's loss.

``weights`` maps the port's ``state_dict`` names to tensors; ``cfg`` is any
object with the ``ModelConfig`` fields. ``variant`` plants a departure, for
the tests that the comparison sees it: "bias_ignored" (the bias left out of
the choice), "bias_in_weights" (added to the weights too), "no_scale" (the
2.446 left out), "no_shared" (the shared experts left out), "kpe_per_head"
(K's rope part no longer one head shared by all: head h's rotated as if h
positions later), "rope_on_nope" (rope over the whole of Q and K),
"scale_128" (scale 1/sqrt(128)).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

VARIANTS = ("bias_ignored", "bias_in_weights", "no_scale", "no_shared", "kpe_per_head",
            "rope_on_nope", "scale_128")


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, theta: float, shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, S, H, n) rotated by its position along S (halves paired);
    ``shift`` (H,) adds a per-head position offset (a planted departure)."""
    s, n = x.shape[1], x.shape[-1]
    half = n // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    pos = torch.arange(s, dtype=torch.float32, device=x.device)[:, None]
    if shift is not None:
        pos = pos + shift[None, :]
    ang = pos[..., None] * freqs                                     # (S, 1 or H, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal softmax attention of q, k (B, S, H, dqk) over v (B, S, H, dv)."""
    s = q.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    live = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~live, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def mla(w: Dict[str, torch.Tensor], pre: str, x: torch.Tensor, cfg,
        variant: Optional[str] = None) -> torch.Tensor:
    h, r, nope = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    b, s, _ = x.shape
    q = torch.einsum("bsd,dhk->bshk", x, w[pre + "attn.wq"].float())
    kv_a = x @ w[pre + "attn.w_kv_a"].float()
    c_kv = rmsnorm(w[pre + "attn.kv_norm.scale"], kv_a[..., :r], cfg.norm_eps)
    kv = torch.einsum("bsc,chk->bshk", c_kv, w[pre + "attn.w_kv_b"].float())
    k_nope, v = kv[..., :nope], kv[..., nope:]
    k_pe = kv_a[..., None, r:].expand(b, s, h, cfg.qk_rope_head_dim)
    theta = cfg.rope_theta
    if variant == "rope_on_nope":
        qq = rope(q, theta)
        kk = rope(torch.cat([k_nope, k_pe], dim=-1), theta)
    else:
        shift = (torch.arange(h, dtype=torch.float32, device=x.device)
                 if variant == "kpe_per_head" else None)
        qq = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
        kk = torch.cat([k_nope, rope(k_pe, theta, shift)], dim=-1)
    dqk = 128 if variant == "scale_128" else nope + cfg.qk_rope_head_dim
    out = attention(qq, kk, v, 1.0 / math.sqrt(dqk))
    return torch.einsum("bshk,hkd->bsd", out, w[pre + "attn.wo"].float())


def swiglu(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
           down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ gate.float()) * (x @ up.float())) @ down.float()


def route(w: Dict[str, torch.Tensor], pre: str, x: torch.Tensor, cfg,
          variant: Optional[str] = None):
    """The chosen experts (T, K) and their weights (T, K) of tokens x (T, D)."""
    s = torch.sigmoid(x @ w[pre + "moe.router"].float())
    bias = w[pre + "moe.e_score_correction_bias"].float()
    choice = s if variant == "bias_ignored" else s + bias
    top_e = torch.sort(choice.detach(), dim=-1, descending=True, stable=True).indices
    top_e = top_e[:, :cfg.top_k]
    wt = (s + bias if variant == "bias_in_weights" else s).gather(-1, top_e)
    wt = wt / (wt.sum(dim=-1, keepdim=True) + 1e-20)
    if variant != "no_scale":
        wt = wt * cfg.routed_scaling_factor
    return top_e, wt


def moe(w: Dict[str, torch.Tensor], pre: str, x: torch.Tensor, cfg,
        variant: Optional[str] = None) -> torch.Tensor:
    """Every token through each of its chosen experts, one expert at a time."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    top_e, wt = route(w, pre, xt, cfg, variant)
    y = torch.zeros_like(xt)
    for e in range(cfg.n_experts):
        tok, j = torch.nonzero(top_e == e, as_tuple=True)
        if tok.numel():
            out = swiglu(xt[tok], w[pre + "moe.w_gate"][e], w[pre + "moe.w_up"][e],
                         w[pre + "moe.w_down"][e])
            y = y.index_add(0, tok, out * wt[tok, j, None])
    if cfg.n_shared_experts and variant != "no_shared":
        y = y + swiglu(xt, w[pre + "moe.shared.w_gate"], w[pre + "moe.shared.w_up"],
                       w[pre + "moe.shared.w_down"])
    return y.reshape(b, s, d)


def block(w: Dict[str, torch.Tensor], i: int, h: torch.Tensor, cfg,
          variant: Optional[str] = None) -> torch.Tensor:
    pre = f"blocks.{i}.sub0."
    x = rmsnorm(w[pre + "ln_mixer.scale"], h, cfg.norm_eps)
    h = h + mla(w, pre, x, cfg, variant)
    x = rmsnorm(w[pre + "ln_ffn.scale"], h, cfg.norm_eps)
    if i < cfg.first_k_dense:
        return h + swiglu(x, w[pre + "mlp.w_gate"], w[pre + "mlp.w_up"], w[pre + "mlp.w_down"])
    return h + moe(w, pre, x, cfg, variant)


def embed(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg) -> torch.Tensor:
    return w["embed"][tokens.long()].float() * math.sqrt(cfg.d_model)


def logits(w: Dict[str, torch.Tensor], h: torch.Tensor, cfg) -> torch.Tensor:
    x = rmsnorm(w["final_norm.scale"], h, cfg.norm_eps)
    out = x @ w["unembed"].float().t()
    pad = torch.arange(out.shape[-1], device=out.device) >= cfg.vocab_size
    return out.masked_fill(pad, -1e30)


def forward(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg, lo: int = 0,
            hi: Optional[int] = None, h: Optional[torch.Tensor] = None,
            variant: Optional[str] = None) -> torch.Tensor:
    """Blocks [lo, hi) over ``h`` (by default the tokens' embeddings)."""
    h = embed(w, tokens, cfg) if h is None else h.float()
    for i in range(lo, cfg.n_layers if hi is None else hi):
        h = block(w, i, h, cfg, variant)
    return h


def loss(w: Dict[str, torch.Tensor], tokens: torch.Tensor, cfg,
         variant: Optional[str] = None) -> torch.Tensor:
    """The mean next-token cross entropy of the whole model."""
    out = logits(w, forward(w, tokens, cfg, variant=variant), cfg)
    return F.cross_entropy(out[:, :-1].reshape(-1, out.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())
