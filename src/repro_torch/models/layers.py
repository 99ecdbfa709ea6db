"""Layers of the LM families and of the encoder-decoder, and the mamba
frontend's causal conv.

Counterpart of ``repro/models/layers.py``. Each layer is an ``nn.Module``
whose parameters keep the JAX package's names and shapes (``wq`` is
``(d_model, n_heads, head_dim)``, ``wo`` is ``(n_heads, head_dim, d_model)``),
so converted weights load as they are, and a plain function that applies it.
Casts sit where the JAX layers put them. Attention goes to
``ops.flash_attention`` and single-token decode to ``ops.decode_attention``:
the CUDA kernels for tensors on the card, the plain versions on the CPU; K
and V keep their ``n_kv_heads`` heads, in the cache too, and are never
repeated on the card. Projections stay ``torch.matmul``, as the JAX package
left them to XLA.

The MoE FFN (``MoE``, ``moe_apply``) follows the reference step for step:
groups are batch rows, the top k of an f32 softmax taken in JAX's order
(the lower expert first among equal probabilities), slots sorted stably by
expert into capacity buffers, the later tokens of an over-full expert
dropped, the experts' SwiGLU batched over the expert axis with ``bmm``
(einsums in the reference, outside any Pallas kernel). The combine gathers,
for each token, its kept slots and adds them in ascending expert order in
f32, where the reference scatter-adds: no atomics, so two calls on the card
give the same bits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.module import dense_init, dtype_of


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, dtype: torch.dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x, self.eps)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """f32 mean and (biased) variance, ``rsqrt(var + eps)``, then scale and
    bias in f32, cast back to x's dtype."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, dtype: torch.dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(self.scale, self.bias, x, self.eps)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE. x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    f32 = dict(dtype=torch.float32, device=x.device)
    freqs = torch.exp(-torch.log(torch.tensor(theta, **f32))
                      * torch.arange(0, half, **f32) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hdim
        init = dict(dtype=dt, device=device)
        self.wq = nn.Parameter(dense_init(generator, d, (hq, hd), **init))
        self.wk = nn.Parameter(dense_init(generator, d, (hkv, hd), **init))
        self.wv = nn.Parameter(dense_init(generator, d, (hkv, hd), **init))
        self.wo = nn.Parameter(dense_init(generator, hq * hd, d, **init).reshape(hq, hd, d))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(hq, hd, **init))
            self.bk = nn.Parameter(torch.zeros(hkv, hd, **init))
            self.bv = nn.Parameter(torch.zeros(hkv, hd, **init))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.norm_eps, **init)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, **init)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if cfg.qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def attend(p: Attention, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ModelConfig, *, window: Optional[int] = None,
           causal: bool = True) -> torch.Tensor:
    """Attention of projected q (B, S, H, hd) over k, v (B, S, Hkv, hd), then
    the output projection."""
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.attn_softcap)
    return torch.einsum("bshd,hdm->bsm", out, p.wo)


def attention_apply(
    p: Attention,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    return attend(p, q, k, v, cfg, window=window, causal=causal)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Smax, Hkv, hd)
    v: torch.Tensor


def attention_decode(
    p: Attention,
    x: torch.Tensor,       # (B, 1, D)
    cache: KVCache,
    pos: int,              # current position, a host int
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
):
    """Single-token decode against a filled KV cache. The new K and V are
    written into ``cache`` at ``pos`` in place (the JAX layer returns an
    updated copy), and the same cache is returned. Keys ``<= pos`` are live,
    and with ``window`` only those ``>= pos - window``."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    cache.k[:, pos] = k_new[:, 0].to(cache.k.dtype)
    cache.v[:, pos] = v_new[:, 0].to(cache.v.dtype)
    out = ops.decode_attention(q[:, 0], cache.k, cache.v, pos + 1, window=window,
                               softcap=cfg.attn_softcap)
    y = torch.einsum("bhd,hdm->bm", out.to(p.wo.dtype), p.wo)
    return y[:, None], cache


# ---------------------------------------------------------------------------
# Dense (SwiGLU) MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator):
        super().__init__()
        init = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = nn.Parameter(dense_init(generator, d, f, **init))
        self.w_up = nn.Parameter(dense_init(generator, d, f, **init))
        self.w_down = nn.Parameter(dense_init(generator, f, d, **init))


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, p.w_gate)
    u = torch.matmul(x, p.w_up)
    return torch.matmul(F.silu(g) * u, p.w_down)


# ---------------------------------------------------------------------------
# Mixture of experts: sort/gather dispatch, capacity buffers, gather combine
# ---------------------------------------------------------------------------
class MoE(nn.Module):
    """``router`` (d, E) in f32 whatever ``param_dtype`` is; ``w_gate`` and
    ``w_up`` (E, d, f), ``w_down`` (E, f, d) in ``param_dtype``."""

    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator):
        super().__init__()
        init = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = nn.Parameter(dense_init(generator, d, e, torch.float32, device))

        def experts(fan_in, fan_out):
            return torch.stack([dense_init(generator, fan_in, fan_out, **init)
                                for _ in range(e)])

        self.w_gate = nn.Parameter(experts(d, f))
        self.w_up = nn.Parameter(experts(d, f))
        self.w_down = nn.Parameter(experts(f, d))


class Routing(NamedTuple):
    """Where ``moe_apply`` sends each token. Slot (t, j) is token t's j-th
    choice; the buffers are (B, E, cap)."""
    top_e: torch.Tensor    # (B, S, K) experts, in descending probability
    top_p: torch.Tensor    # (B, S, K) their renormalised probabilities, f32
    rank: torch.Tensor     # (B, S, K) the slot's place in its expert's buffer
    buf_tok: torch.Tensor  # (B, E, cap) the token feeding each buffer slot
    valid: torch.Tensor    # (B, E, cap) the buffer slot holds a token
    cap: int

    @property
    def kept(self) -> torch.Tensor:
        """(B, S, K) the slot made it into its expert's buffer."""
        return self.rank < self.cap


def _gate_probs(p: MoE, x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(torch.matmul(x.to(torch.float32), p.router), dim=-1)


def moe_route(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The dispatch of ``moe_apply`` over x (B, S, D)."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = min(int(cfg.capacity_factor * s * k / e + 1), s)
    # jax.lax.top_k's order: a stable descending sort puts the lower expert
    # first among equal probabilities (torch.topk does not).
    top_p, top_e = torch.sort(_gate_probs(p, x), dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(b, s * k)                       # slot -> expert
    sort_idx = torch.sort(flat_e, dim=-1, stable=True).indices
    sorted_tok = sort_idx // k                             # slot -> its token
    counts = F.one_hot(flat_e, e).sum(dim=1)               # (B, E)
    offsets = torch.cumsum(counts, dim=-1) - counts        # exclusive
    grid_c = torch.arange(cap, device=x.device)
    gather_pos = offsets[:, :, None] + grid_c              # (B, E, C)
    valid = grid_c < counts[:, :, None]
    gather_pos = torch.clamp(gather_pos, 0, s * k - 1)
    buf_tok = sorted_tok.gather(1, gather_pos.reshape(b, e * cap)).reshape(b, e, cap)
    # A slot's place among its expert's slots, in token order.
    inv = torch.argsort(sort_idx, dim=-1)
    rank = (inv - offsets.gather(1, flat_e)).reshape(b, s, k)
    return Routing(top_e, top_p, rank, buf_tok, valid, cap)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE over tokens of one group. x: (B, S, D) -> (B, S, D)."""
    b, s, d = x.shape
    e = cfg.n_experts
    r = moe_route(p, x, cfg)
    cap = r.cap

    # Dispatch (a gather), invalid buffer slots zero.
    idx = r.buf_tok.reshape(b, e * cap, 1).expand(-1, -1, d)
    xb = x.gather(1, idx).reshape(b, e, cap, d)
    xb = xb.masked_fill(~r.valid[..., None], 0)

    # Expert FFN, batched over E.
    xe = xb.transpose(0, 1).reshape(e, b * cap, d)
    h = F.silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    yb = torch.bmm(h, p.w_down).reshape(e, b, cap, d).transpose(0, 1)
    yb = yb.reshape(b, e * cap, d)

    # Combine: each token gathers its kept slots and adds them in f32, in
    # ascending expert order (the order of the reference's scatter-add).
    order = torch.argsort(r.top_e, dim=-1)
    e_s, p_s, c_s = (t.gather(-1, order) for t in (r.top_e, r.top_p, r.rank))
    slot = (e_s * cap + torch.clamp(c_s, max=cap - 1)).reshape(b, -1, 1)
    rows = yb.gather(1, slot.expand(-1, -1, d)).reshape(b, s, -1, d)
    contrib = torch.where((c_s < cap)[..., None], rows.to(torch.float32) * p_s[..., None], 0.0)
    y = contrib[:, :, 0]
    for j in range(1, contrib.shape[2]):
        y = y + contrib[:, :, j]
    return y.to(x.dtype)


def moe_aux_loss(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style)."""
    probs = _gate_probs(p, x)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = F.one_hot(top1, cfg.n_experts).to(torch.float32).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)


# ---------------------------------------------------------------------------
# Depthwise causal conv (mamba frontend)
# ---------------------------------------------------------------------------
def causal_conv1d(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. w: (W, C), x: (B, S, C); summed in f32."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + s].to(torch.float32) * w[i]
    return out.to(x.dtype)
