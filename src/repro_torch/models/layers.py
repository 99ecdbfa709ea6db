"""Layers of the dense LM family, and the mamba frontend's causal conv.

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
