"""Mamba2 (state-space duality) mixer: chunked scan for prefill, O(1)-state decode.

Counterpart of ``repro/models/ssm.py``. ``Mamba`` keeps the JAX package's
parameter names and shapes (``w_z``/``w_x`` ``(D, H, P)``, ``w_dt``
``(D, H)``, ``w_out`` ``(H, P, D)``; ``A_log``, ``D`` and ``dt_bias`` in
f32), so converted weights load as they are. The full-sequence scan goes to
``ops.ssd_scan``: the CUDA kernel for tensors on the card, ``ssd_chunked``
(the chunked matrix form, with the JAX package's semantics) on the CPU. Both
start from a zero state and return y and the final state in f32. Under
autograd (training) the scan runs as ``SSDScanFn``: the forward kernel with
the state entering each chunk, then the backward kernel
(``csrc/ssd_scan_bwd.cu``); on the CPU the plain forward and backward in
``ref``. Per-block remat reruns the forward, which recomputes those states.
Decode is the per-token recurrence on the f32 state in plain PyTorch, as in
the JAX package, which has no kernel for it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_chunked  # noqa: F401  (the plain SSD)
from repro_torch.models.layers import causal_conv1d, merge_heads
from repro_torch.models.module import dense_init, dtype_of


class MambaCache(NamedTuple):
    conv_x: torch.Tensor  # (B, W-1, H, P)
    conv_B: torch.Tensor  # (B, W-1, N)
    conv_C: torch.Tensor  # (B, W-1, N)
    ssm: torch.Tensor     # (B, H, N, P), the recurrent state (f32)


class Mamba(nn.Module):
    """The mixer's parameters, initialised as ``ssm_init`` initialises them."""

    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        d, n, h, p, w = cfg.d_model, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim, \
            cfg.conv_width
        init = dict(dtype=dt, device=device)
        f32 = dict(dtype=torch.float32, device=device)

        def normal(shape, scale):
            x = torch.randn(shape, generator=generator, **f32)
            return nn.Parameter((x * scale).to(dt))

        self.w_z = nn.Parameter(dense_init(generator, d, (h, p), **init))
        self.w_x = nn.Parameter(dense_init(generator, d, (h, p), **init))
        self.w_B = nn.Parameter(dense_init(generator, d, n, **init))
        self.w_C = nn.Parameter(dense_init(generator, d, n, **init))
        self.w_dt = nn.Parameter(dense_init(generator, d, h, **init))
        self.conv_x = normal((w, h, p), 0.1)
        self.conv_x_b = nn.Parameter(torch.zeros((h, p), **init))
        self.conv_B = normal((w, n), 0.1)
        self.conv_B_b = nn.Parameter(torch.zeros(n, **init))
        self.conv_C = normal((w, n), 0.1)
        self.conv_C_b = nn.Parameter(torch.zeros(n, **init))
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, h, **f32)))
        self.D = nn.Parameter(torch.ones(h, **f32))
        self.dt_bias = nn.Parameter(torch.log(torch.expm1(torch.full((h,), 0.01, **f32))))
        self.norm_scale = nn.Parameter(torch.ones((h, p), **init))
        self.w_out = nn.Parameter(dense_init(generator, h * p, d, **init).reshape(h, p, d))


def _head_rmsnorm(scale: torch.Tensor, y: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMS over P (mamba2's grouped RMSNorm). y: (..., H, P)."""
    y32 = y.to(torch.float32)
    var = y32.square().mean(dim=-1, keepdim=True)
    return (y32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(y.dtype)


def _project(p: Mamba, u: torch.Tensor):
    """u: (B, S, D) -> z, x (B, S, H, P); B, C (B, S, N); dt (B, S, H), before the conv."""
    z = torch.einsum("bsd,dhp->bshp", u, p.w_z)
    x = torch.einsum("bsd,dhp->bshp", u, p.w_x)
    B_ = torch.matmul(u, p.w_B)
    C_ = torch.matmul(u, p.w_C)
    dt = torch.matmul(u, p.w_dt)
    return z, x, B_, C_, dt


def _conv_all(p: Mamba, x: torch.Tensor, B_: torch.Tensor, C_: torch.Tensor,
              cfg: ModelConfig):
    b, s, h, hp = x.shape
    xf = causal_conv1d(p.conv_x.reshape(cfg.conv_width, h * hp), x.reshape(b, s, h * hp))
    x = F.silu(xf.reshape(b, s, h, hp) + p.conv_x_b)
    B_ = F.silu(causal_conv1d(p.conv_B, B_) + p.conv_B_b)
    C_ = F.silu(causal_conv1d(p.conv_C, C_) + p.conv_C_b)
    return x, B_, C_


def _ssd_core(p: Mamba, u: torch.Tensor, cfg: ModelConfig):
    s = u.shape[1]
    z, x, B_, C_, dt = _project(p, u)
    tail = None
    if cfg.conv_width > 1:
        keep = s - (cfg.conv_width - 1)
        tail = (x[:, keep:], B_[:, keep:], C_[:, keep:])
    x, B_, C_ = _conv_all(p, x, B_, C_, cfg)
    dt = F.softplus(dt.to(torch.float32) + p.dt_bias)
    A = -torch.exp(p.A_log)
    y, state = ops.ssd_scan(x, dt * A, dt, B_, C_, chunk=cfg.ssm_chunk)
    y = y + p.D[None, None, :, None] * x.to(torch.float32)
    y = _head_rmsnorm(p.norm_scale, y.to(u.dtype) * F.silu(z), cfg.norm_eps)
    out = merge_heads("bshp,hpd->bsd", y, p.w_out)
    return out, state, tail


def ssm_apply(p: Mamba, u: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 mixer. u: (B, S, D) -> (B, S, D)."""
    return _ssd_core(p, u, cfg)[0]


def ssm_prefill(p: Mamba, u: torch.Tensor, cfg: ModelConfig):
    """Full-sequence mixer that also returns the decode cache."""
    out, state, (xt, bt, ct) = _ssd_core(p, u, cfg)
    bf16 = torch.bfloat16
    return out, MambaCache(conv_x=xt.to(bf16), conv_B=bt.to(bf16), conv_C=ct.to(bf16),
                           ssm=state)


def ssm_init_cache(cfg: ModelConfig, batch: int, *, device,
                   dtype: torch.dtype = torch.bfloat16) -> MambaCache:
    n, h, p, w = cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim, cfg.conv_width
    return MambaCache(
        conv_x=torch.zeros((batch, w - 1, h, p), dtype=dtype, device=device),
        conv_B=torch.zeros((batch, w - 1, n), dtype=dtype, device=device),
        conv_C=torch.zeros((batch, w - 1, n), dtype=dtype, device=device),
        ssm=torch.zeros((batch, h, n, p), dtype=torch.float32, device=device),
    )


def ssm_decode(p: Mamba, u: torch.Tensor, cache: MambaCache, cfg: ModelConfig):
    """Single-token recurrent step. u: (B, 1, D). Returns (out, new cache)."""
    z, x_new, B_new, C_new, dt = _project(p, u)

    def roll(state, new, wgt, bias):
        # state (B, W-1, ...), new (B, 1, ...) -> conv output (B, ...), next state
        win = torch.cat([state.to(new.dtype), new], dim=1)
        out = torch.einsum("bw...,w...->b...", win.to(torch.float32),
                           wgt.to(torch.float32)) + bias.to(torch.float32)
        return F.silu(out), win[:, 1:]

    x, new_cx = roll(cache.conv_x, x_new, p.conv_x, p.conv_x_b)
    B_, new_cb = roll(cache.conv_B, B_new, p.conv_B, p.conv_B_b)
    C_, new_cc = roll(cache.conv_C, C_new, p.conv_C, p.conv_C_b)

    dt = F.softplus(dt[:, 0].to(torch.float32) + p.dt_bias)              # (B, H)
    a = torch.exp(dt * -torch.exp(p.A_log))                              # (B, H)
    state = cache.ssm * a[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", B_, x * dt[..., None])
    y = torch.einsum("bn,bhnp->bhp", C_, state)
    y = (y + p.D[None, :, None] * x)[:, None].to(u.dtype)                # (B, 1, H, P)
    y = _head_rmsnorm(p.norm_scale, y * F.silu(z), cfg.norm_eps)
    out = merge_heads("bshp,hpd->bsd", y, p.w_out)
    return out, MambaCache(conv_x=new_cx.to(cache.conv_x.dtype),
                           conv_B=new_cb.to(cache.conv_B.dtype),
                           conv_C=new_cc.to(cache.conv_C.dtype), ssm=state)
