"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro/kernels/ref.py`` for the kernels of the forward
pushdown path. ``ops`` takes them for tensors on the CPU, and the card's
checks hold each CUDA kernel against them on the same inputs.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, H, hd) — KV already repeated to H
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    b, s, h, hd = q.shape
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window - 1
    scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def quantize_int8(x: torch.Tensor, tile: int = 128):
    """Per-tile symmetric int8 quantization over the last dim.
    Returns (q int8 (..., D), scales f32 (..., D/tile))."""
    *lead, d = x.shape
    tile = math.gcd(d, tile)  # clamp for narrow (smoke) widths
    xt = x.reshape(*lead, d // tile, tile).to(torch.float32)
    amax = xt.abs().amax(dim=-1, keepdim=True)
    # Divide by a tensor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its rounded reciprocal, one ulp off IEEE division.
    scale = torch.clamp(amax, min=1e-8) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(xt / scale), -127, 127).to(torch.int8)
    return q.reshape(*lead, d), scale[..., 0]


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    *lead, d = q.shape
    tile = d // scales.shape[-1]
    qt = q.reshape(*lead, d // tile, tile).to(torch.float32)
    x = qt * scales[..., None]
    return x.reshape(*lead, d).to(dtype)
