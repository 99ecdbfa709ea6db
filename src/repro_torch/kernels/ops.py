"""Public kernel entry points of the port, dispatched by the tensor's device.

Counterpart of ``repro/kernels/ops.py``. A tensor on the CPU takes the plain
PyTorch version in ``ref``; a CUDA tensor takes the hand-written kernel, and
a kernel that cannot take it raises. There is no backend toggle and no
fallback from the kernel to the plain version. Under autograd, flash
attention runs as ``FlashAttentionFn`` and the SSD scan as ``SSDScanFn``,
each with its backward kernel; the decode kernel has no backward (serving
runs it under ``torch.no_grad``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import int8_transfer as ik
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as sk

# ---------------------------------------------------------------------------
# The authoritative int8 wire-compression ratio (see repro/kernels/ops.py):
# the splitter's prediction and the bytes that extract() emits agree on it.
# ---------------------------------------------------------------------------
WIRE_TILE = 128                 # quantization tile: one scale per 128 lanes
SCALE_DTYPE = torch.float32     # per-tile scales ride the wire in f32


def compression_ratio(dtype: torch.dtype = torch.bfloat16, tile: int = WIRE_TILE) -> float:
    """Exact wire-byte ratio of int8(+per-tile scales) vs raw activations:
    ``(itemsize_q + scale_bytes / tile) / itemsize_act``, 0.515625 for bf16
    with the default 128-lane tile. ``tile`` should be the effective tile
    after the kernels' ``gcd(d, tile)`` clamp."""
    if tile <= 0:
        raise ValueError(f"tile must be > 0, got {tile}")
    return (torch.int8.itemsize + SCALE_DTYPE.itemsize / tile) / dtype.itemsize


INT8_WIRE_RATIO = compression_ratio(torch.bfloat16, WIRE_TILE)


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset."""
    return {
        "flash_attention": fk.launches,
        "flash_attention_bwd": fk.bwd_launches,
        "quantize_int8": ik.quantize_launches,
        "dequantize_int8": ik.dequantize_launches,
        "decode_attention": dk.launches,
        "ssd_scan": sk.launches,
        "ssd_scan_bwd": sk.bwd_launches,
    }


def reset_launch_counts() -> None:
    fk.launches = 0
    fk.bwd_launches = 0
    fk.fwd_routes.update(dict.fromkeys(fk.FWD_ROUTES, 0))
    fk.fwd_shapes.clear()
    fk.bwd_shapes.clear()
    ik.quantize_launches = 0
    ik.quantize_routes.update(vector=0, scalar=0)
    ik.dequantize_launches = 0
    dk.launches = 0
    dk.shapes.clear()
    sk.launches = 0
    sk.bwd_launches = 0


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, S, Hkv, hd) with Hkv dividing H. Where
    autograd is on and an input requires grad, ``FlashAttentionFn`` (the
    forward kernel with its log-sum-exp, then the backward kernel)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return fk.FlashAttentionFn.apply(q, k, v, causal, window, softcap)
    if q.is_cuda:
        return fk.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    n_rep = q.shape[2] // k.shape[2]
    return ref.flash_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                               causal=causal, window=window, softcap=softcap)


def quantize_int8(x: torch.Tensor, tile: int = WIRE_TILE):
    if x.is_cuda:
        return ik.quantize_int8_cuda(x, tile=tile)
    return ref.quantize_int8(x, tile=tile)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if q.is_cuda:
        return ik.dequantize_int8_cuda(q, scales, dtype=dtype)
    return ref.dequantize_int8(q, scales, dtype=dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: int, *, window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, hd) against caches (B, S, Hkv, hd) whose first ``length``
    positions are live; ``length`` is a host int."""
    if q.is_cuda:
        return dk.decode_attention_cuda(q, k_cache, v_cache, length, window=window,
                                        softcap=softcap)
    return ref.decode_attention(q, k_cache, v_cache, length, window=window, softcap=softcap)


def ssd_scan(x: torch.Tensor, dtA: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, *, chunk: int = 256):
    """Mamba2 SSD from a zero state: (y f32 (B, S, H, P), state f32 (B, H, N, P)).
    Where autograd is on and an input requires grad, ``SSDScanFn`` (the
    forward kernel with its states, then the backward kernel)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dtA, dt, B_, C_)):
        return sk.SSDScanFn.apply(x, dtA, dt, B_, C_, chunk)
    if x.is_cuda:
        return sk.ssd_scan_cuda(x, dtA, dt, B_, C_, chunk=chunk)
    return ref.ssd_chunked(x, dtA, dt, B_, C_, chunk=chunk)
