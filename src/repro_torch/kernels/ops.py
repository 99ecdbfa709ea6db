"""Public kernel entry points of the port, dispatched by the tensor's device.

Counterpart of ``repro/kernels/ops.py``. A tensor on the CPU takes the plain
PyTorch version in ``ref``; a CUDA tensor takes the hand-written kernel, and
a kernel that cannot take it raises. There is no backend toggle and no
fallback from the kernel to the plain version. Under autograd, flash
attention runs as ``FlashAttentionFn`` and the SSD scan as ``SSDScanFn``,
each with its backward kernel; the decode kernel has no backward (serving
runs it under ``torch.no_grad``).

A meta tensor (the dry-run) takes neither: the entry point returns outputs
of the right shape and records the kernel's work (``kernels/work.py``), as
the kernel's wrapper does each time it launches on the card.

A DTensor goes through ``local_map`` with the placements the JAX package's
constraints pin at that site, and the kernel (or, on the CPU, the plain
version) runs on each rank's local shard: attention takes the batch over
the data axes and the heads over the model axis where they divide, else
replicated. Where the query heads divide the model axis and the KV heads do
not (GQA: 8 KV heads on 16 ranks), K and V stay replicated over it and each
rank slices the KV heads its own query heads read, whose gradients are then
partial sums over the model axis. Decode takes its caches with the sequence
whole (a sequence-sharded cache is gathered first); the SSD scan takes the
heads over the model axis and B and C replicated; the int8 boundary takes
the batch over the data axes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.distributed.autoshard import (
    data_placements, mesh_model_size, model_partial, with_model)
from repro_torch.kernels import decode_attention as dk
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import int8_transfer as ik
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as sk
from repro_torch.kernels import work

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


# ---------------------------------------------------------------------------
# The seam on DTensors
# ---------------------------------------------------------------------------
def _head_split(mesh, h: int, hkv: int):
    """How ``h`` query and ``hkv`` KV heads go over the model axis: "shard"
    (both divide), "slice" (the query heads divide; each rank reads the KV
    heads of its own query heads), or None (replicated)."""
    m = mesh_model_size(mesh)
    if m <= 1 or h % m:
        return None
    if hkv % m == 0:
        return "shard"
    hl, rep = h // m, h // hkv
    return "slice" if hl % rep == 0 or rep % hl == 0 else None


def _kv_slice(mesh, h: int, hkv: int) -> slice:
    """The KV heads this rank's query heads read, where ``_head_split`` is
    "slice"."""
    hl, rep = h // mesh_model_size(mesh), h // hkv
    r = mesh.get_local_rank("model")
    return slice((r * hl) // rep, ((r + 1) * hl - 1) // rep + 1)


def _sharded(fn, args, in_pl, out_pl, grad_pl=None):
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=args[0].device_mesh,
                     redistribute_inputs=True)(*args)


def _flash_sharded(q, k, v, causal, window, softcap):
    mesh = q.device_mesh
    b, _, h, _ = q.shape
    hkv = k.shape[2]
    base = data_placements(mesh, b)
    split = _head_split(mesh, h, hkv)
    qp = with_model(mesh, base, Shard(2) if split else Replicate())
    kp = with_model(mesh, base, Shard(2) if split == "shard" else Replicate())
    kg = model_partial(mesh, kp) if split == "slice" else kp
    kv = _kv_slice(mesh, h, hkv) if split == "slice" else slice(None)

    def local(ql, kl, vl):
        return flash_attention(ql, kl[:, :, kv], vl[:, :, kv], causal=causal, window=window,
                               softcap=softcap)

    return _sharded(local, (q, k, v), (qp, kp, kp), (list(qp),), (qp, kg, kg))


def _decode_sharded(q, k_cache, v_cache, length, window, softcap):
    mesh = q.device_mesh
    b, hq, _ = q.shape
    hkv = k_cache.shape[2]
    base = data_placements(mesh, b)
    split = _head_split(mesh, hq, hkv)
    qp = with_model(mesh, base, Shard(1) if split else Replicate())
    kp = with_model(mesh, base, Shard(2) if split == "shard" else Replicate())
    kv = _kv_slice(mesh, hq, hkv) if split == "slice" else slice(None)

    def local(ql, kl, vl):
        return decode_attention(ql, kl[:, :, kv], vl[:, :, kv], length, window=window,
                                softcap=softcap)

    return _sharded(local, (q, k_cache, v_cache), (qp, kp, kp), (list(qp),))


def _ssd_sharded(x, dtA, dt, B_, C_, chunk):
    mesh = x.device_mesh
    b, _, h, _ = x.shape
    base = data_placements(mesh, b)
    heads = mesh_model_size(mesh) > 1 and h % mesh_model_size(mesh) == 0
    xp = with_model(mesh, base, Shard(2) if heads else Replicate())
    bp = with_model(mesh, base, Replicate())
    bg = model_partial(mesh, bp) if heads else bp
    yp, sp = list(xp), list(with_model(mesh, base, Shard(1) if heads else Replicate()))

    def local(*a):
        return ssd_scan(*a, chunk=chunk)

    return _sharded(local, (x, dtA, dt, B_, C_), (xp, xp, xp, bp, bp), (yp, sp),
                    (xp, xp, xp, bg, bg))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """q, k (B, S, H or Hkv, hd); v (B, S, Hkv, hdv), hdv = hd but at latent
    attention's (192, 128); Hkv dividing H. Where
    autograd is on and an input requires grad, ``FlashAttentionFn`` (the
    forward kernel with its log-sum-exp, then the backward kernel)."""
    if isinstance(q, DTensor):
        return _flash_sharded(q, k, v, causal, window, softcap)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return fk.FlashAttentionFn.apply(q, k, v, causal, window, softcap)
    if q.is_meta:
        return fk.flash_attention_meta(q, k, v, causal=causal, window=window)
    if q.is_cuda:
        return fk.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    n_rep = q.shape[2] // k.shape[2]
    return ref.flash_attention(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep),
                               causal=causal, window=window, softcap=softcap)


def quantize_int8(x: torch.Tensor, tile: int = WIRE_TILE):
    if isinstance(x, DTensor):
        pl = with_model(x.device_mesh, data_placements(x.device_mesh, x.shape[0]),
                         Replicate())
        return _sharded(lambda xl: quantize_int8(xl, tile), (x,), (pl,), (list(pl), list(pl)))
    if x.is_meta:
        import math
        *lead, d = x.shape
        s = torch.empty((*lead, d // math.gcd(d, tile)), dtype=torch.float32, device=x.device)
        work.tally("quantize_int8", work.quantize_work(x.numel(), x.element_size(), s.numel()))
        return torch.empty(x.shape, dtype=torch.int8, device=x.device), s
    if x.is_cuda:
        return ik.quantize_int8_cuda(x, tile=tile)
    return ref.quantize_int8(x, tile=tile)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    if isinstance(q, DTensor):
        pl = with_model(q.device_mesh, data_placements(q.device_mesh, q.shape[0]),
                         Replicate())
        return _sharded(lambda ql, sl: dequantize_int8(ql, sl, dtype), (q, scales), (pl, pl),
                        (list(pl),))
    if q.is_meta:
        out = torch.empty(q.shape, dtype=dtype, device=q.device)
        work.tally("dequantize_int8", work.dequantize_work(q.numel(), out.element_size(),
                                                            scales.numel()))
        return out
    if q.is_cuda:
        return ik.dequantize_int8_cuda(q, scales, dtype=dtype)
    return ref.dequantize_int8(q, scales, dtype=dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     length: int, *, window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, hd) against caches (B, S, Hkv, hd) whose first ``length``
    positions are live; ``length`` is a host int."""
    if isinstance(q, DTensor):
        return _decode_sharded(q, k_cache, v_cache, length, window, softcap)
    if q.is_meta:
        b, hq, hd = q.shape
        work.tally("decode_attention", work.decode_work(
            b, hq, k_cache.shape[2], hd, work.decode_live(int(length), window),
            k_cache.element_size()))
        return torch.empty((b, hq, hd), dtype=k_cache.dtype, device=q.device)
    if q.is_cuda:
        return dk.decode_attention_cuda(q, k_cache, v_cache, length, window=window,
                                        softcap=softcap)
    return ref.decode_attention(q, k_cache, v_cache, length, window=window, softcap=softcap)


def ssd_scan(x: torch.Tensor, dtA: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, *, chunk: int = 256):
    """Mamba2 SSD from a zero state: (y f32 (B, S, H, P), state f32 (B, H, N, P)).
    Where autograd is on and an input requires grad, ``SSDScanFn`` (the
    forward kernel with its states, then the backward kernel)."""
    if isinstance(x, DTensor):
        return _ssd_sharded(x, dtA, dt, B_, C_, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dtA, dt, B_, C_)):
        return sk.SSDScanFn.apply(x, dtA, dt, B_, C_, chunk)
    if x.is_meta:
        return sk.ssd_scan_meta(x, B_, chunk=chunk)
    if x.is_cuda:
        return sk.ssd_scan_cuda(x, dtA, dt, B_, C_, chunk=chunk)
    return ref.ssd_chunked(x, dtA, dt, B_, C_, chunk=chunk)
