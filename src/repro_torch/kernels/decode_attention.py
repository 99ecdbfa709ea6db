"""GQA decode attention of one token: the wrapper of the CUDA kernel.

Counterpart of ``repro/kernels/decode_attention.py``. The kernel is in
``csrc/decode_attention.cu``: flash-decoding, the live keys of each (batch,
KV head) cut into parts of one warp each, then a pass that combines the
parts. ``length`` is a host int, so a decode step never waits on the card to
learn it, and it sizes the grid: only live keys are read. ``window`` admits
``kpos >= length - 1 - window`` (gemma2's local layers); with ``window=None``
the kernel computes the Pallas kernel's function.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import softmax_scale

HEAD_DIMS = (64, 128, 256)
GROUP_SIZES = (1, 2, 4, 8)       # query heads per KV head
TILE = 32                        # keys a warp stages at once
TARGET_WARPS = 4096              # parts of all (batch, KV head) pairs in flight
_SIGNATURES = {
    "decode_attention_fwd": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def live_keys(length: int, window: Optional[int]) -> tuple:
    """The live key range [lo, hi) of a cache filled to ``length``."""
    lo = 0 if window is None else max(0, length - 1 - window)
    return lo, length


def partition(n_keys: int, pairs: int) -> tuple:
    """(keys_per_part, n_parts): parts of whole 32-key tiles, enough of them
    over ``pairs`` (batch, KV head) pairs to give about TARGET_WARPS warps."""
    target = max(1, math.ceil(TARGET_WARPS / pairs))
    per = TILE * max(1, math.ceil(n_keys / (TILE * target)))
    return per, math.ceil(n_keys / per)


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                          length: int, *, window: Optional[int] = None,
                          softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, Hq, hd); k_cache, v_cache (B, S, Hkv, hd); keys < ``length`` live.
    q has the caches' dtype or float32; the result has the caches' dtype."""
    global launches
    b, hq, hd = q.shape
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4 or k_cache.shape[0] != b \
            or k_cache.shape[3] != hd:
        raise ValueError(f"caches {tuple(k_cache.shape)} / {tuple(v_cache.shape)} do not "
                         f"match q {tuple(q.shape)}")
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if hkv == 0 or hq % hkv or hq // hkv not in GROUP_SIZES:
        raise ValueError(f"{hq} query heads over {hkv} KV heads: groups of "
                         f"{GROUP_SIZES} only")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if k_cache.dtype not in _DTYPE_CODE or v_cache.dtype != k_cache.dtype \
            or q.dtype not in (k_cache.dtype, torch.float32):
        raise TypeError(f"the caches must share float32 or bfloat16 and q their dtype "
                        f"or float32, got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    length = int(length)
    if not 1 <= length <= s:
        raise ValueError(f"length {length} outside [1, {s}]")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"the decode attention kernel has no backward; {name} "
                               "requires grad")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit last stride")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"{name} needs 16-byte aligned rows")
    lo, hi = live_keys(length, window)
    per, n_parts = partition(hi - lo, b * hkv)
    rep = hq // hkv
    f32 = dict(dtype=torch.float32, device=q.device)
    part_m = torch.empty((b * hkv, n_parts, rep), **f32)
    part_l = torch.empty((b * hkv, n_parts, rep), **f32)
    part_acc = torch.empty((b * hkv, n_parts, rep, hd), **f32)
    out = torch.empty((b, hq, hd), dtype=k_cache.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _build.load("decode_attention", _SIGNATURES).decode_attention_fwd(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
            _DTYPE_CODE[k_cache.dtype], int(q.dtype != k_cache.dtype), b, hq, hkv, hd,
            q.stride(0), q.stride(1), *k_cache.stride()[:3], *v_cache.stride()[:3],
            lo, hi, per, n_parts,
            0.0 if softcap is None else float(softcap), softmax_scale(hd),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel failed: CUDA error {rc}")
    launches += 1
    return out
