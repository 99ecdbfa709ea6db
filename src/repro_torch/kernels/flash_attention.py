"""Forward flash attention: the wrapper of the CUDA kernel.

Counterpart of ``repro/kernels/flash_attention.py``. The kernel is in
``csrc/flash_attention.cu``: online softmax over the KV tiles that the
causal and window masks leave live, f32 m/l/acc, an optional tanh softcap,
``mma.sync`` for bf16 and FMA for f32. It keeps the public
``(B, S, H, hd)`` layout and takes K and V with ``H`` heads or with ``Hkv``
heads where ``Hkv`` divides ``H``; query head ``h`` then reads KV head
``h // (H // Hkv)``, the order of ``layers._repeat_kv``.

Forward only: where autograd is on, the wrapper raises on an input that
requires grad rather than hide the kernel behind a differentiable fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128, 256)
_SIGNATURES = {
    "flash_attention_fwd": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


@functools.lru_cache(maxsize=None)
def softmax_scale(hd: int) -> float:
    """1 / sqrt(hd) computed in f32, as the reference computes it."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    global launches
    b, s, h, hd = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b or k.shape[1] != s \
            or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    hkv = k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{hkv} KV heads do not divide {h} query heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError("the flash attention kernel has no backward; "
                               f"{name} requires grad")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"{name} needs a unit last stride and 16-byte aligned rows")
    out = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        rc = _build.load("flash_attention", _SIGNATURES).flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, s, h, hkv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), softmax_scale(hd),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel failed: CUDA error {rc}")
    launches += 1
    return out
