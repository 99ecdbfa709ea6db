"""Forward flash attention: the wrapper of the CUDA kernel.

Counterpart of ``repro/kernels/flash_attention.py``. The kernel is in
``csrc/flash_attention.cu``: online softmax over the KV tiles that the
causal and window masks leave live, f32 m/l/acc, an optional tanh softcap.
bf16 runs on ``wgmma`` with TMA loads and a producer warpgroup feeding two
consumer warpgroups (``tile_config`` gives its tiles) at head dims 64, 128
and 256 (a TMA box is 64 values wide); f32 takes an FMA path, also at head
dims 16 and 32 (the smoke configs'). It keeps the public ``(B, S, H, hd)``
layout and takes K and V with ``H`` heads or with ``Hkv`` heads where
``Hkv`` divides ``H``; query head
``h`` then reads KV head ``h // (H // Hkv)``, the order of
``layers._repeat_kv``. q, k and v may be strided views (of a fused QKV
tensor, say) as long as the last stride is 1 and rows are 16-byte aligned,
which is what TMA needs.

Forward only: where autograd is on, the wrapper raises on an input that
requires grad rather than hide the kernel behind a differentiable fallback.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (64, 128, 256)              # the bf16 kernel's
F32_HEAD_DIMS = (16, 32, 64, 128, 256)  # the f32 kernel's
_SIGNATURES = {
    "flash_attention_fwd": (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "flash_attention_tile": ([ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4,
                             ctypes.c_int),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 kernel's tiles, as csrc/flash_attention.cu's Layout sets them.
BLOCK_M = 128            # query rows a block owns, 64 per consumer warpgroup
STAGES = 2               # depth of the K/V ring
TMA_BOX = 64             # bf16 values in a TMA box's inner extent: 128 bytes, one swizzle row
SMEM_LIMIT = 232_448     # dynamic shared memory a block may use on an H100
N_BARRIERS = 3 + 3 * STAGES   # Q full; K full, V full, empty per stage; two turns

launches = 0


def tile_config(hd: int) -> tuple:
    """(BM, BN, stages, shared bytes) of the bf16 kernel at head dim ``hd``:
    Q once, then ``stages`` K and V tiles of BN keys, the mbarriers, and 1 KB
    to align the buffers to the swizzle's period."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    bn = 64 if hd == 256 else 128
    smem = 2 * hd * (BLOCK_M + 2 * STAGES * bn) + 8 * N_BARRIERS + 1024
    return BLOCK_M, bn, STAGES, smem


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
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    dims = F32_HEAD_DIMS if q.dtype == torch.float32 else HEAD_DIMS
    if hd not in dims:
        raise ValueError(f"head_dim {hd} not in {dims} for {q.dtype}")
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
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[q.dtype], b, s, h, hkv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), softmax_scale(hd))
    fwd = _build.load("flash_attention", _SIGNATURES).flash_attention_fwd
    if q.device.index == torch.cuda.current_device():
        rc = fwd(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            rc = fwd(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel failed: CUDA error {rc}")
    launches += 1
    return out
