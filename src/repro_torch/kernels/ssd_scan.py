"""Mamba2 SSD chunked scan: the wrapper of the CUDA kernel.

Counterpart of ``repro/kernels/ssd_scan.py``. The kernel is in
``csrc/ssd_scan.cu``: one block per (batch, head) walks the chunks in order
with the (N, P) f32 state in shared memory, query rows in tiles of 64, only
the lower triangle of each chunk's decay matrix computed. It owns a zero
initial state, as the Pallas kernel does, and writes y in f32, as the model's
``ssm.ssd_chunked`` returns it (the Pallas kernel writes y in x's type).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

MAX_STATE = 128       # N
MAX_HEAD_DIM = 64     # P
_SIGNATURES = {
    "ssd_scan_fwd": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
                     ctypes.c_int),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def ssd_scan_cuda(x: torch.Tensor, dtA: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                  C_: torch.Tensor, *, chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P); dtA, dt (B, S, H); B_, C_ (B, S, N). Returns y (B, S, H, P)
    and the final state (B, H, N, P), both f32, from a zero initial state."""
    global launches
    b, s, h, p = x.shape
    n = B_.shape[-1]
    if dtA.shape != (b, s, h) or dt.shape != (b, s, h) or B_.shape != (b, s, n) \
            or C_.shape != (b, s, n):
        raise ValueError(f"shapes x {tuple(x.shape)}, dtA {tuple(dtA.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(B_.shape)}, C {tuple(C_.shape)} "
                         "do not match")
    q = min(chunk, s)
    if q <= 0 or s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    if not (0 < n <= MAX_STATE and n % 4 == 0 and 0 < p <= MAX_HEAD_DIM and p % 4 == 0):
        raise ValueError(f"state {n} and head dim {p} must be multiples of 4, at most "
                         f"{MAX_STATE} and {MAX_HEAD_DIM}")
    if x.dtype not in _DTYPE_CODE or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise TypeError(f"x, B and C must share float32 or bfloat16, got {x.dtype}, "
                        f"{B_.dtype}, {C_.dtype}")
    for name, t in (("x", x), ("dtA", dtA), ("dt", dt), ("B", B_), ("C", C_)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"the SSD kernel has no backward; {name} requires grad")
    x, B_, C_ = x.contiguous(), B_.contiguous(), C_.contiguous()
    dtA = dtA.to(torch.float32).contiguous()
    dt = dt.to(torch.float32).contiguous()
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y, state.zero_()
    with torch.cuda.device(x.device):
        rc = _build.load("ssd_scan", _SIGNATURES).ssd_scan_fwd(
            x.data_ptr(), dtA.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), state.data_ptr(), _DTYPE_CODE[x.dtype], b, s, h, n, p, q,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel failed: CUDA error {rc}")
    launches += 1
    return y, state
