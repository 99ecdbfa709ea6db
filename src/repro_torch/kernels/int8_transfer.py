"""Int8 split-activation compression: wrappers of the CUDA kernels.

Counterpart of ``repro/kernels/int8_transfer.py``. The kernels are in
``csrc/int8_transfer.cu``: per row and per ``gcd(D, 128)``-lane tile,
``scale = max(amax, 1e-8) / 127`` in f32 and
``q = clip(round(x / scale), -127, 127)``, bit-exact with
``ref.quantize_int8``; dequantize is ``q * scale`` in f32, rounded to the
requested dtype. Each wrapper takes CUDA tensors only (``ops`` sends CPU
tensors to the plain versions) and counts its launches. Quantize has two
hand-written routes, chosen before the launch from shape and alignment
alone (``quantize_route``): the vector route (16-byte loads, several chunks
in flight a warp) where x is 16-byte aligned and a tile holds at least 16
bytes, else the scalar route (a warp per tile); ``quantize_routes`` counts
the launches of each.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, work

_SIGNATURES = {
    "quantize_int8": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
    "dequantize_int8": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p], ctypes.c_int),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

quantize_launches = 0
dequantize_launches = 0
quantize_routes = {"vector": 0, "scalar": 0}


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _call(fn: str, what: str, *args) -> None:
    rc = getattr(_build.load("int8_transfer", _SIGNATURES), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel failed ({what}): CUDA error {rc}")


def quantize_route(x: torch.Tensor, tile: int) -> str:
    """"vector" where x's data is 16-byte aligned and a tile of ``tile``
    elements holds at least 16 bytes (so each lane's 16-byte load lies in
    one tile), else "scalar"."""
    aligned = x.data_ptr() % 16 == 0
    return "vector" if aligned and tile * x.element_size() >= 16 else "scalar"


def quantize_int8_cuda(x: torch.Tensor, tile: int = 128):
    """(q int8 (..., D), scales f32 (..., D/tile)) with tile = gcd(D, tile)."""
    global quantize_launches
    _check_cuda("x", x)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_int8 takes float32 or bfloat16, got {x.dtype}")
    *lead, d = x.shape
    tile = math.gcd(d, tile)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*lead, d // tile), dtype=torch.float32, device=x.device)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return q, s
    route = quantize_route(x, tile)
    with torch.cuda.device(x.device):
        _call("quantize_int8", f"{x.dtype}, {route} route, tile {tile}", x.data_ptr(),
              q.data_ptr(), s.data_ptr(), rows, d, tile, _DTYPE_CODE[x.dtype],
              int(route == "vector"), torch.cuda.current_stream().cuda_stream)
    quantize_launches += 1
    work.tally("quantize_int8", work.quantize_work(x.numel(), x.element_size(), s.numel()))
    quantize_routes[route] += 1
    return q, s


def dequantize_int8_cuda(q: torch.Tensor, scales: torch.Tensor,
                         dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    global dequantize_launches
    _check_cuda("q", q)
    _check_cuda("scales", scales)
    if scales.device != q.device:
        raise ValueError(f"q on {q.device} and scales on {scales.device}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequantize_int8 takes int8 codes and float32 scales, "
                        f"got {q.dtype} and {scales.dtype}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"dequantize_int8 writes float32 or bfloat16, got {dtype}")
    *lead, d = q.shape
    n_tiles = scales.shape[-1]
    if tuple(scales.shape[:-1]) != tuple(lead) or n_tiles == 0 or d % n_tiles:
        raise ValueError(f"scales {tuple(scales.shape)} do not tile q {tuple(q.shape)}")
    tile = d // n_tiles
    if tile & (tile - 1):
        raise ValueError(f"tile {tile} is not a power of two")
    out = torch.empty(q.shape, dtype=dtype, device=q.device)
    if q.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        _call("dequantize_int8", f"int8 to {dtype}, tile {tile}", q.data_ptr(),
              scales.data_ptr(), out.data_ptr(),
              q.numel(), tile.bit_length() - 1, _DTYPE_CODE[dtype],
              torch.cuda.current_stream().cuda_stream)
    dequantize_launches += 1
    work.tally("dequantize_int8", work.dequantize_work(q.numel(), out.element_size(),
                                                        scales.numel()))
    return out
