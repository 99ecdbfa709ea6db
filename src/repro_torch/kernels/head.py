"""The LM head's product on the tensor cores: bf16 operands, f32 sums.

Counterpart of the head's einsum in ``repro/models/transformer.py``
(``_head``): ``logits = h @ w^T`` of bf16 operands with
``preferred_element_type=float32``, products exact and summed in f32.
``head_route`` chooses by what the operands show:

- "split_bf16": plain CUDA tensors, both bf16. ``HeadProductFn``: the
  forward is one cuBLAS product of the bf16 operands with f32 output; the
  backward walks the vocabulary in chunks of the f32 gradient G of the
  logits, writes each chunk as three bf16 terms (``split3_bf16_cuda``,
  ``csrc/head_split.cu``: g1 + g2 + g3 == G exactly for |G| >= 2^-110) and
  sums the exact products of the terms in f32: ``dW[chunk] = sum_i g_i^T h``
  (cast to W's dtype once the chunk's sum is whole), ``dH += sum_i g_i
  W[chunk]`` (cast to h's dtype at the end). Only the bf16 ``h`` and ``w``
  are saved; no f32 copy of either is made.
- "f32": everything else (the CPU, f32 or f16 operands, DTensors, meta
  tensors). ``models.transformer._head`` casts both operands to f32 there,
  as it always did; the CPU tests hold that path to the JAX package.

``HeadProductFn`` takes its products as ``Products``: ``CARD`` on the card,
``PLAIN`` (``a.float() @ b.float()`` and the plain split) for the CPU tests
of the route's chunking. The split kernel counts its launches in
``split_launches`` (``split_launch_count``), apart from
``ops.launch_counts()``, whose keys the benchmark and the card tests hold to
the launches worked out for each path.
"""
from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _build, ref, work

_SIGNATURES = {
    "split3_bf16": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                     ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}

#: Bytes of the three bf16 terms of one chunk of the gradient.
SPLIT_BUDGET = 256 << 20
#: Relative L2 within which the route's f32 sums (logits, dH, dW) lie of
#: the f64 sums of the same exact products at the train paths' head shapes.
F32_SUM_TOL = 3e-5

split_launches = 0
split_routes = {"vector": 0, "scalar": 0}


def split_launch_count() -> int:
    """Launches of the split kernel since the process started."""
    return split_launches


def split_route(g: torch.Tensor, out: torch.Tensor) -> str:
    """"vector" where a row of g holds a multiple of 8 values, its stride is
    a multiple of 4 and both pointers are 16-byte aligned, else "scalar"."""
    aligned = g.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    return "vector" if aligned and g.shape[1] % 8 == 0 and g.stride(0) % 4 == 0 else "scalar"


def split3_bf16_cuda(g: torch.Tensor) -> torch.Tensor:
    """(3, M, N) bf16 terms of the f32 (M, N) ``g`` (unit column stride,
    any row stride): ``g1 = bf16(g)``, ``g2 = bf16(g - g1)``,
    ``g3 = bf16(g - g1 - g2)``, bit-equal to ``ref.split3_bf16``."""
    global split_launches
    if not g.is_cuda or g.dtype != torch.float32 or g.dim() != 2:
        raise ValueError(f"split3_bf16 takes a 2-d float32 CUDA tensor, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    if g.stride(1) != 1:
        raise ValueError(f"split3_bf16 needs unit column stride, got strides {g.stride()}")
    rows, cols = g.shape
    out = torch.empty((3, rows, cols), dtype=torch.bfloat16, device=g.device)
    if g.numel() == 0:
        return out
    route = split_route(g, out)
    with torch.cuda.device(g.device):
        rc = _build.load("head_split", _SIGNATURES).split3_bf16(
            g.data_ptr(), out.data_ptr(), rows, cols, g.stride(0), int(route == "vector"),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"split3_bf16 kernel failed ({route} route, {rows} x {cols}, "
                           f"stride {g.stride(0)}): CUDA error {rc}")
    split_launches += 1
    split_routes[route] += 1
    work.tally("split3_bf16", work.split3_work(g.numel()))
    return out


class Products(NamedTuple):
    """The three operations of the route: ``mm(a, b)`` a product of bf16
    operands as f32, ``addmm_(acc, a, b)`` adds one to the f32 ``acc``,
    ``split(g)`` the (3, M, N) bf16 terms of an f32 ``g``."""
    mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    addmm_: Callable[[torch.Tensor, torch.Tensor, torch.Tensor], None]
    split: Callable[[torch.Tensor], torch.Tensor]


def _mm_card(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mm(a, b, out_dtype=torch.float32)


def _addmm_card(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    # cuBLAS adds the product into acc (beta 1): acc read and written once.
    torch.addmm(acc, a, b, out_dtype=torch.float32, out=acc)


def _mm_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a.float() @ b.float()


def _addmm_plain(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    acc.addmm_(a.float(), b.float())


CARD = Products(_mm_card, _addmm_card, split3_bf16_cuda)
PLAIN = Products(_mm_plain, _addmm_plain, ref.split3_bf16)


def head_route(h: torch.Tensor, w: torch.Tensor) -> str:
    """"split_bf16" for plain CUDA tensors that are both bf16, else "f32"."""
    if isinstance(h, DTensor) or isinstance(w, DTensor):
        return "f32"
    on_card = h.is_cuda and w.is_cuda
    return "split_bf16" if on_card and h.dtype == w.dtype == torch.bfloat16 else "f32"


def chunk_cols(rows: int, total: int) -> int:
    """Columns of one chunk of a (rows, total) gradient: the fewest chunks
    whose three bf16 terms fit ``SPLIT_BUDGET`` at a multiple of 64 columns
    (at least 64), then the columns spread evenly over them, rounded up to
    a multiple of 64; ``total`` where one chunk takes it all."""
    most = max(64, SPLIT_BUDGET // (3 * 2 * max(rows, 1)) // 64 * 64)
    n = -(-total // most)
    return min(total, -(-total // (n * 64)) * 64)


def head_grads(g: torch.Tensor, h: torch.Tensor, w: torch.Tensor, products: Products,
               want_h: bool = True, want_w: bool = True, dw_dtype: torch.dtype = None):
    """(dH f32, dW in ``dw_dtype``, W's by default) of ``logits = h @ w^T``
    for the f32 gradient ``g`` (M, V) of the logits: over chunks of
    ``chunk_cols`` columns, g's three bf16 terms, ``dW[chunk] = sum_i
    g_i^T h`` summed in f32 and then cast, ``dH += sum_i g_i W[chunk]`` in
    f32. None for a gradient not wanted."""
    if g.stride(-1) != 1:
        g = g.contiguous()
    rows, total = g.shape
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device) if want_h else None
    dw = torch.empty(w.shape, dtype=dw_dtype or w.dtype, device=w.device) if want_w else None
    step = chunk_cols(rows, total)
    for lo in range(0, total, step):
        hi = min(lo + step, total)
        terms = products.split(g[:, lo:hi])
        if want_w:
            acc = products.mm(terms[0].t(), h)
            products.addmm_(acc, terms[1].t(), h)
            products.addmm_(acc, terms[2].t(), h)
            dw[lo:hi] = acc
        if want_h:
            for t in terms:
                products.addmm_(dh, t, w[lo:hi])
        del terms       # freed before the next chunk's terms are made
    return dh, dw


class HeadProductFn(torch.autograd.Function):
    """``logits = h @ w^T`` in f32 for bf16 ``h`` (M, D) and ``w`` (V, D);
    the backward is ``head_grads``, dH cast to h's dtype."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, w: torch.Tensor, products: Products) -> torch.Tensor:
        ctx.save_for_backward(h, w)
        ctx.products = products
        return products.mm(h, w.t())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        h, w = ctx.saved_tensors
        want_h, want_w = ctx.needs_input_grad[:2]
        dh, dw = head_grads(g, h, w, ctx.products, want_h, want_w)
        return (dh.to(h.dtype) if want_h else None), dw, None
