"""Mamba2 SSD chunked scan: the wrapper of the CUDA kernel.

Counterpart of ``repro/kernels/ssd_scan.py``. The kernel is in
``csrc/ssd_scan.cu``. For bf16 inputs (the model's path) one block of four
warps owns a (batch, head) and a slice of the head's columns and walks the
chunks in order: its four products run on the tensor cores (``mma.sync``),
with the f32 operands (the decay-weighted C.B^T, the state, the scaled x)
split into two bf16 halves, and the state stays in registers across chunks.
``launch_config`` gives that launch. For f32 inputs an FMA kernel takes one
block per (batch, head). Both own a zero initial state, as the Pallas kernel
does, and write y in f32, as the model's ``ssm.ssd_chunked`` returns it (the
Pallas kernel writes y in x's type). The bf16 kernel takes chunks of a
multiple of 16 steps; ``pad_chunks`` pads any other chunk the reference
takes (a prompt shorter than the chunk, or a small chunk) with zero steps,
which leave the state as it is.

Given ``states=True`` the forward also writes the state entering each
chunk, (B, S / chunk, H, N, P) f32. ``ssd_scan_bwd_cuda`` wraps the backward
of ``csrc/ssd_scan_bwd.cu`` (the JAX package has no kernel for it: XLA
differentiates ``ssd_chunked``). For bf16 inputs it runs six launches with
the products on the tensor cores: the chunks' local state gradients, a
reverse pass over the chunks that turns them into the gradient of the state
leaving each chunk, then, chunk-parallel over (chunk, group of heads, key
tile), the main pass (dx, d dt, the heads' M L summed over the group, whose
products with B and C are taken once) and the state terms, then dB and dC,
then d dtA from its cancellation-free form. That route takes chunks of a
multiple of 64 steps up to 256 and pads others with zero steps
(``pad_chunks(..., multiple=BWD_TILE)``). For f32 inputs, and shapes the
tensor-core route does not take, one block per (head, batch row) walks the
chunks from the last on the CUDA cores, then a second kernel sums dB and dC
over the heads. ``bwd_launch_config`` gives a call's launches, all of
them in order. ``SSDScanFn`` joins the two under autograd, saving the
inputs and the states; on CPU tensors it runs the plain versions in
``ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels import work

MAX_STATE = 128       # N
MAX_HEAD_DIM = 64     # P
TILE = 64             # query rows of a tile and keys of a key tile (bf16 kernel)
THREADS = 128         # four warps, 16 query rows each
PBLK = 64             # columns of P a block owns where P allows, else 32 or 16
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on an H100
_SIGNATURES = {
    "ssd_scan_fwd": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
                     ctypes.c_int),
    "ssd_scan_launch": ([ctypes.c_int] * 5 + [ctypes.c_void_p] * 3, ctypes.c_int),
}
_BWD_SIGNATURES = {
    "ssd_scan_bwd": ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
                     ctypes.c_int),
    "ssd_scan_bwd_scratch": ([ctypes.c_int] * 7, ctypes.c_longlong),
    "ssd_scan_bwd_launch": ([ctypes.c_int] * 8 + [ctypes.c_void_p] * 3, ctypes.c_int),
    "ssd_scan_bwd_dstates": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
                             ctypes.c_int),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The backward, as csrc/ssd_scan_bwd.cu sets it.
BWD_THREADS = 256     # the FMA route's gradient kernel (16 x 16) and the tensor-core main kernels
BWD_TILE = 64         # steps of a tile (both routes)
BWD_MAX_TILES = 4     # the tensor-core route's longest chunk: 256 steps
BWD_KERNELS = ("dchunk", "pass", "main", "state", "dbdc", "ddta")   # tensor-core route, in order
BWD_FMA_KERNELS = ("fma", "reduce")                                  # FMA route, in order

launches = 0
bwd_launches = 0


def launch_config(b: int, h: int, p: int, n: int, q: int) -> tuple:
    """((grid x, y, z), threads, dynamic shared bytes) of the bf16 kernel for
    batch ``b``, ``h`` heads of ``p`` columns, state ``n`` and chunk ``q``:
    one block per (column slice, head, batch row). The shared memory holds
    the C tile, two B and two x tiles of ``TILE`` rows padded by 8 values,
    the state's hi and lo bf16 copies, and three f32 values a step of the
    chunk (cum, dt and the state update's factor).
    Raises ValueError on a shape the kernel does not take."""
    if not (0 < n <= MAX_STATE and n % 16 == 0 and 0 < p <= MAX_HEAD_DIM and p % 16 == 0
            and q > 0 and q % 16 == 0):
        raise ValueError(f"the bf16 SSD kernel takes state and head dim multiples of 16, at "
                         f"most {MAX_STATE} and {MAX_HEAD_DIM}, and a chunk that is a multiple "
                         f"of 16; got state {n}, head dim {p}, chunk {q}")
    pblk = next(c for c in (PBLK, 32, 16) if p % c == 0)
    smem = 2 * (3 * TILE * (n + 8) + 2 * TILE * (pblk + 8) + 2 * n * (pblk + 8)) + 12 * q
    if smem > SMEM_LIMIT:
        raise ValueError(f"chunk {q} needs {smem} bytes of shared memory, over {SMEM_LIMIT}")
    return (p // pblk, h, b), THREADS, smem


def heads_per_group(h: int) -> int:
    """Heads of a group in the tensor-core backward: the largest of 8, 4, 2
    and 1 that divides ``h``."""
    return next(g for g in (8, 4, 2, 1) if h % g == 0)


def bwd_route(dtype: torch.dtype, n: int, p: int, q: int) -> str:
    """"mma" (the tensor-core backward, its chunk padded to a multiple of
    ``BWD_TILE``) for bf16 with state and head dim multiples of 16, at most
    ``MAX_STATE`` and ``MAX_HEAD_DIM``, and a padded chunk of at most
    ``BWD_MAX_TILES`` tiles; else "fma" (the CUDA-core kernel)."""
    qp = padded_chunk(q, BWD_TILE) if q > 0 else 0
    if (dtype == torch.bfloat16 and 0 < n <= MAX_STATE and n % 16 == 0
            and 0 < p <= MAX_HEAD_DIM and p % 16 == 0 and 0 < qp <= BWD_MAX_TILES * BWD_TILE):
        return "mma"
    return "fma"


def bwd_launch_config(b: int, h: int, p: int, n: int, q: int, *, s: Optional[int] = None,
                      dtype: torch.dtype = torch.bfloat16) -> dict:
    """The backward's launches for batch ``b``, ``h`` heads of ``p``
    columns, state ``n``, chunk ``q`` and sequence ``s`` (default one chunk)
    in ``dtype``: {kernel name: ((grid x, y, z), threads, dynamic shared
    bytes)}, in launch order. The tensor-core route (``bwd_route``) pads the
    chunk to a multiple of ``BWD_TILE`` (nT tiles) and groups the heads by
    ``heads_per_group``; its main kernel holds, in shared memory, the
    group's G^T tiles (nT x 8 warps x 512 f32), a ring of three dy tiles as
    hi/lo bf16 halves, the diagonal W^T tile, B_J, x_J of two heads and the
    C tiles or dh's halves; the state kernel two stages of x_J and the
    halves of dy_J, h_c and dh, and C_J. The FMA route's
    gradient kernel holds h_c and dh, transposed C, B, dy and x dt tiles,
    three 64 x 65 f32 tiles and six f32 values a step. Raises ValueError on
    a shape neither route takes."""
    s = q if s is None else s
    if not (0 < n <= MAX_STATE and 0 < p <= MAX_HEAD_DIM and q > 0 and b > 0 and h > 0
            and s > 0 and s % q == 0):
        raise ValueError(f"the SSD backward takes a state of at most {MAX_STATE} and a head "
                         f"dim of at most {MAX_HEAD_DIM}; got state {n}, head dim {p}, chunk {q}")
    t = BWD_TILE
    if bwd_route(dtype, n, p, q) == "mma":
        qp = padded_chunk(q, t)
        nc, nt, grp = s // q, qp // t, h // heads_per_group(h)
        main = (nt * 8 * 512 * 4 + 6 * t * (p + 8) * 2 + t * (t + 1) * 4 + 4 * qp * 4
                + 5 * t * 4 + t * (n + 8) * 2 + 2 * t * (p + 8) * 2
                + max(2 * t * (n + 8) * 2, 2 * n * (p + 8) * 2))
        stage = 3 * t * (p + 8) * 2 + 4 * n * (p + 8) * 2 + 2 * qp * 4
        cfg = {
            "dchunk": ((nc, h, b), BWD_THREADS, 2 * t * (n + 8) * 2 + 2 * t * (p + 4) * 4
                       + 2 * t * (p + 8) * 2 + 3 * qp * 4),
            "pass": ((-(-n * p // 4 // BWD_THREADS), h, b), BWD_THREADS, 0),
            "main": ((nc, grp, nt * b), BWD_THREADS, main),
            "state": ((nt, nc, grp * b), BWD_THREADS, 2 * stage + 2 * t * 4 + t * (n + 8) * 2),
            "dbdc": ((nc, nt, b), BWD_THREADS, t * (t + 4) * 4 + t * (n + 8) * 2),
            "ddta": ((nc, h, b), qp, 0),
        }
    else:
        tp = t + 1
        floats = 2 * n * (p + 1) + 2 * n * tp + 2 * p * tp + 3 * t * tp + 6 * q + 16
        cfg = {"fma": ((h, b, 1), BWD_THREADS, 4 * floats),
               "reduce": ((-(-b * s * n // BWD_THREADS), 1, 1), BWD_THREADS, 0)}
    big = {k: v[2] for k, v in cfg.items() if v[2] > SMEM_LIMIT}
    if big:
        raise ValueError(f"chunk {q} needs {big} bytes of shared memory in the SSD backward, "
                         f"over {SMEM_LIMIT}")
    return cfg


def padded_chunk(q: int, multiple: int = 16) -> int:
    """The chunk a kernel runs for a chunk of ``q`` steps: ``q`` rounded up
    to ``multiple`` (16 for the bf16 forward, ``BWD_TILE`` for the
    tensor-core backward)."""
    return multiple * -(-q // multiple)


def _pad_steps(t: torch.Tensor, q: int, qp: int) -> torch.Tensor:
    """``t`` (B, S, ...) with each chunk of ``q`` steps followed by zero
    steps up to ``qp``."""
    b, s = t.shape[:2]
    nc = s // q
    out = t.new_zeros((b, nc, qp, *t.shape[2:]))
    out[:, :, :q] = t.reshape(b, nc, q, *t.shape[2:])
    return out.reshape(b, nc * qp, *t.shape[2:])


def pad_chunks(x: torch.Tensor, dtA: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
               C_: torch.Tensor, q: int, multiple: int = 16
               ) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """The inputs with each chunk of ``q`` steps padded by zero steps to
    ``qp = padded_chunk(q, multiple)``, and ``qp``. A zero step adds
    ``dt x = 0`` to the state and decays it by ``exp(0) = 1``, so it leaves
    the state as it is wherever it sits; the chunked scan at chunk ``qp``
    then gives the real steps' y (``unpad_chunks``) and the same final
    state, and its gradients, cut back the same way, are the real steps'."""
    qp = padded_chunk(q, multiple)
    return tuple(_pad_steps(t, q, qp) for t in (x, dtA, dt, B_, C_)), qp


def unpad_chunks(y: torch.Tensor, q: int, q16: int) -> torch.Tensor:
    """y (B, S / q * q16, ...) of padded chunks back to the real steps."""
    b, sp = y.shape[:2]
    return y.reshape(b, sp // q16, q16, *y.shape[2:])[:, :, :q].reshape(
        b, sp // q16 * q, *y.shape[2:])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernels copy 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x, dtA, dt, B_, C_, chunk: int) -> int:
    """Shapes and dtypes the kernels take; returns the chunk, min(chunk, S)."""
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
    if x.dtype not in _DTYPE_CODE or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise TypeError(f"x, B and C must share float32 or bfloat16, got {x.dtype}, "
                        f"{B_.dtype}, {C_.dtype}")
    return q


def _on_card(x: torch.Tensor, named) -> None:
    for name, t in named:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")


def ssd_scan_cuda(x: torch.Tensor, dtA: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                  C_: torch.Tensor, *, chunk: int = 256, states: bool = False):
    """x (B, S, H, P); dtA, dt (B, S, H); B_, C_ (B, S, N). Returns y (B, S, H, P)
    and the final state (B, H, N, P), both f32, from a zero initial state;
    given ``states=True`` also the state entering each chunk, f32
    (B, S / chunk, H, N, P). The result is not differentiable: autograd
    goes through ``SSDScanFn``."""
    global launches
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = _check(x, dtA, dt, B_, C_, chunk)
    q16 = padded_chunk(q) if x.dtype == torch.bfloat16 else q
    if x.dtype == torch.bfloat16:
        launch_config(b, h, p, n, q16)
    elif not (0 < n <= MAX_STATE and n % 4 == 0 and 0 < p <= MAX_HEAD_DIM and p % 4 == 0):
        raise ValueError(f"state {n} and head dim {p} must be multiples of 4, at most "
                         f"{MAX_STATE} and {MAX_HEAD_DIM}")
    _on_card(x, (("x", x), ("dtA", dtA), ("dt", dt), ("B", B_), ("C", C_)))
    if q16 != q:
        (x, dtA, dt, B_, C_), _ = pad_chunks(x, dtA, dt, B_, C_, q)
    x, B_, C_ = _aligned(x), _aligned(B_), _aligned(C_)
    dtA = dtA.to(torch.float32).contiguous()
    dt = dt.to(torch.float32).contiguous()
    sp = x.shape[1]
    y = torch.empty((b, sp, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    entering = torch.empty((b, s // q, h, n, p), dtype=torch.float32, device=x.device) \
        if states else None
    if y.numel() == 0:
        state.zero_()
        return (y, state, entering.zero_()) if states else (y, state)
    with torch.cuda.device(x.device):
        rc = _build.load("ssd_scan", _SIGNATURES).ssd_scan_fwd(
            x.data_ptr(), dtA.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), state.data_ptr(), entering.data_ptr() if states else None,
            _DTYPE_CODE[x.dtype], b, sp, h, n, p, q16, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel failed: CUDA error {rc}")
    launches += 1
    work.tally("ssd_scan", work.ssd_work(b, s, h, p, n, q, x.element_size()))
    y = y if q16 == q else unpad_chunks(y, q, q16)
    return (y, state, entering) if states else (y, state)


def ssd_scan_bwd_cuda(x: torch.Tensor, dtA: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
                      C_: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
                      dstate: Optional[torch.Tensor] = None, *, chunk: int = 256):
    """(dx, d dtA, d dt, dB, dC) of ``ssd_scan_cuda`` at these inputs, each in
    its input's dtype, from ``states`` (the forward's, (B, S / chunk, H, N,
    P) f32), the gradient ``dy`` of y (f32, taken as it comes) and
    ``dstate`` of the final state (None is zero). The launches of
    ``bwd_launch_config`` (six on the tensor-core route, two on the FMA
    route), counted as one call; their f32 scratch is freed when the call
    returns."""
    global bwd_launches
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = _check(x, dtA, dt, B_, C_, chunk)
    bwd_launch_config(b, h, p, n, q, s=s, dtype=x.dtype)
    if states.shape != (b, s // q, h, n, p) or dy.shape != x.shape \
            or (dstate is not None and dstate.shape != (b, h, n, p)):
        raise ValueError(f"states {tuple(states.shape)}, dy {tuple(dy.shape)}, dstate "
                         f"{None if dstate is None else tuple(dstate.shape)} do not match x "
                         f"{tuple(x.shape)} at chunk {q}")
    named = [("x", x), ("dtA", dtA), ("dt", dt), ("B", B_), ("C", C_), ("states", states),
             ("dy", dy)] + ([("dstate", dstate)] if dstate is not None else [])
    _on_card(x, named)
    qk = padded_chunk(q, BWD_TILE) if bwd_route(x.dtype, n, p, q) == "mma" else q
    dy = dy.to(torch.float32)
    if qk != q:
        (x, dtA, dt, B_, C_), _ = pad_chunks(x, dtA, dt, B_, C_, q, multiple=BWD_TILE)
        dy = _pad_steps(dy, q, qk)
    x, B_, C_ = _aligned(x), _aligned(B_), _aligned(C_)
    dtA32, dt32, states, dy = (_aligned(t.to(torch.float32)) for t in (dtA, dt, states, dy))
    ds = None if dstate is None else _aligned(dstate.to(torch.float32))
    sp = x.shape[1]
    dx = torch.empty_like(x)
    ddtA = torch.empty((b, sp, h), dtype=torch.float32, device=x.device)
    ddt = torch.empty_like(ddtA)
    dB, dC = torch.empty_like(B_), torch.empty_like(C_)
    code = _DTYPE_CODE[x.dtype]
    with torch.cuda.device(x.device):
        lib = _build.load("ssd_scan_bwd", _BWD_SIGNATURES)
        nbytes = lib.ssd_scan_bwd_scratch(code, b, sp, h, n, p, qk)
        if nbytes < 0:
            raise ValueError(f"the SSD backward kernel refuses state {n}, head dim {p}, "
                             f"chunk {qk}")
        scratch = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device)
        rc = lib.ssd_scan_bwd(
            x.data_ptr(), dtA32.data_ptr(), dt32.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            states.data_ptr(), dy.data_ptr(), None if ds is None else ds.data_ptr(),
            dx.data_ptr(), ddtA.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            scratch.data_ptr(), code, b, sp, h, n, p, qk, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel failed: CUDA error {rc}")
    bwd_launches += 1
    work.tally("ssd_scan_bwd", work.ssd_bwd_work(b, s, h, p, n, q, x.element_size()))
    grads = (dx, ddtA.to(dtA.dtype), ddt.to(dt.dtype), dB, dC)
    return tuple(unpad_chunks(g, q, qk) for g in grads) if qk != q else grads


def ssd_bwd_chunk_dstates_cuda(dtA: torch.Tensor, C_: torch.Tensor, dy: torch.Tensor,
                               dstate: Optional[torch.Tensor] = None, *,
                               chunk: int = 256) -> torch.Tensor:
    """The tensor-core backward's first two launches alone: the gradient of
    the state leaving each chunk, (B, S / chunk, H, N, P) f32, as
    ``ref.ssd_bwd_chunk_dstates`` computes it. bf16 ``C_`` (B, S, N), dtA
    (B, S, H), dy (B, S, H, P) f32; for checks of the kernel. Counted as a
    backward call."""
    global bwd_launches
    b, s, h, p = dy.shape
    n = C_.shape[-1]
    q = min(chunk, s)
    if q <= 0 or s % q or dtA.shape != (b, s, h) or C_.shape != (b, s, n) \
            or (dstate is not None and dstate.shape != (b, h, n, p)):
        raise ValueError(f"dtA {tuple(dtA.shape)}, C {tuple(C_.shape)}, dy {tuple(dy.shape)} "
                         f"at chunk {chunk} do not match")
    if bwd_route(C_.dtype, n, p, q) != "mma":
        raise ValueError(f"the tensor-core backward does not take {C_.dtype}, state {n}, "
                         f"head dim {p}, chunk {q}")
    named = [("C", C_), ("dy", dy)] + ([("dstate", dstate)] if dstate is not None else [])
    _on_card(dtA, named)
    qk = padded_chunk(q, BWD_TILE)
    dtA, dy = dtA.to(torch.float32), dy.to(torch.float32)
    if qk != q:
        dtA, C_, dy = (_pad_steps(t, q, qk) for t in (dtA, C_, dy))
    dtA, C_, dy = _aligned(dtA), _aligned(C_), _aligned(dy)
    ds = None if dstate is None else _aligned(dstate.to(torch.float32))
    nc = s // q
    dh = torch.empty((b, nc, h, n, p), dtype=torch.float32, device=dy.device)
    with torch.cuda.device(dy.device):
        lib = _build.load("ssd_scan_bwd", _BWD_SIGNATURES)
        scratch = torch.empty(lib.ssd_scan_bwd_scratch(1, b, dtA.shape[1], h, n, p, qk) // 4,
                              dtype=torch.float32, device=dy.device)
        rc = lib.ssd_scan_bwd_dstates(
            dtA.data_ptr(), C_.data_ptr(), dy.data_ptr(), None if ds is None else ds.data_ptr(),
            dh.data_ptr(), scratch.data_ptr(), b, dtA.shape[1], h, n, p, qk,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan_bwd_dstates kernel failed: CUDA error {rc}")
    bwd_launches += 1
    return dh


def ssd_scan_meta(x: torch.Tensor, B_: torch.Tensor, *, chunk: int = 256,
                  states: bool = False):
    """What ``ssd_scan_cuda`` returns, on meta tensors: outputs of the right
    shape, and the kernel's work recorded (``kernels/work.py``); nothing is
    launched or computed."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    work.tally("ssd_scan", work.ssd_work(b, s, h, p, n, q, x.element_size()))
    f32 = dict(dtype=torch.float32, device=x.device)
    y, state = torch.empty((b, s, h, p), **f32), torch.empty((b, h, n, p), **f32)
    if not states:
        return y, state
    return y, state, torch.empty((b, -(-s // q), h, n, p), **f32)


class SSDScanFn(torch.autograd.Function):
    """The SSD scan under autograd: the forward kernel, which also writes the
    state entering each chunk, then the backward kernel. Remat reruns
    ``forward``, which recomputes the states. CPU tensors take the plain
    versions (``ref.ssd_chunked`` with its states, ``ref.ssd_chunked_bwd``).
    Returns (y, final state); either may go unused (its gradient is then
    zero)."""

    @staticmethod
    def forward(ctx, x, dtA, dt, B_, C_, chunk):
        ctx.set_materialize_grads(False)
        if x.is_meta:
            y, state, states = ssd_scan_meta(x, B_, chunk=chunk, states=True)
        elif x.is_cuda:
            y, state, states = ssd_scan_cuda(x, dtA, dt, B_, C_, chunk=chunk, states=True)
        else:
            y, state, states = ref.ssd_chunked(x, dtA, dt, B_, C_, chunk=chunk, states=True)
        ctx.save_for_backward(x, dtA, dt, B_, C_, states)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dtA, dt, B_, C_, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        if x.is_meta:
            b, s, h, p = x.shape
            work.tally("ssd_scan_bwd", work.ssd_bwd_work(b, s, h, p, B_.shape[-1],
                                                          min(ctx.chunk, s), x.element_size()))
            grads = tuple(torch.empty_like(t) for t in (x, dtA, dt, B_, C_))
        elif x.is_cuda:
            grads = ssd_scan_bwd_cuda(x, dtA, dt, B_, C_, states, dy, dstate, chunk=ctx.chunk)
        else:
            grads = ref.ssd_chunked_bwd(x, dtA, dt, B_, C_, dy, dstate, chunk=ctx.chunk,
                                        states=states)
        return (*grads, None)
