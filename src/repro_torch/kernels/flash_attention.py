"""Flash attention: the wrappers of the forward and backward CUDA kernels.

Counterpart of ``repro/kernels/flash_attention.py``. The kernel is in
``csrc/flash_attention.cu``: online softmax over the KV tiles that the
causal and window masks leave live, f32 m/l/acc, an optional tanh softcap.
Its route is fixed by (dtype, head dim) before any launch (``fwd_route``):
bf16 runs on ``wgmma`` with TMA loads and a producer warpgroup feeding two
consumer warpgroups (``tile_config`` gives its tiles) at head dims 64, 128
and 256 (a TMA box is 64 values wide), and at latent attention's Q.K head
dim 192 with a V head dim of 128 (``SPLIT_HEAD_DIMS``; V and the output at
128, the scale 1/sqrt(192)); f32 at head dims 64 and 128 (the
paper's ViT) on the tensor cores in split TF32, each f32 operand as a
TF32 hi and lo and each product hi.hi + hi.lo + lo.hi on ``mma.sync``;
f32 at 16, 32 (the smoke configs') and 256 on an FMA kernel. The kernel
reports the route it launched, and ``fwd_routes`` counts launches by that
route (``fwd_shapes`` by shape, ``bwd_shapes`` the backward's by shape).
No route falls back to another: a kernel that fails to build or launch
raises. It keeps the public ``(B, S, H, hd)`` layout and takes K and V
with ``H`` heads or with ``Hkv`` heads where ``Hkv`` divides ``H``; query
head ``h`` then reads KV head ``h // (H // Hkv)``, the order of
``layers._repeat_kv``. q, k and v may be strided views (of a fused QKV
tensor, say) as long as the last stride is 1 and rows are 16-byte aligned,
which is what TMA and 16-byte loads need.

Given ``lse=True`` the forward also returns each row's log-sum-exp in base
2, ``(B, H, S)`` f32. ``flash_attention_bwd_cuda`` wraps the backward kernel
of ``csrc/flash_attention_bwd.cu`` (which the TPU package does not have: XLA
differentiates its attention): a pre-pass for D = rowsum(dO * O), then a
dK/dV kernel and a dQ kernel, each the owner of its output, so calls are
bit-equal. Its route is fixed by (dtype, head dim) before any launch
(``bwd_tile_config``): bf16 at head dims 64 and 128 on ``wgmma`` with TMA
tiles in a ring, bf16 at 256 and at (192, 128) on ``mma.sync``, f32 on the
CUDA cores.
``FlashAttentionFn`` joins the two under autograd, saving q, k, v, the
output and the log-sum-exp; on CPU tensors it runs the plain versions in
``ref``. ``flash_attention_cuda`` itself still
raises on an input that requires grad where autograd is on, rather than
return a result that autograd cannot differentiate.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref
from repro_torch.kernels import work

HEAD_DIMS = (64, 128, 256)              # the bf16 kernel's
F32_HEAD_DIMS = (16, 32, 64, 128, 256)  # the f32 kernel's
# (Q.K head dim, V head dim) pairs whose dims differ, in bf16: latent
# attention's (DeepSeek-V3's MLA, Moonlight's).
SPLIT_HEAD_DIMS = ((192, 128),)
_SIGNATURES = {
    "flash_attention_fwd": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p],
        ctypes.c_int),
    "flash_attention_fwd_dv": (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
           ctypes.POINTER(ctypes.c_int), ctypes.c_void_p],
        ctypes.c_int),
    "flash_attention_tile": ([ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4,
                             ctypes.c_int),
    "flash_attention_tile_dv": ([ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 4,
                                ctypes.c_int),
    "flash_attention_fwd_route": ([ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 5,
                                  ctypes.c_int),
    "flash_attention_tf32_launch": ([ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2,
                                    ctypes.c_int),
}
_BWD_SIGNATURES = {
    "flash_attention_bwd": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "flash_attention_bwd_dv": (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
    "flash_attention_bwd_tile": ([ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                                 ctypes.c_int),
    "flash_attention_bwd_tile_dv": ([ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)],
                                    ctypes.c_int),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 kernel's tiles, as csrc/flash_attention.cu's Layout sets them.
BLOCK_M = 128            # query rows a block owns, 64 per consumer warpgroup
WGMMA_THREADS = 384      # a producer warpgroup and two consumer warpgroups
STAGES = 2               # depth of the K/V ring
TMA_BOX = 64             # bf16 values in a TMA box's inner extent: 128 bytes, one swizzle row
SMEM_LIMIT = 232_448     # dynamic shared memory a block may use on an H100
N_BARRIERS = 3 + 3 * STAGES   # Q full; K full, V full, empty per stage; two turns

# The forward's routes, as csrc/flash_attention.cu's flash_attention_fwd_route
# numbers them: 0 the FMA kernel, 1 split TF32 on mma.sync, 2 wgmma.
FWD_ROUTES = ("fma", "3xtf32", "wgmma")
TF32_HEAD_DIMS = (64, 128)
TF32_TILE = 2048         # values of a K or V tile: 32 keys at hd 64, 16 at hd 128
TF32_STAGES = 2          # split K and V tiles in the producer's ring
TF32_STRIPS = {64: 2, 128: 1}       # 16-row query strips a warp
TF32_MAX_WARPS = {64: 7, 128: 7}    # consumer warps a block, beside one producer warp

# The backward's routes and tiles, as csrc/flash_attention_bwd.cu sets them.
BWD_ROUTES = ("fma", "mma", "wgmma")   # the C side's route codes 0, 1, 2
BWD_WGMMA_HEAD_DIMS = (64, 128)        # bf16 on wgmma; bf16 at 256 on mma.sync
BWD_BLOCK = 128          # keys a dK/dV block owns, query rows a dQ block owns: 64 a consumer
BWD_TILE = 64            # queries of a dK/dV tile, keys of a dQ tile
BWD_STAGES = 2           # depth of both rings
BWD_THREADS = 384        # a producer warpgroup and two consumer warpgroups
F32_TILE = 32            # the FMA route's tiles, 128 threads

launches = 0
bwd_launches = 0
fwd_routes = dict.fromkeys(FWD_ROUTES, 0)   # forward launches by the route the kernel took
# Forward and backward launches by (B, S, H, Hkv, hd, causal); hd is the pair
# (Q.K head dim, V head dim) where the two differ.
fwd_shapes: Counter = Counter()
bwd_shapes: Counter = Counter()


def shape_key(b: int, s: int, h: int, hkv: int, hd: int, hdv: int, causal) -> tuple:
    """A launch's key in ``fwd_shapes`` and ``bwd_shapes``."""
    return (b, s, h, hkv, hd if hdv == hd else (hd, hdv), bool(causal))


def tile_config(hd: int, hdv: Optional[int] = None) -> tuple:
    """(BM, BN, stages, shared bytes) of the bf16 kernel at Q.K head dim
    ``hd`` and V head dim ``hdv`` (by default ``hd``): Q once, then ``stages``
    K and V tiles of BN keys, the mbarriers, and 1 KB to align the buffers to
    the swizzle's period."""
    hdv = hd if hdv is None else hdv
    if hd not in HEAD_DIMS and (hd, hdv) not in SPLIT_HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if hdv != hd and (hd, hdv) not in SPLIT_HEAD_DIMS:
        raise ValueError(f"(head_dim, v_head_dim) ({hd}, {hdv}) not in {SPLIT_HEAD_DIMS}")
    bn = 64 if hd == 256 else 128
    smem = 2 * hd * BLOCK_M + 2 * STAGES * bn * (hd + hdv) + 8 * N_BARRIERS + 1024
    return BLOCK_M, bn, STAGES, smem


def fwd_route(hd: int, dtype: torch.dtype, hdv: Optional[int] = None) -> tuple:
    """The forward's route at head dim ``hd`` in ``dtype``, fixed before any
    launch, and its largest block: (route, query rows, keys a KV tile,
    threads, dynamic shared bytes). "wgmma" for bf16 (``tile_config``);
    "3xtf32" for f32 at head dims 64 and 128 (``TF32_MAX_WARPS`` consumer
    warps of ``TF32_STRIPS`` strips of 16 rows and a producer warp; Q hi and
    lo, a ring of ``TF32_STAGES`` tiles of ``TF32_TILE`` values of K hi and
    lo and V^T hi and lo, a full and an empty mbarrier a stage); "fma" for
    f32 at 16, 32 and 256 (32 x 32 tiles, 128 threads: Q, K with a padded
    row, V, P). A V head dim ``hdv`` of its own: "wgmma" at
    ``SPLIT_HEAD_DIMS``."""
    if hdv is not None and hdv != hd:
        if dtype != torch.bfloat16 or (hd, hdv) not in SPLIT_HEAD_DIMS:
            raise ValueError(f"the flash forward takes (head_dim, v_head_dim) "
                             f"{SPLIT_HEAD_DIMS} in bfloat16, not ({hd}, {hdv}) in {dtype}")
        bm, bn, _, smem = tile_config(hd, hdv)
        return "wgmma", bm, bn, WGMMA_THREADS, smem
    if dtype == torch.bfloat16 and hd in HEAD_DIMS:
        bm, bn, _, smem = tile_config(hd)
        return "wgmma", bm, bn, WGMMA_THREADS, smem
    if dtype == torch.float32 and hd in TF32_HEAD_DIMS:
        w = TF32_MAX_WARPS[hd]
        bm = 16 * TF32_STRIPS[hd] * w
        smem = 4 * (2 * bm * hd + 4 * TF32_STAGES * TF32_TILE) + 16 * TF32_STAGES
        return "3xtf32", bm, TF32_TILE // hd, 32 * (w + 1), smem
    if dtype == torch.float32 and hd in F32_HEAD_DIMS:
        t = F32_TILE
        return "fma", t, t, 128, (2 * t * (hd + 1) + t * hd + t * (t + 1)) * 4
    raise ValueError(f"the flash forward takes head_dim {HEAD_DIMS} in bfloat16 and "
                     f"{F32_HEAD_DIMS} in float32, not {hd} in {dtype}")


def bwd_tile_config(hd: int, dtype: torch.dtype, hdv: Optional[int] = None) -> tuple:
    """The backward's route at head dim ``hd`` in ``dtype`` and its two
    kernels' tiles: (route, dK/dV, dQ), each kernel's (keys or query rows a
    block owns, rows of a tile it walks, stages of its buffer, threads,
    dynamic shared bytes). The route is "wgmma" for bf16 at head dims 64 and
    128: the dK/dV kernel keeps K and V of ``BWD_BLOCK`` keys and a ring of Q,
    dO, LSE and D tiles of ``BWD_TILE`` queries, the dQ kernel Q and dO of
    ``BWD_BLOCK`` rows and a ring of K and V tiles of ``BWD_TILE`` keys,
    both 1 KB-aligned for the swizzle, and the mbarriers. "mma" for bf16 at
    256 (mma.sync; rows padded by 16 bytes, two buffers; two warps share 16
    keys of dK and dV), and at ``SPLIT_HEAD_DIMS`` with a V head dim ``hdv``
    of its own (the wgmma route's dK and dV accumulators would not fit in a
    consumer's registers). "fma" for float32."""
    if hdv is not None and hdv != hd:
        if dtype != torch.bfloat16 or (hd, hdv) not in SPLIT_HEAD_DIMS:
            raise ValueError(f"the flash backward takes (head_dim, v_head_dim) "
                             f"{SPLIT_HEAD_DIMS} in bfloat16, not ({hd}, {hdv}) in {dtype}")
        pk, pv = hd * 2 + 16, hdv * 2 + 16
        return ("mma", (64, 32, 2, 256, 64 * (pk + pv) + 2 * 32 * (pk + pv) + 4 * 32 * 4),
                (64, 32, 2, 128, 64 * (pk + pv) + 2 * 32 * (pk + pv)))
    if dtype == torch.bfloat16 and hd in BWD_WGMMA_HEAD_DIMS:
        bars = 8 * (1 + 2 * BWD_STAGES) + 1024
        ring = BWD_STAGES * 2 * BWD_TILE * hd * 2
        dkdv = 2 * BWD_BLOCK * hd * 2 + ring + BWD_STAGES * 2 * BWD_TILE * 4 + bars
        dq = 2 * BWD_BLOCK * hd * 2 + ring + bars
        return ("wgmma", (BWD_BLOCK, BWD_TILE, BWD_STAGES, BWD_THREADS, dkdv),
                (BWD_BLOCK, BWD_TILE, BWD_STAGES, BWD_THREADS, dq))
    if dtype == torch.bfloat16 and hd in HEAD_DIMS:
        pitch = hd * 2 + 16
        return ("mma", (64, 32, 2, 256, (2 * 64 + 4 * 32) * pitch + 4 * 32 * 4),
                (64, 32, 2, 128, (2 * 64 + 4 * 32) * pitch))
    if dtype == torch.float32 and hd in F32_HEAD_DIMS:
        t = F32_TILE
        smem = (4 * t * (hd + 1) + 2 * t * (t + 1) + 2 * t) * 4
        return ("fma", (t, t, 1, 128, smem), (t, t, 1, 128, smem))
    raise ValueError(f"the flash backward takes head_dim {HEAD_DIMS} in bfloat16 and "
                     f"{F32_HEAD_DIMS} in float32, not {hd} in {dtype}")


@functools.lru_cache(maxsize=None)
def softmax_scale(hd: int) -> float:
    """1 / sqrt(hd) computed in f32, as the reference computes it."""
    return float(1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int],
           softcap: Optional[float]) -> None:
    """The checks both kernels share: shapes, heads, dtype, head dims, mask."""
    b, s, h, hd = q.shape
    if k.dim() != 4 or v.dim() != 4 or k.shape[:3] != v.shape[:3] or k.shape[0] != b \
            or k.shape[1] != s or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    hkv = k.shape[2]
    if hkv == 0 or h % hkv:
        raise ValueError(f"{hkv} KV heads do not divide {h} query heads")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    hdv = v.shape[3]
    if hdv != hd:
        if q.dtype != torch.bfloat16 or (hd, hdv) not in SPLIT_HEAD_DIMS:
            raise ValueError(f"(head_dim, v_head_dim) ({hd}, {hdv}) not in "
                             f"{SPLIT_HEAD_DIMS} for {q.dtype}")
    else:
        dims = F32_HEAD_DIMS if q.dtype == torch.float32 else HEAD_DIMS
        if hd not in dims:
            raise ValueError(f"head_dim {hd} not in {dims} for {q.dtype}")
    if window is not None and window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def _launch(fn, q: torch.Tensor, args: tuple) -> int:
    if q.device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(q.device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         softcap: Optional[float] = None, lse: bool = False):
    """The output (B, S, H, hdv) in q's dtype (hdv v's head dim), and with
    ``lse`` also the base-2 log-sum-exp (B, H, S) f32."""
    global launches
    _check(q, k, v, window, softcap)
    b, s, h, hd = q.shape
    hkv, hdv = k.shape[2], v.shape[3]
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{name} requires grad, and flash_attention_cuda records no "
                               "graph: FlashAttentionFn (ops.flash_attention) pairs it with "
                               "the backward kernel")
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"{name} needs a unit last stride and 16-byte aligned rows")
    out = torch.empty((b, s, h, hdv), dtype=q.dtype, device=q.device)
    lse_t = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if lse else None
    if out.numel() == 0:
        return (out, lse_t) if lse else out
    route = ctypes.c_int(-1)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse_t.data_ptr() if lse else None,
            _DTYPE_CODE[q.dtype], b, s, h, hkv, hd, hdv,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap), softmax_scale(hd), ctypes.byref(route))
    rc = _launch(_build.load("flash_attention", _SIGNATURES).flash_attention_fwd_dv, q, args)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel failed: CUDA error {rc}")
    launches += 1
    work.tally("flash_attention", work.flash_work(b, s, h, hkv, hd, causal, window,
                                                   q.element_size(), hdv))
    fwd_routes[FWD_ROUTES[route.value]] += 1
    fwd_shapes[shape_key(b, s, h, hkv, hd, hdv, causal)] += 1
    return (out, lse_t) if lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, window: Optional[int] = None,
                             softcap: Optional[float] = None):
    """(dq, dk, dv) of the forward that gave ``out`` and ``lse`` from q, k,
    v with the same mask; dk and dv have k's Hkv heads, each the sum over its
    group of query heads. Views are made contiguous: the kernel reads packed
    tensors."""
    global bwd_launches
    _check(q, k, v, window, softcap)
    b, s, h, hd = q.shape
    hkv, hdv = k.shape[2], v.shape[3]
    if out.shape != (b, s, h, hdv) or dout.shape != out.shape or lse.shape != (b, h, s):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)} do not match q {tuple(q.shape)}")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"out and dout must have q's dtype {q.dtype} and lse float32, got "
                        f"{out.dtype}, {dout.dtype}, {lse.dtype}")
    for name, t in zip(("q", "k", "v", "out", "dout", "lse"), (q, k, v, out, dout, lse)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
    # Packed, and 16-byte aligned for the wgmma route's TMA: a packed view
    # that starts off 16 bytes is copied.
    tensors = [t.contiguous() for t in (q, k, v, out, dout, lse)]
    tensors = [t if t.data_ptr() % 16 == 0 else t.clone() for t in tensors]
    dq = torch.empty((b, s, h, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hkv, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, s, hkv, hdv), dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk, dv
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    args = (*(t.data_ptr() for t in tensors), dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _DTYPE_CODE[q.dtype], b, s, h, hkv, hd, hdv, int(causal),
            -1 if window is None else int(window), 0.0 if softcap is None else float(softcap),
            softmax_scale(hd))
    rc = _launch(_build.load("flash_attention_bwd", _BWD_SIGNATURES).flash_attention_bwd_dv,
                 q, args)
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel failed: CUDA error {rc}")
    bwd_launches += 1
    work.tally("flash_attention_bwd", work.flash_bwd_work(b, s, h, hkv, hd, causal, window,
                                                           q.element_size(), hdv))
    bwd_shapes[shape_key(b, s, h, hkv, hd, hdv, causal)] += 1
    return dq, dk, dv


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None, lse: bool = False):
    """What ``flash_attention_cuda`` returns, on meta tensors: outputs of
    the right shape, and the kernel's work recorded (``kernels/work.py``);
    nothing is launched or computed."""
    b, s, h, hd = q.shape
    if k.shape[:3] != v.shape[:3] or k.shape[:2] != (b, s) or k.shape[3] != hd \
            or h % k.shape[2]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    hdv = v.shape[3]
    work.tally("flash_attention", work.flash_work(b, s, h, k.shape[2], hd, causal, window,
                                                   q.element_size(), hdv))
    out = torch.empty((b, s, h, hdv), dtype=q.dtype, device=q.device)
    if not lse:
        return out
    return out, torch.empty((b, h, s), dtype=torch.float32, device=q.device)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention under autograd: the forward kernel, which also writes
    the log-sum-exp, then the backward kernel. Remat reruns ``forward``, which
    recomputes the log-sum-exp with the output. CPU tensors take the plain
    versions (``ref.flash_attention_lse``, ``ref.flash_attention_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        if q.is_meta:
            out, lse = flash_attention_meta(q, k, v, causal=causal, window=window, lse=True)
        elif q.is_cuda:
            out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                            softcap=softcap, lse=True)
        else:
            rep = q.shape[2] // k.shape[2]
            out, lse = ref.flash_attention_lse(q, k.repeat_interleave(rep, dim=2),
                                               v.repeat_interleave(rep, dim=2), causal=causal,
                                               window=window, softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        if q.is_meta:
            b, s, h, hd = q.shape
            work.tally("flash_attention_bwd", work.flash_bwd_work(
                b, s, h, k.shape[2], hd, causal, window, q.element_size(), v.shape[3]))
            grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
        elif q.is_cuda:
            grads = flash_attention_bwd_cuda(q, k, v, out, lse, dout, causal=causal,
                                             window=window, softcap=softcap)
        else:
            grads = ref.flash_attention_bwd(q, k, v, dout, causal=causal, window=window,
                                            softcap=softcap)
        return (*grads, None, None, None)
