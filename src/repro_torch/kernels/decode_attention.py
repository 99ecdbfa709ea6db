"""GQA decode attention of one token: the wrapper of the CUDA kernel.

Counterpart of ``repro/kernels/decode_attention.py``. The kernel is in
``csrc/decode_attention.cu``: flash-decoding in one launch. ``partition``
cuts the live keys of each (batch, KV head) pair into splits so that the
blocks fill a wave of the SMs; a block streams its split through a ring of
shared-memory stages, and the splits of a pair combine in the same launch.
Splits of up to CLUSTER_KEYS keys form a thread-block cluster and combine
through each other's shared memory; longer ones combine through f32 scratch
and a per-pair counter, which the wrapper allocates once per (device, size
class) and the kernel sets back to 0, so the scratch is ready for the next
call and a CUDA graph may replay the calls (calls that share it run in order
on one stream; a size class first met during capture raises). ``length`` is
a host int, so a decode step never waits on the card to learn it, and it
sizes the grid: only live keys are read. ``window`` admits
``kpos >= length - 1 - window`` (gemma2's local layers); with
``window=None`` the kernel computes the Pallas kernel's function.
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build, work
from repro_torch.kernels.flash_attention import softmax_scale

HEAD_DIMS = (16, 64, 128, 256)          # bf16 caches' (16: the f32 smoke models decode on them)
F32_HEAD_DIMS = (16, 32, 64, 128, 256)  # f32 caches'
GROUP_SIZES = (1, 2, 4, 6, 8)    # query heads per KV head (grok-1's group is 6)
TILE = 64                        # keys in a stage of the kernel's ring (at hd 128, bf16)
MIN_SPLIT_KEYS = 64              # the fewest keys worth a block of their own
MAX_SPLITS = 8                   # a cluster holds 8 blocks at most
CLUSTER_KEYS = 1024              # splits of up to this many keys combine in a cluster
WAVES = 1                        # at most this many blocks per SM
H100_SMS = 132
_SIGNATURES = {
    "decode_attention_fwd": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
        + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int),
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SCRATCH: Dict[tuple, tuple] = {}   # (device, rows class) -> (part_ml, part_acc, counters)

launches = 0
shapes: Counter = Counter()   # launches by (B, cache positions S, Hq, Hkv, hd)


def live_keys(length: int, window: Optional[int]) -> tuple:
    """The live key range [lo, hi) of a cache filled to ``length``."""
    lo = 0 if window is None else max(0, length - 1 - window)
    return lo, length


def partition(n_keys: int, pairs: int, sms: int = H100_SMS) -> tuple:
    """(keys_per_split, n_splits) for ``n_keys`` live keys in each of
    ``pairs`` (batch, KV head) pairs: the smallest whole number of stages
    per split, at least MIN_SPLIT_KEYS keys, that keeps the grid within
    WAVES blocks per SM and a pair within MAX_SPLITS blocks. One split where
    the pairs fill the SMs already."""
    max_splits = min(MAX_SPLITS, WAVES * sms // pairs)
    if pairs >= sms or n_keys <= MIN_SPLIT_KEYS:
        return n_keys, 1
    per = max(MIN_SPLIT_KEYS, TILE * math.ceil(n_keys / (TILE * max_splits)))
    while math.ceil(n_keys / per) > max_splits:
        per += TILE
    return per, math.ceil(n_keys / per)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _scratch(device: torch.device, rows: int) -> tuple:
    """Partials for ``rows`` (pair, split, query head) rows and counters for
    as many pairs, from the cache; a new size class is allocated with its
    counters at 0."""
    cls = 1 << max(0, rows - 1).bit_length()
    key = (device.index, cls)
    buf = _SCRATCH.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode attention met a new scratch size during CUDA-graph "
                               "capture; call it once at this shape before capturing")
        f32 = dict(dtype=torch.float32, device=device)
        buf = (torch.empty((cls, 2), **f32), torch.empty((cls, max(F32_HEAD_DIMS)), **f32),
               torch.zeros(cls, dtype=torch.int32, device=device))
        _SCRATCH[key] = buf
    return buf


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
    if k_cache.dtype not in _DTYPE_CODE or v_cache.dtype != k_cache.dtype \
            or q.dtype not in (k_cache.dtype, torch.float32):
        raise TypeError(f"the caches must share float32 or bfloat16 and q their dtype "
                        f"or float32, got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    dims = F32_HEAD_DIMS if k_cache.dtype == torch.float32 else HEAD_DIMS
    if hd not in dims:
        raise ValueError(f"head_dim {hd} not in {dims} for {k_cache.dtype} caches")
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
    per, n_splits = partition(hi - lo, b * hkv, _sm_count(q.device.index))
    out = torch.empty((b, hq, hd), dtype=k_cache.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scratch = (None, None, None)
    if n_splits > 1 and per > CLUSTER_KEYS:
        scratch = tuple(t.data_ptr() for t in _scratch(q.device, b * hq * n_splits))
    args = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(), *scratch,
            _DTYPE_CODE[k_cache.dtype], int(q.dtype != k_cache.dtype), b, hq, hkv, hd,
            q.stride(0), q.stride(1), *k_cache.stride()[:3], *v_cache.stride()[:3],
            lo, hi, per, n_splits,
            0.0 if softcap is None else float(softcap), softmax_scale(hd))
    fwd = _build.load("decode_attention", _SIGNATURES).decode_attention_fwd
    if q.device.index == torch.cuda.current_device():
        rc = fwd(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(q.device):
            rc = fwd(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel failed: CUDA error {rc}")
    launches += 1
    work.tally("decode_attention", work.decode_work(b, hq, hkv, hd, hi - lo,
                                                     k_cache.element_size()))
    shapes[(b, s, hq, hkv, hd)] += 1
    return out
