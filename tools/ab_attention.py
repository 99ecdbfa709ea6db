#!/usr/bin/env python3
"""Time the port's attention kernels against the versions they replaced.

    git archive 3ef8eae src/repro_torch/csrc | tar -x -C build/parent
    python3 tools/ab_attention.py build/parent/src/repro_torch/csrc

Builds the flash-attention and decode-attention sources of commit 3ef8eae
(flash on ``mma.sync``; decode in two launches) from the given directory into
``build/ab_attention/``, and times them against the current kernels on one
NVIDIA GPU in turns (old, new, new, old), each the device time of one call
from CUDA-graph replay, at the shapes of the port's main paths: flash causal
with 32/8 heads of 128 at B 2 x 4,096 (pushdown prefix), B 4 x 4,096 (suffix)
and B 4 x 512 (serving prefill); decode with 32/8 heads of 128 at B 4 over 544
and 32,768 keys. Also times an eager call of each decode version (host cost
included) and checks that old and new agree. Prints the card's name and power
limit and one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _SIGNATURES as FLASH_SIGNATURES, flash_attention_cuda, softmax_scale)

OUT = ROOT / "build" / "ab_attention"
# The C entry points of commit 3ef8eae: flash has today's signature; decode
# took three scratch pointers (m, l, acc) and the part size and count.
OLD_DECODE = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 8
              + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
              ctypes.c_int)


def build_old(csrc: Path) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}_old.so"),
         str(csrc / f"{name}.cu")]) for name in ("flash_attention", "decode_attention")}
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the old {name}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}_old.so"))
    fn = libs["flash_attention"].flash_attention_fwd
    fn.argtypes, fn.restype = FLASH_SIGNATURES["flash_attention_fwd"]
    fn = libs["decode_attention"].decode_attention_fwd
    fn.argtypes, fn.restype = OLD_DECODE
    return libs


def device_ms(fn, iters: int, replays: int = 3) -> float:
    """Device time of one call: ``iters`` calls in one CUDA graph, replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def eager_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def turns(old, new, iters: int) -> dict:
    """old, new, new, old; the mean of each pair and every reading."""
    a1, b1, b2, a2 = (device_ms(f, iters) for f in (old, new, new, old))
    return {"old_ms": (a1 + a2) / 2, "new_ms": (b1 + b2) / 2, "readings": [a1, b1, b2, a2]}


def randn(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def old_flash(lib, q, k, v):
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1,
                                 b, s, h, k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
                                 *v.stride()[:3], 1, -1, 0.0, softmax_scale(hd),
                                 torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old flash failed: {rc}")
    return out


def old_decode(lib, q, k, v, length):
    """The parent's wrapper: parts of 32 k keys for about 4,096 warps, four
    allocations, the device context, then the two launches."""
    b, hq, hd = q.shape
    hkv = k.shape[2]
    pairs, rep = b * hkv, hq // hkv
    per = 32 * max(1, math.ceil(length / (32 * max(1, math.ceil(4096 / pairs)))))
    n_parts = math.ceil(length / per)
    f32 = dict(dtype=torch.float32, device=q.device)
    pm = torch.empty((pairs, n_parts, rep), **f32)
    pl = torch.empty((pairs, n_parts, rep), **f32)
    pa = torch.empty((pairs, n_parts, rep, hd), **f32)
    out = torch.empty((b, hq, hd), dtype=k.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), pm.data_ptr(),
            pl.data_ptr(), pa.data_ptr(), 1, 0, b, hq, hkv, hd, q.stride(0), q.stride(1),
            *k.stride()[:3], *v.stride()[:3], 0, length, per, n_parts, 0.0, softmax_scale(hd),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old decode failed: {rc}")
    return out


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = build_old(Path(sys.argv[1]))
    _build.build(("flash_attention", "decode_attention"))
    rows = {}
    for name, (b, s) in {"flash 2x4096": (2, 4096), "flash 4x4096": (4, 4096),
                         "flash 4x512": (4, 512)}.items():
        q, k, v = randn((b, s, 32, 128), 1), randn((b, s, 8, 128), 2), randn((b, s, 8, 128), 3)
        diff = float((old_flash(libs["flash_attention"], q, k, v).float()
                      - flash_attention_cuda(q, k, v).float()).abs().max())
        rows[name] = {**turns(lambda: old_flash(libs["flash_attention"], q, k, v),
                              lambda: flash_attention_cuda(q, k, v), 10 if s > 512 else 100),
                      "max_abs_old_vs_new": diff}
        del q, k, v
    for name, s in {"decode 544": 544, "decode 32768": 32768}.items():
        q, k, v = randn((4, 32, 128), 4), randn((4, s, 8, 128), 5), randn((4, s, 8, 128), 6)
        n = 200 if s < 4096 else 50
        old = lambda: old_decode(libs["decode_attention"], q, k, v, s)  # noqa: E731
        new = lambda: decode_attention_cuda(q, k, v, s)  # noqa: E731
        diff = float((old().float() - new().float()).abs().max())
        rows[name] = {**turns(old, new, n), "max_abs_old_vs_new": diff,
                      "eager_old_ms": eager_ms(old, n), "eager_new_ms": eager_ms(new, n)}
        del q, k, v
        torch.cuda.empty_cache()
    for name, r in rows.items():
        print(f"{name}: old {r['old_ms']:.4f} ms, new {r['new_ms']:.4f} ms "
              f"(readings {', '.join(f'{x:.4f}' for x in r['readings'])}), "
              f"max |old - new| {r['max_abs_old_vs_new']:.3g}"
              + (f"; eager old {r['eager_old_ms']:.4f} ms, new {r['eager_new_ms']:.4f} ms"
                 if "eager_old_ms" in r else ""))
    print(smi)
    print(json.dumps({"card": smi, "ab": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
