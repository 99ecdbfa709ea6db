#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives HAPI's forward pushdown path as a storage tier serving requests:
builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all at once), holds each kernel against its plain PyTorch
version on the card, checks that a full-width two-block mistral-nemo-12b
gives the same loss on the card (kernels) and on the CPU (plain versions),
then answers three requests with the full 40-block mistral-nemo-12b in bf16:
the storage tier runs the 30-block prefix over COS-batch microbatches and
int8-quantizes the boundary, the wire bytes are counted, and the compute
tier dequantizes and evaluates the 10-block suffix's loss without
gradients. Weights are random, from a seeded ``torch.Generator``.

Exits non-zero on any failure, and without a GPU. Its last lines are the
card's name and power limit, one JSON line with every kernel's numbers, and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.config import HW, HapiConfig, ShapeConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tier_split import (  # noqa: E402
    make_extract_fn, make_tune_loss_fn, plan_tiers, wire_bytes)
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.int8_transfer import (  # noqa: E402
    dequantize_int8_cuda, quantize_int8_cuda)
from repro_torch.models.api import build_model  # noqa: E402

ARCH = "mistral-nemo-12b"
BF16_TOL = 2e-2          # tests/test_kernels.py's bf16 tolerance
F32_TOL = 2e-5           # tests/test_kernels.py's f32 tolerance
LOSS_TOL = 2e-2          # card vs CPU loss of the 2-block model, bf16 end to end
N_REQUESTS = 3
WIRE_BYTES = 83_886_080 + 2_621_440   # int8 codes + f32 scales of (4, 4096, 5120)
KERNELS = {
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:128"),
    "quantize_int8": ("src/repro_torch/csrc/int8_transfer.cu",
                      "src/repro/kernels/int8_transfer.py:52"),
    "dequantize_int8": ("src/repro_torch/csrc/int8_transfer.cu",
                        "src/repro/kernels/int8_transfer.py:86"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops_done: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = bytes_moved / HW.hbm_bandwidth
    t_ops = ops_done / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def live_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs the mask leaves live: the work a flash kernel needs."""
    q = np.arange(s)
    lo = np.maximum(q - window, 0) if window is not None else np.zeros(s, np.int64)
    hi = q if causal else np.full(s, s - 1)
    return int((hi - lo + 1).sum())


def randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda", dtype=torch.float32).to(dtype)


# ---------------------------------------------------------------------------
# Phase 1: environment
# ---------------------------------------------------------------------------
def environment() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"python {platform.python_version()} torch {torch.__version__} "
        f"cuda {torch.version.cuda} devices {torch.cuda.device_count()}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------
def check_int8() -> dict:
    for shape in [(2, 4096, 5120), (3, 1001, 5120), (7, 333, 80), (5, 97), (1, 1, 5120)]:
        for dt in (torch.bfloat16, torch.float32):
            x = randn(shape, dt, seed=shape[-1]) * 3
            q, s = quantize_int8_cuda(x)
            qe, se = ref.quantize_int8(x)
            check(torch.equal(q, qe) and torch.equal(s, se),
                  f"quantize_int8 not bit-exact at {shape} {dt}")
            for out_dt in (torch.bfloat16, torch.float32):
                check(torch.equal(dequantize_int8_cuda(q, s, out_dt),
                                  ref.dequantize_int8(qe, se, out_dt)),
                      f"dequantize_int8 not exact at {shape} {dt}->{out_dt}")
    log("int8: q, scales and dequantize bit-exact with the plain versions "
        "(D=5120 and D=80/tile 16 and D=97/tile 1, ragged rows, bf16 and f32)")

    # Times at the path's shapes: the storage tier quantizes one (2, 4096, 5120)
    # bf16 microbatch, the compute tier dequantizes (4, 4096, 5120) into bf16.
    x = randn((2, 4096, 5120), torch.bfloat16, seed=1) * 3
    q, s = quantize_int8_cuda(x)
    n = x.numel()
    qb, qby = bound(n * (2 + 1) + s.numel() * 4, 5 * n, HW.peak_flops_f32)
    quant = dict(max_abs_err=float((q.int() - ref.quantize_int8(x)[0].int()).abs().max()),
                 ms=time_ms(lambda: quantize_int8_cuda(x), 50),
                 plain_ms=time_ms(lambda: ref.quantize_int8(x), 10),
                 bound_ms=qb, bound_by=qby, library_ms=None)
    q4 = torch.cat([q, q])
    s4 = torch.cat([s, s])
    n4 = q4.numel()
    db, dby = bound(n4 * (1 + 2) + s4.numel() * 4, n4, HW.peak_flops_f32)
    got, exp = dequantize_int8_cuda(q4, s4), ref.dequantize_int8(q4, s4)
    dequant = dict(max_abs_err=float((got.float() - exp.float()).abs().max()),
                   ms=time_ms(lambda: dequantize_int8_cuda(q4, s4), 50),
                   plain_ms=time_ms(lambda: ref.dequantize_int8(q4, s4), 10),
                   bound_ms=db, bound_by=dby, library_ms=None)
    for name, r in (("quantize_int8 (8192 x 5120 bf16)", quant),
                    ("dequantize_int8 (16384 x 5120 -> bf16)", dequant)):
        log(f"{name}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return {"quantize_int8": quant, "dequantize_int8": dequant}


FLASH_CASES = [
    # b, s, h, hkv, hd, causal, window, softcap, dtype, tol
    (2, 4096, 32, 8, 128, True, None, None, torch.bfloat16, BF16_TOL),   # the path's shape
    (1, 4096, 16, 8, 256, True, 1024, 50.0, torch.bfloat16, BF16_TOL),   # gemma2 local
    (1, 2048, 16, 8, 256, True, None, 50.0, torch.bfloat16, BF16_TOL),   # gemma2 global
    (2, 1000, 8, 8, 128, False, None, None, torch.bfloat16, BF16_TOL),   # bidirectional
    (1, 777, 8, 2, 64, False, 100, None, torch.bfloat16, BF16_TOL),      # future keys admitted
    (2, 300, 4, 2, 64, True, None, None, torch.float32, F32_TOL),
    (1, 200, 4, 1, 128, True, 50, 30.0, torch.float32, F32_TOL),
    (1, 129, 2, 2, 256, False, None, None, torch.float32, F32_TOL),
    (1, 100, 4, 4, 64, False, 10, None, torch.float32, F32_TOL),
]


def check_flash() -> dict:
    main = None
    for b, s, h, hkv, hd, causal, window, cap, dt, tol in FLASH_CASES:
        q = randn((b, s, h, hd), dt, seed=1)
        k = randn((b, s, hkv, hd), dt, seed=2)
        v = randn((b, s, hkv, hd), dt, seed=3)
        out = flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=cap)
        kr, vr = ops.repeat_kv(k, h // hkv), ops.repeat_kv(v, h // hkv)
        exp = ref.flash_attention(q, kr, vr, causal=causal, window=window, softcap=cap)
        err = float((out.float() - exp.float()).abs().max())
        torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
        log(f"flash B={b} S={s} H={h} Hkv={hkv} hd={hd} causal={causal} window={window} "
            f"softcap={cap} {str(dt)[6:]}: max abs err {err:.3g} (tol {tol:g})")
        if main is None:
            pairs = live_pairs(s, causal, window)
            fb, fby = bound((2 * b * s * h * hd + 2 * b * s * hkv * hd) * q.element_size(),
                            4 * hd * b * h * pairs, HW.peak_flops_bf16)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            main = dict(
                max_abs_err=err,
                ms=time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal), 10),
                plain_ms=time_ms(lambda: ref.flash_attention(q, kr, vr, causal=causal), 3, 1),
                bound_ms=fb, bound_by=fby,
                library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                                   10))
            log(f"flash_attention (2 x 4096, 32/8 heads, hd 128, causal, bf16): "
                f"{main['ms']:.4f} ms, plain {main['plain_ms']:.4f} ms, "
                f"bound {main['bound_ms']:.4f} ms ({fby}), "
                f"scaled_dot_product_attention {main['library_ms']:.4f} ms")
        del q, k, v, out, exp, kr, vr
        torch.cuda.empty_cache()
    return {"flash_attention": main}


# ---------------------------------------------------------------------------
# Phase 4: full-width agreement, card (kernels) vs CPU (plain versions)
# ---------------------------------------------------------------------------
def check_full_width() -> None:
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    shape = ShapeConfig("agree", "train", seq_len=512, global_batch=2)
    plan = plan_tiers(cfg, shape, HapiConfig(compress_transfer=True, cos_batch=2,
                                             cos_batch_min=1))
    check(plan.split == 1, f"2-block plan split {plan.split}")
    lm_gpu = build_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(1))
    lm_cpu = copy.deepcopy(lm_gpu).cpu()
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 512))
    extract, tune = make_extract_fn(plan), make_tune_loss_fn(plan)
    losses, acts = {}, {}
    for dev, lm in (("cuda", lm_gpu), ("cpu", lm_cpu)):
        t = torch.from_numpy(toks).to(dev)
        batch = {"tokens": t, "labels": t}
        frozen, trainable = lm.split_params(plan.split)
        t0 = time.perf_counter()
        with torch.no_grad():
            wire = extract(frozen, batch)
            acts[dev] = ops.dequantize_int8(*wire).float().cpu()
            losses[dev] = float(tune(trainable, wire, batch))
        log(f"full width, 2 blocks, batch 2 x 512 on {dev}: loss {losses[dev]:.6f} "
            f"({time.perf_counter() - t0:.1f} s)")
    diff = abs(losses["cuda"] - losses["cpu"])
    act_err = float((acts["cuda"] - acts["cpu"]).abs().max())
    log(f"full width agreement: |loss card - loss cpu| = {diff:.3g} (tol {LOSS_TOL:g}); "
        f"boundary max abs err {act_err:.3g}")
    check(math.isfinite(losses["cuda"]) and diff <= LOSS_TOL, "card and CPU losses disagree")
    del lm_gpu, lm_cpu
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 5: the slice
# ---------------------------------------------------------------------------
def serve_slice() -> dict:
    cfg = get_config(ARCH)
    shape = ShapeConfig("slice", "train", seq_len=4096, global_batch=4)
    plan = plan_tiers(cfg, shape, HapiConfig(compress_transfer=True, cos_batch=2,
                                             cos_batch_min=1))
    log(f"plan: split {plan.split} of {cfg.n_blocks} blocks, cos_batch {plan.cos_batch}, "
        f"compress {plan.compress}; {plan.decision.reason}")
    check((plan.split, plan.cos_batch, plan.compress) == (30, 2, True), "unexpected plan")
    t0 = time.perf_counter()
    lm = build_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    log(f"{ARCH}: {n_params} parameters in bf16, initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    frozen, trainable = lm.split_params(plan.split)
    extract, tune = make_extract_fn(plan), make_tune_loss_fn(plan)
    per_request = {"flash_attention": plan.split * (4 // plan.cos_batch)
                   + cfg.n_blocks - plan.split, "quantize_int8": 4 // plan.cos_batch,
                   "dequantize_int8": 1}
    check(per_request == {"flash_attention": 70, "quantize_int8": 2, "dequantize_int8": 1},
          f"unexpected launches per request {per_request}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for r in range(N_REQUESTS):
        toks = torch.from_numpy(
            np.random.default_rng(100 + r).integers(0, cfg.vocab_size, (4, 4096))).cuda()
        batch = {"tokens": toks, "labels": toks}
        before = ops.launch_counts()
        t0 = time.perf_counter()
        acts = extract(frozen, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with torch.no_grad():
            loss = float(tune(trainable, acts, batch))
        t2 = time.perf_counter()
        rose = {k: v - before[k] for k, v in ops.launch_counts().items()}
        wire = wire_bytes(acts)
        log(f"request {r}: extract {1e3 * (t1 - t0):.1f} ms, tune {1e3 * (t2 - t1):.1f} ms, "
            f"wire {wire} bytes, loss {loss:.6f}, launches {rose}")
        check(acts[0].shape == (4, 4096, cfg.d_model) and acts[1].shape == (4, 4096, 40),
              "boundary shapes")
        check(wire == WIRE_BYTES, f"wire bytes {wire} != {WIRE_BYTES}")
        check(math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 3.0,
              f"loss {loss} is not near ln(vocab)")
        check(rose == per_request, f"launches rose by {rose}, expected {per_request}")
    log(f"peak device memory {torch.cuda.max_memory_allocated()} bytes")
    return ops.launch_counts()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    smi = environment()
    log(f"build: {_build.build():.1f} s ({', '.join(_build.SOURCES)})")
    kernels = {**check_flash(), **check_int8()}
    check_full_width()
    launches = serve_slice()
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    line = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": launches[name], **kernels[name]}
            for name, (src, rep) in KERNELS.items()]
    log(smi)
    log(json.dumps({"kernels": line}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
