#!/usr/bin/env python3
"""Where a served model's prefill spends its time on one NVIDIA GPU.

    python3 tools/prefill_trace.py [--arch mamba2-1.3b] [--batch 4] [--prompt 512] [--src DIR]

Builds the full model (bf16, seeded random weights) as
``repro_torch.launch.serve.serve`` does and times its prefill of a batch of
random prompts, host clock around work that ends in
``torch.cuda.synchronize()``: the first call (cold, the number ``serve``
reports as ``prefill_ms``) and five more (warm). One more warm prefill runs
under ``torch.profiler``: the sum of its kernels' device times (the device's
busy time; one stream, so kernels do not overlap), the idle share of the warm
wall time, and the kernel time by name, largest first. ``--src`` takes the
port from another tree's ``src`` (an unpacked ``git archive`` of an earlier
commit), so that two commits can be timed in turns on one card. Prints the
card's name and power limit and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def kernel_times(prof) -> dict:
    """Self device time (ms) by kernel name, over the profiled window."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        kind = str(getattr(e, "device_type", ""))
        if us and "CPU" not in kind:
            out[e.key] = out.get(e.key, 0.0) + us / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.train.steps import build_prefill_step

    if not torch.cuda.is_available():
        print("prefill_trace: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config(args.arch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_model(cfg, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt), generator=gen,
                           device="cuda")
    prefill = build_prefill_step(model)
    batch = {"tokens": tokens}
    ops.reset_launch_counts()
    cold = wall_ms(lambda: prefill(batch))
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    warm = [wall_ms(lambda: prefill(batch)) for _ in range(5)]
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prefill(batch)
        torch.cuda.synchronize()
    kernels = kernel_times(prof)
    busy = sum(kernels.values())
    warm_ms = sorted(warm)[len(warm) // 2]
    top = dict(list(kernels.items())[:12])
    row = {"src": str(args.src), "arch": args.arch, "batch": args.batch, "prompt": args.prompt, "cold_ms": cold,
           "warm_ms": warm, "warm_median_ms": warm_ms, "device_busy_ms": busy,
           "idle_share": 1 - busy / warm_ms if busy else None,
           "launches_per_prefill": launches, "top_kernels_ms": top}
    print(f"{args.arch} prefill {args.batch} x {args.prompt}: cold {cold:.1f} ms, warm "
          f"{', '.join(f'{x:.1f}' for x in warm)} ms; device busy {busy:.1f} ms of the warm "
          f"median {warm_ms:.1f} ms (idle share {row['idle_share']}); launches {launches}")
    for name, ms in top.items():
        print(f"  {ms:9.3f} ms  {name[:110]}")
    print(smi)
    print(json.dumps({"card": smi, "prefill_trace": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
