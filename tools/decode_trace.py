#!/usr/bin/env python3
"""Where a served model's decode step spends its time on one NVIDIA GPU.

    python3 tools/decode_trace.py [--arch moonshot-v1-16b-a3b] [--layers N] [--batch 4]
                                  [--pos 512] [--steps 8]

Builds the model at full width (bf16, seeded random weights) as
``repro_torch.launch.serve.serve`` does, ``--layers`` cutting its depth, and
runs decode steps of a batch of one token each at positions ``--pos`` on,
against a cache of ``pos + steps`` positions: each step's wall time (host
clock around a step that ends in ``torch.cuda.synchronize()``) and the
host's time to issue it (the same clock, stopped when the step returns,
before the synchronise). Then ``--steps`` more steps under
``torch.profiler``: the sum of their kernels' device times a step (one
stream, so kernels do not overlap), the idle share of the wall time, and
the kernel time a step by name, largest first. Prints the card's name and
power limit and one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from prefill_trace import kernel_times  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="moonshot-v1-16b-a3b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--pos", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.train.steps import build_decode_step

    if not torch.cuda.is_available():
        print("decode_trace: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config(args.arch)
    cfg = dataclasses.replace(cfg, n_layers=args.layers or cfg.n_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = build_model(cfg, device="cuda", generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (args.batch, 1), generator=gen, device="cuda")
    step = build_decode_step(model)
    n = args.steps
    cache = model.init_cache(args.batch, args.pos + 3 * n)
    walls, issues = [], []
    for i in range(2 * n):   # the first n warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, cache = step(cache, tok, args.pos + i)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= n:
            walls.append(1e3 * (t2 - t0))
            issues.append(1e3 * (t1 - t0))
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            _, cache = step(cache, tok, args.pos + 2 * n + i)
        torch.cuda.synchronize()
    traced_ms = 1e3 * (time.perf_counter() - t0) / n
    kernels = {k: v / n for k, v in kernel_times(prof).items()}
    busy = sum(kernels.values())
    wall = sorted(walls)[len(walls) // 2]
    top = dict(list(kernels.items())[:12])
    row = {"arch": args.arch, "blocks": cfg.n_blocks, "batch": args.batch, "pos": args.pos,
           "step_wall_ms": walls, "step_issue_ms": issues, "step_wall_median_ms": wall,
           "device_busy_ms_per_step": busy, "idle_share": 1 - busy / wall if busy else None,
           "traced_ms_per_step": traced_ms, "top_kernels_ms_per_step": top}
    print(f"{args.arch} ({cfg.n_blocks} blocks) decode step, batch {args.batch} at position "
          f"{args.pos}: wall {', '.join(f'{x:.2f}' for x in walls)} ms; host issues a step in "
          f"{', '.join(f'{x:.2f}' for x in issues)} ms; device busy {busy:.2f} ms a step of the "
          f"median {wall:.2f} ms (idle share {row['idle_share']})")
    for name, ms in top.items():
        print(f"  {ms:9.3f} ms  {name[:110]}")
    print(smi)
    print(json.dumps({"card": smi, "decode_trace": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
