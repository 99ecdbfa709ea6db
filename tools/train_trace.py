#!/usr/bin/env python3
"""Where a Hapi train step spends its time on one NVIDIA GPU.

    python3 tools/train_trace.py [--arch mistral-nemo-12b] [--layers 8] [--batch 4] [--seq 4096]
    python3 tools/train_trace.py --arch mamba2-1.3b --layers 48

Builds ``--arch`` (mistral-nemo-12b or mamba2-1.3b) at its published widths,
cut to ``--layers`` blocks (bf16, seeded random weights), plans the tier
split as ``chip_smoke.py``'s training phases do (int8 boundary, COS batch 2,
microbatch 2), and runs ``build_hapi_train_step`` on one repeated batch: the
first step, timed on the host clock around work that ends in
``torch.cuda.synchronize()``, then three warm steps with the program's
tracer on (``repro_torch.obs.program``), whose span summary it prints: per
span the median host, stream and self ms a step. One more warm step runs
traced under ``torch.profiler``: the sum of its kernels' device times (the
device's busy time; one stream, so kernels do not overlap), the idle share
of that step's wall time, the idle seconds by the innermost
``repro_torch.*`` range open at each gap's midpoint, and the kernel time by
name, largest first, grouped into f32 matmuls (the head), bf16 matmuls,
the port's own kernels and the rest, and each of the port's kernels apart.
Prints the card's name and power limit and one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT / "src"))

from prefill_trace import kernel_times  # noqa: E402
from repro_torch.config import HapiConfig, RunConfig, ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.tier_split import plan_tiers  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.obs import program as obs  # noqa: E402
from repro_torch.train.steps import build_hapi_train_step, init_train_state  # noqa: E402

# Kernel names of the port's own CUDA kernels, as the profiler reports them
# (a name matches where it contains one of these).
PORT_KERNELS = ("flash_fwd", "bwd_dkdv", "bwd_dq", "bwd_dsum", "dequantize", "quantize",
                "ssd_scan_mma", "ssd_scan_kernel", "ssd_bwd_kernel", "ssd_bwd_reduce",
                "ssd_bwd_dchunk", "ssd_bwd_pass", "ssd_bwd_main", "ssd_bwd_state", "ssd_bwd_dbdc",
                "ssd_bwd_ddta")


def port_kernel(name: str):
    """The PORT_KERNELS entry ``name`` contains, or None."""
    return next((k for k in PORT_KERNELS if k in name), None)


def group(name: str) -> str:
    """cuBLAS's f32 GEMMs (no TF32) run on FMA, as SIMT "sgemm" or
    "gemm_f32f32" kernels; its bf16 GEMMs are "nvjet" or "bf16" ones."""
    if port_kernel(name):
        return "port kernels"
    low = name.lower()
    if "sgemm" in low or "gemm_f32" in low:
        return "f32 matmuls"
    if "gemm" in low or "nvjet" in low:
        return "bf16 matmuls"
    return "elementwise, reductions, copies"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mistral-nemo-12b",
                    choices=("mistral-nemo-12b", "mamba2-1.3b"))
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=4096)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_trace: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    shape = ShapeConfig("train", "train", args.seq, args.batch)
    hapi = HapiConfig(compress_transfer=True, cos_batch=2, cos_batch_min=1)
    rc = RunConfig(model=cfg, shape=shape, hapi=hapi,
                   train=TrainConfig(microbatch=2, learning_rate=1e-4, warmup_steps=1,
                                     total_steps=10))
    plan = plan_tiers(cfg, shape, hapi)
    model = build_model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    state = init_train_state(model, rc, plan)
    step = build_hapi_train_step(model, rc, plan)
    toks = torch.from_numpy(
        np.random.default_rng(200).integers(0, cfg.vocab_size, (args.batch, args.seq))).cuda()
    batch = {"tokens": toks, "labels": toks}

    def timed():
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    ops.reset_launch_counts()
    cold = timed()
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    with obs.tracing():
        for _ in range(3):
            timed()
        spans = obs.summary()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, \
            obs.tracing():
        traced = timed()
    device, host = obs.profiler_events(prof)
    (s0, s1), = [(a, b) for n, a, b in host if n == obs.RANGE_PREFIX + "train.step"]
    gaps = obs.idle_gaps(device, host, (s0, max([s1] + [b for _, _, b in device])))
    # The spans' ranges show on the device's timeline too: not kernels.
    kernels = {k: ms for k, ms in kernel_times(prof).items()
               if not k.startswith(obs.RANGE_PREFIX)}
    busy = sum(kernels.values())
    groups: dict = {}
    port: dict = {}
    for name, ms in kernels.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
        if port_kernel(name):
            port[port_kernel(name)] = port.get(port_kernel(name), 0.0) + ms
    top = dict(list(kernels.items())[:15])
    row = {"arch": args.arch, "layers": args.layers, "split": plan.split, "batch": args.batch,
           "seq": args.seq,
           "cold_ms": cold, "spans": spans, "traced_ms": traced, "device_busy_ms": busy,
           "idle_share": 1 - busy / traced if busy else None, "idle_s_by_span": gaps,
           "groups_ms": groups, "port_kernels_ms": port, "launches_per_step": launches,
           "top_kernels_ms": top}
    print(f"train step, {args.arch} at {args.layers} blocks (split {plan.split}), "
          f"{args.batch} x {args.seq}: cold {cold:.1f} ms, traced {traced:.1f} ms; device busy "
          f"{busy:.1f} ms (idle share {row['idle_share']}); launches {launches}")
    print(f"the program's spans over 3 warm steps, medians a step:\n{obs.format_summary(spans)}")
    print(f"idle s of the traced step by the innermost span: {gaps}")
    for name, ms in groups.items():
        print(f"  {ms:9.3f} ms  [{name}]")
    for name, ms in port.items():
        print(f"  {ms:9.3f} ms  [{name}] {100 * ms / busy:.1f}% of the device time")
    for name, ms in top.items():
        print(f"  {ms:9.3f} ms  {name[:110]}")
    print(smi)
    print(json.dumps({"card": smi, "train_trace": row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
