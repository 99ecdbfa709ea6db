#!/usr/bin/env python3
"""The benchmark of ``repro_torch`` on one NVIDIA H100: one run of one cell.

    python3 hapibench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration and a traffic mix. A run loads the port's kernel
libraries (built under ``build/repro_torch_kernels/`` by the first run in a
checkout), makes the weights on the card from ``--seed``, plans, warms the
cell's own shapes, then measures for ``--seconds``, closed loop: each step
or POST is issued when the last one returns. A fine-tune cell's set-up runs
its first steps through the window's own call and feed; the plain reference
follows them after the window. A pushdown cell keeps a sample of the
window's POSTs, drawn from the seed, for the reference.

``setup_s`` runs from the process's start to the window's, less the
seconds the kernels took to build (the first run in a checkout builds them).
With ``--trace 0`` the last line of standard output holds the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, from a window
whose spans are synchronised, then more steps or POSTs under
``torch.profiler`` with the spans' ranges and no synchronise. The numbers that decide ``correct`` come last on that
line and on standard error, each beside its limit. A run without a card,
or that finds JAX or the JAX package loaded, prints no result and exits
non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from hapibench import bench, check, kinds  # noqa: E402
from hapibench.runtime import log  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Top-level names, among ``names`` (the loaded modules by default),
    that the run must not hold, compared whole (``repro_torch`` is not
    ``repro``)."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def run_cell(c: bench.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             fault=None, t_start: float = None) -> dict:
    """One run of cell ``c``: its result line as a dict (the driver's keys,
    then ``checks``)."""
    from hapibench import program as P
    t_start = time.perf_counter() if t_start is None else t_start
    built_s = 0.0
    if torch.device(device).type == "cuda":
        log(f"run started at {time.perf_counter() - t_start} s")
        built_s = P.build_kernels(c.config)
        log(f"kernel libraries built in {built_s} s, which setup_s leaves out")
    readings, e2e, numbers, peak, count = kinds.of(c.traffic).run(
        c, seed, seconds, trace, device, fault, t_start)
    # The first run in a checkout compiles the kernels: set-up is the rest.
    e2e["setup_s"] -= built_s
    log(f"setup_s {e2e['setup_s']} s")
    metrics = c.per_layer if trace else c.end_to_end
    if trace:
        shown = bench.read_all(metrics, readings)
    else:
        shown = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in metrics}
    correct, checks = check.verdict(numbers, c.limits["limits"])
    dev = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device) if torch.device(device).type == "cuda"
                    else "cpu"),
           "count": c.chips, "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": count, "failed": 0, "metrics": shown,
            "device": dev}
    if trace and readings.trace is not None:
        dev["busy_s"], dev["window_s"] = readings.trace.busy_s, readings.trace.window_s
        line["breakdown"] = {"device_ops": readings.trace.device_ops,
                             "idle_gaps": readings.trace.idle_gaps}
    line["checks"] = checks
    return line


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"hapibench: {args.workload} needs {c.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    # Build and kernel caches at fixed paths inside the checkout.
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    line = run_cell(c, args.seed, args.seconds, bool(args.trace), "cuda", t_start=T_START)
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    found = forbidden_modules()
    if found:
        print(f"hapibench: the run loaded {found}, which it must not", file=sys.stderr)
        return 3
    for name, v in line["checks"].items():
        print(f"check {name}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
