#!/usr/bin/env python3
"""The readings the limits in ``limits/<cell>.json`` are set from, at the
cell's own size on the card, in one process:

    python3 hapibench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 5] [--out FILE]

For each of ``--seeds`` a run of the cell (a short window; the numbers that
decide ``correct`` against the plain reference): the lower readings. For
each of ``--control-seeds`` the control, the plain reference computed with
its products' operands in float8 (``Precision("fp8")``) in the program's
place, against the float32 reference. For each of ``--fault-seeds`` a run
with each fault of the traffic kind's ``FAULTS`` planted but
``unchanged_state``, which reads 1 in ``change_gap`` by the measure's own
form. Each reading is one
JSON line on standard output and in ``--out``. The benchmark's own runs do
not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from hapibench import bench, kinds  # noqa: E402
from hapibench.run import run_cell  # noqa: E402
from hapibench.runtime import free  # noqa: E402


def seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    c = bench.cell(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    if device == "cpu":
        c = bench.smoke(c)

    def emit(row):
        text = json.dumps(row)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    for seed in args.seeds:
        line = run_cell(c, seed, args.seconds, False, device)
        emit({"cell": c.name, "seed": seed, "side": "program", "correct": line["correct"],
              "numbers": {k: v["value"] for k, v in line["checks"].items()},
              "metrics": {k: v["value"] for k, v in line["metrics"].items()}})
        free(device)
    for seed in args.control_seeds:
        emit({"cell": c.name, "seed": seed, "side": "control",
              "numbers": kinds.of(c.traffic).control(c, seed, device)})
        free(device)
    for seed in args.fault_seeds:
        for fault in kinds.of(c.traffic).FAULTS:
            if fault == "unchanged_state":
                continue
            line = run_cell(c, seed, args.seconds, False, device, fault=fault)
            emit({"cell": c.name, "seed": seed, "side": fault, "correct": line["correct"],
                  "numbers": {k: v["value"] for k, v in line["checks"].items()}})
            free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
