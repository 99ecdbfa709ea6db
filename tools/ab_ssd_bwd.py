#!/usr/bin/env python3
"""Time the port's SSD-scan backward kernel against another version of it.

    mkdir -p build/ssd_bwd_parent
    git archive b3cc6c0 src/repro_torch/csrc/ssd_scan_bwd.cu | tar -x -C build/ssd_bwd_parent
    python3 tools/ab_ssd_bwd.py build/ssd_bwd_parent/src/repro_torch/csrc/ssd_scan_bwd.cu \\
        [VARIANT.cu ...]

Builds the given ``ssd_scan_bwd.cu`` ("old") and today's source ("new")
into ``build/ab_ssd_bwd/`` with ``-Xptxas -v`` and prints what ptxas says of
each kernel (registers, spills). Either C interface is taken: commit
b3cc6c0's (the heads' parts of dB and dC passed as two buffers) and today's
(one f32 scratch buffer sized by ``ssd_scan_bwd_scratch``). Then, on one
NVIDIA GPU at the training path's shape (x bf16 (2, 4096, 64, 64), N 128,
chunk 256, a final-state gradient), takes the states from today's forward
kernel, holds each version's five gradients to the plain version
``ref.ssd_chunked_bwd`` (1e-2 relative L2, as ``chip_smoke.py`` does),
checks that two calls of each give the same bits, reports each call's peak
device memory above its inputs and outputs, and times them in turns (old,
new, new, old), each the device time of one call from CUDA-graph replay;
then the new version's time by kernel under ``torch.profiler``. Each further
source (either interface, say with one piece of work taken out) is timed in
turns with today's and by kernel, its error reported but not held. Prints the card's name
and power limit and one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from ab_ssd import device_ms, inputs, turns  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import _BWD_SIGNATURES, ssd_scan_cuda  # noqa: E402

OUT = ROOT / "build" / "ab_ssd_bwd"
SHAPE = (2, 4096, 64, 64, 128, 256)   # b, s, h, p, n, chunk
TOL = 1e-2                            # chip_smoke.py's bf16 tolerance, relative L2
NAMES = ("dx", "ddtA", "ddt", "dB", "dC")
# Commit b3cc6c0's entry point: the heads' parts of dB and dC as two buffers.
OLD_SIGNATURE = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 7 + [ctypes.c_void_p], ctypes.c_int)


def build(sources: dict) -> dict:
    """The libraries, built in parallel; prints ptxas's report of each kernel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
         "-o", str(OUT / f"libssd_scan_bwd_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        print(f"--- ptxas, {name} ---")
        kernel = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                kernel = line.split("'")[1]
            elif "Used" in line or "spill" in line or "error" in line:
                print(f"{kernel}: {line.strip()}")
        if proc.returncode != 0:
            print(out)
            raise RuntimeError(f"nvcc failed for {name}")
        lib = ctypes.CDLL(str(OUT / f"libssd_scan_bwd_{name}.so"))
        if hasattr(lib, "ssd_scan_bwd_scratch"):
            for fn, (argtypes, restype) in _BWD_SIGNATURES.items():
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        else:
            lib.ssd_scan_bwd.argtypes, lib.ssd_scan_bwd.restype = OLD_SIGNATURE
        libs[name] = lib
    return libs


def call(lib, x, dtA, dt, B_, C_, states, dy, ds, chunk):
    """One backward call through ``lib``, in its own C interface."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    dx = torch.empty_like(x)
    ddtA = torch.empty((b, s, h), dtype=torch.float32, device=x.device)
    ddt = torch.empty_like(ddtA)
    dB, dC = torch.empty_like(B_), torch.empty_like(C_)
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "ssd_scan_bwd_scratch"):
        scratch = torch.empty(lib.ssd_scan_bwd_scratch(1, b, s, h, n, p, chunk) // 4,
                              dtype=torch.float32, device=x.device)
        rc = lib.ssd_scan_bwd(x.data_ptr(), dtA.data_ptr(), dt.data_ptr(), B_.data_ptr(),
                              C_.data_ptr(), states.data_ptr(), dy.data_ptr(), ds.data_ptr(),
                              dx.data_ptr(), ddtA.data_ptr(), ddt.data_ptr(), dB.data_ptr(),
                              dC.data_ptr(), scratch.data_ptr(), 1, b, s, h, n, p, chunk, stream)
    else:
        parts = torch.empty((2, b, s, h, n), dtype=torch.float32, device=x.device)
        rc = lib.ssd_scan_bwd(x.data_ptr(), dtA.data_ptr(), dt.data_ptr(), B_.data_ptr(),
                              C_.data_ptr(), states.data_ptr(), dy.data_ptr(), ds.data_ptr(),
                              dx.data_ptr(), ddtA.data_ptr(), ddt.data_ptr(),
                              parts[0].data_ptr(), parts[1].data_ptr(), dB.data_ptr(),
                              dC.data_ptr(), 1, b, s, h, n, p, chunk, stream)
    if rc:
        raise RuntimeError(f"ssd_scan_bwd failed: CUDA error {rc}")
    return dx, ddtA, ddt, dB, dC


def rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def peak_mb(fn) -> float:
    """Peak device memory a call allocates above what is live before it, MB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak / 1e6


def by_kernel(fn, calls: int = 3) -> dict:
    """Device ms of each kernel a call launches, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and "ssd_bwd" in e.key:
            name = e.key.split("ssd_bwd_")[1].split("(")[0].split("<")[0]
            rows[name] = rows.get(name, 0.0) + e.device_time_total / 1e3 / calls
    return rows


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    extra = {Path(a).stem: Path(a) for a in sys.argv[2:]}
    libs = build({"old": Path(sys.argv[1]), "new": _build.CSRC / "ssd_scan_bwd.cu", **extra})
    b, s, h, p, n, chunk = SHAPE
    args = inputs(b, s, h, p, n)
    g = torch.Generator(device="cuda").manual_seed(45)
    dy = torch.randn((b, s, h, p), generator=g, device="cuda")
    ds = torch.randn((b, h, n, p), generator=g, device="cuda")
    _, _, states = ssd_scan_cuda(*args, chunk=chunk, states=True)
    want = ref.ssd_chunked_bwd(*args, dy, ds, chunk=chunk, states=states)
    errs, equal, peak = {}, {}, {}
    for name, lib in libs.items():
        got = call(lib, *args, states, dy, ds, chunk)
        again = call(lib, *args, states, dy, ds, chunk)
        errs[name] = {k: rel(a, w) for k, a, w in zip(NAMES, got, want)}
        equal[name] = all(torch.equal(a, c) for a, c in zip(got, again))
        del got, again
        peak[name] = peak_mb(lambda lib=lib: call(lib, *args, states, dy, ds, chunk))
        if name not in extra:
            bad = {k: e for k, e in errs[name].items() if e > TOL}
            if bad or not equal[name]:
                raise AssertionError(f"{name}: relative L2 {bad}, calls bit-equal {equal[name]}")
    fns = {name: (lambda lib=lib: call(lib, *args, states, dy, ds, chunk))
           for name, lib in libs.items()}
    old_new = turns(fns["old"], fns["new"], 3)
    rows = {"old_ms": old_new["a_ms"], "new_ms": old_new["b_ms"],
            "old_new_readings": old_new["readings"], "rel_l2_vs_plain": errs,
            "bit_equal_calls": equal, "peak_mb_above_inputs": peak,
            "new_ms_by_kernel": by_kernel(fns["new"]),
            "variants": {name: turns(fns[name], fns["new"], 3) for name in extra},
            "variant_ms_by_kernel": {name: by_kernel(fns[name]) for name in extra}}
    for name, r in rows["variants"].items():
        print(f"variant {name}: {r['a_ms']:.4f} ms, new {r['b_ms']:.4f} ms (readings "
              f"{', '.join(f'{x:.4f}' for x in r['readings'])}), relative L2 vs plain "
              f"{errs[name]}; by kernel " + ", ".join(
                  f"{k} {v:.4f}" for k, v in rows["variant_ms_by_kernel"][name].items()))
    print(f"ssd_scan_bwd x {b} x {s} x {h} x {p} bf16, N {n}, chunk {chunk}: old "
          f"{rows['old_ms']:.4f} ms, new {rows['new_ms']:.4f} ms (readings "
          f"{', '.join(f'{x:.4f}' for x in old_new['readings'])}); relative L2 vs plain "
          f"{errs}; calls bit-equal {equal}; peak MB above the inputs {peak}")
    print("new by kernel (ms): " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in rows["new_ms_by_kernel"].items()))
    print(smi)
    print(json.dumps({"card": smi, "ab_ssd_bwd": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
