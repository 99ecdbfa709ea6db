#!/usr/bin/env python3
"""Time the port's SSD-scan kernel against the version it replaced.

    mkdir -p build/ssd_parent
    git archive 38f08f7 src/repro_torch/csrc | tar -x -C build/ssd_parent
    python3 tools/ab_ssd.py build/ssd_parent/src/repro_torch/csrc [VARIANT.cu ...]

Builds ``ssd_scan.cu`` of commit 38f08f7 (f32 FMA on the CUDA cores) from
the given directory, today's source as the port builds it, and a copy of
today's source with 32 columns a block (``kPblk = 32``: twice the blocks,
C.B^T computed twice as often) into ``build/ab_ssd/``, all with ``-Xptxas -v``,
and prints what ptxas says of each kernel (registers, static shared
memory, spills) and the bf16 kernel's launch (grid, threads, dynamic shared
memory). Then, on one NVIDIA GPU at mamba2-1.3b's prefill shape (x bf16
(4, 512, 64, 64), N 128, chunk 256), checks each against the plain version
``ref.ssd_chunked`` and against each other, and times them in turns (old,
new, new, old; then 32 columns, new, new, 32 columns), each the device time
of one call from CUDA-graph replay. Each further source given (a variant of
``ssd_scan.cu`` with the same C interface, say with one piece of work taken
out) is built the same way and timed in turns with today's (variant, new,
new, variant), its error against the plain version reported but not held.
Prints the card's name and power limit and one JSON line.
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

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import _SIGNATURES, launch_config  # noqa: E402

OUT = ROOT / "build" / "ab_ssd"
SHAPE = (4, 512, 64, 64, 128, 256)   # b, s, h, p, n, chunk
TOL = 2e-3                           # the SSD tolerance of the tests and chip_smoke.py


def build(csrc: Path, extra_sources=()) -> dict:
    """The libraries, built in parallel; prints ptxas's report of each."""
    OUT.mkdir(parents=True, exist_ok=True)
    today = (_build.CSRC / "ssd_scan.cu").read_text()
    wide = "constexpr int kPblk = 64;"
    if wide not in today:
        raise RuntimeError(f"ssd_scan.cu no longer holds {wide!r}")
    pblk32 = OUT / "ssd_scan_pblk32.cu"
    pblk32.write_text(today.replace(wide, "constexpr int kPblk = 32;"))
    variants = {"old": csrc / "ssd_scan.cu", "new": _build.CSRC / "ssd_scan.cu",
                "new_pblk32": pblk32}
    variants.update({Path(src).stem: Path(src) for src in extra_sources})
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
         "-o", str(OUT / f"libssd_scan_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in variants.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        print(f"--- ptxas, {name} ---")
        print("\n".join(line for line in out.splitlines() if "ptxas" in line or "spill" in line))
        if proc.returncode != 0:
            print(out)
            raise RuntimeError(f"nvcc failed for {name}")
        lib = ctypes.CDLL(str(OUT / f"libssd_scan_{name}.so"))
        argtypes, restype = _SIGNATURES["ssd_scan_fwd"]
        # Sources from before the per-chunk states output take one pointer less.
        lib.takes_states = "float* states" in Path(variants[name]).read_text()
        lib.ssd_scan_fwd.argtypes = argtypes if lib.takes_states else argtypes[1:]
        lib.ssd_scan_fwd.restype = restype
        libs[name] = lib
    return libs


def call(lib, x, dtA, dt, B_, C_, chunk):
    b, s, h, p = x.shape
    n = B_.shape[-1]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), dtA.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
            y.data_ptr(), state.data_ptr()) + ((None,) if lib.takes_states else ())
    rc = lib.ssd_scan_fwd(*ptrs, 1, b, s, h, n, p, chunk,
                          torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"ssd_scan_fwd failed: CUDA error {rc}")
    return y, state


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


def turns(a, b, iters: int) -> dict:
    """a, b, b, a; the mean of each pair and every reading."""
    a1, b1, b2, a2 = (device_ms(f, iters) for f in (a, b, b, a))
    return {"a_ms": (a1 + a2) / 2, "b_ms": (b1 + b2) / 2, "readings": [a1, b1, b2, a2]}


def inputs(b, s, h, p, n, seed=10):
    """chip_smoke.py's SSD inputs."""
    def randn(shape, dtype, sd):
        g = torch.Generator(device="cuda").manual_seed(sd)
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    bf = torch.bfloat16
    x = randn((b, s, h, p), bf, seed)
    dts = torch.nn.functional.softplus(randn((b, s, h), torch.float32, seed + 1))
    a = -torch.exp(randn((h,), torch.float32, seed + 2) * 0.3)
    return x, dts * a, dts, randn((b, s, n), bf, seed + 3) * 0.3, randn((b, s, n), bf, seed + 4) * 0.3


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    extra = [Path(a).stem for a in sys.argv[2:]]
    libs = build(Path(sys.argv[1]), sys.argv[2:])
    b, s, h, p, n, chunk = SHAPE
    grid, threads, smem = launch_config(b, h, p, n, chunk)
    print(f"bf16 launch at the path's shape: grid {grid}, {threads} threads, "
          f"{smem} bytes of dynamic shared memory")
    args = inputs(b, s, h, p, n)
    ye, ste = ref.ssd_chunked(*args, chunk=chunk)
    outs = {name: call(lib, *args, chunk) for name, lib in libs.items()}
    errs = {name: max(float((y - ye).abs().max()), float((st - ste).abs().max()))
            for name, (y, st) in outs.items()}
    old_vs_new = max(float((outs["old"][i] - outs["new"][i]).abs().max()) for i in (0, 1))
    for name, (y, st) in outs.items():
        if name in extra:
            continue
        torch.testing.assert_close(y, ye, atol=TOL, rtol=TOL, msg=lambda m: f"{name} y: {m}")
        torch.testing.assert_close(st, ste, atol=TOL, rtol=TOL, msg=lambda m: f"{name} state: {m}")
    fns = {name: (lambda lib=lib: call(lib, *args, chunk)) for name, lib in libs.items()}
    old_new = turns(fns["old"], fns["new"], 20)
    pb_new = turns(fns["new_pblk32"], fns["new"], 50)
    rows = {"old_ms": old_new["a_ms"], "new_ms": old_new["b_ms"],
            "old_new_readings": old_new["readings"],
            "pblk32_ms": pb_new["a_ms"], "pblk64_ms": pb_new["b_ms"],
            "pblk32_pblk64_readings": pb_new["readings"],
            "launch": {"grid": grid, "threads": threads, "smem": smem},
            "max_abs_err_vs_plain": errs, "max_abs_old_vs_new": old_vs_new,
            "variants": {name: turns(fns[name], fns["new"], 20) for name in extra}}
    for name, r in rows["variants"].items():
        print(f"variant {name}: {r['a_ms']:.4f} ms, new {r['b_ms']:.4f} ms (readings "
              f"{', '.join(f'{x:.4f}' for x in r['readings'])}), max abs err vs plain "
              f"{errs[name]:.3g}")
    print(f"ssd_scan x {b} x {s} x {h} x {p} bf16, N {n}, chunk {chunk}: old "
          f"{rows['old_ms']:.4f} ms, new {rows['new_ms']:.4f} ms (readings "
          f"{', '.join(f'{x:.4f}' for x in old_new['readings'])}); 32 columns a block "
          f"{rows['pblk32_ms']:.4f} ms, 64 {rows['pblk64_ms']:.4f} ms (readings "
          f"{', '.join(f'{x:.4f}' for x in pb_new['readings'])}); max abs err vs plain "
          f"{errs}, max |old - new| {old_vs_new:.3g}")
    print(smi)
    print(json.dumps({"card": smi, "ab_ssd": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
