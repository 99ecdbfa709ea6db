#!/usr/bin/env python3
"""Time the port's int8 quantize kernel against the version it replaced.

    mkdir -p build/int8_parent
    git archive 0f4f456 src/repro_torch/csrc | tar -x -C build/int8_parent
    python3 tools/ab_int8.py build/int8_parent/src/repro_torch/csrc

Builds ``int8_transfer.cu`` of commit 0f4f456 (one warp per (row, tile),
scalar loads) from the given directory, today's source as the port builds it,
and copies of today's source with one choice changed, into
``build/ab_int8/``, all with ``-Xptxas -v``, and prints what ptxas says of
each kernel (registers, spills). The copies: 1, 4 and 8 chunks of 512 bytes
a warp in flight instead of 2 (``kGroup``); a grid of one resident wave (the
occupancy API times the SMs) striding over the chunks instead of one group a
warp, also with the next group's loads issued before this group's reduction;
registers capped for 8 blocks an SM (``__launch_bounds__``), also at 4 chunks
a warp for 6 and 8 blocks; and, for timing only, the per-element IEEE
division replaced by a multiply (its codes are wrong and are not held).
Then, on one NVIDIA GPU at the storage tier's shape (x bf16 (2, 4096, 5120),
tiles of 128), checks each against the plain version
``ref.quantize_int8`` bit for bit (old, new and every copy but the one
without division) and times them in turns (old, new, new, old; then each
copy, new, new, copy), each the device time of one call from CUDA-graph
replay; today's scalar route at the same shape is timed beside the vector
route. Prints the card's name and power limit and one JSON line.
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

from repro_torch.config import HW  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.int8_transfer import _SIGNATURES  # noqa: E402

OUT = ROOT / "build" / "ab_int8"
SHAPE = (2, 4096, 5120)   # the storage tier's microbatch of boundary activations
TILE = 128
# The parent's C signature: no route flag.
OLD_SIGNATURE = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
                 + [ctypes.c_void_p], ctypes.c_int)
_GROUP = "constexpr int kGroup = 2;"
_BOUNDS = "__launch_bounds__(kThreads)\nquantize_vec_kernel"
_GRID = ("  const long long blocks = ((n_vec + 31) / 32 + kWarps * kGroup - 1) / "
         "(kWarps * kGroup);\n")
_ONE_WAVE = """  int dev = 0, per_sm = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantize_vec_kernel<T>, kThreads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long needed = ((n_vec + 31) / 32 + kWarps * kGroup - 1) / (kWarps * kGroup);
  const long long blocks = needed < per_sm * sms ? needed : per_sm * sms;
"""
_LOADS = """  for (long long c0 = warp * kGroup; c0 < n_chunks; c0 += stride) {
    uint4 raw[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const long long i = (c0 + g) * 32 + lane;
      raw[g] = i < n_vec ? __ldcs(x + i) : make_uint4(0u, 0u, 0u, 0u);
    }
"""
_PREFETCH = """  uint4 raw[kGroup], next[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const long long i = (warp * kGroup + g) * 32 + lane;
    next[g] = i < n_vec ? __ldcs(x + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  for (long long c0 = warp * kGroup; c0 < n_chunks; c0 += stride) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      raw[g] = next[g];
      const long long i = (c0 + stride + g) * 32 + lane;
      next[g] = i < n_vec ? __ldcs(x + i) : make_uint4(0u, 0u, 0u, 0u);
    }
"""
# name: [(text in today's source, its replacement), ...]; "no_division" is timed only.
COPIES = {
    "group1": [(_GROUP, "constexpr int kGroup = 1;")],
    "group4": [(_GROUP, "constexpr int kGroup = 4;")],
    "group8": [(_GROUP, "constexpr int kGroup = 8;")],
    "one_wave": [(_GRID, _ONE_WAVE)],
    "one_wave_prefetch": [(_GRID, _ONE_WAVE), (_LOADS, _PREFETCH)],
    "bounds8": [(_BOUNDS, _BOUNDS.replace("(kThreads)", "(kThreads, 8)"))],
    "group4_bounds6": [(_GROUP, "constexpr int kGroup = 4;"),
                       (_BOUNDS, _BOUNDS.replace("(kThreads)", "(kThreads, 6)"))],
    "group4_bounds8": [(_GROUP, "constexpr int kGroup = 4;"),
                       (_BOUNDS, _BOUNDS.replace("(kThreads)", "(kThreads, 8)"))],
    "no_division": [("rintf(__fdiv_rn(v, scale))", "rintf(v * scale)")],
}


def build(csrc: Path) -> dict:
    """The libraries, built in parallel; prints ptxas's report of each."""
    OUT.mkdir(parents=True, exist_ok=True)
    today = (_build.CSRC / "int8_transfer.cu").read_text()
    sources = {"old": csrc / "int8_transfer.cu", "new": _build.CSRC / "int8_transfer.cu"}
    for name, edits in COPIES.items():
        text = today
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"int8_transfer.cu no longer holds {old!r}")
            text = text.replace(old, new)
        sources[name] = OUT / f"int8_transfer_{name}.cu"
        sources[name].write_text(text)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
         "-o", str(OUT / f"libint8_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        print(f"--- ptxas, {name} ---")
        print("\n".join(line for line in out.splitlines()
                        if "Compiling entry" in line or "Used" in line or "spill" in line))
        if proc.returncode != 0:
            print(out)
            raise RuntimeError(f"nvcc failed for {name}")
        lib = ctypes.CDLL(str(OUT / f"libint8_{name}.so"))
        sig = OLD_SIGNATURE if name == "old" else _SIGNATURES["quantize_int8"]
        lib.quantize_int8.argtypes, lib.quantize_int8.restype = sig
        libs[name] = lib
    return libs


def call(lib, x, vector=None):
    """q, scales from ``lib``; ``vector`` None calls the parent's signature."""
    d = x.shape[-1]
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], d // TILE), dtype=torch.float32, device=x.device)
    route = () if vector is None else (int(vector),)
    rc = lib.quantize_int8(x.data_ptr(), q.data_ptr(), s.data_ptr(), x.numel() // d, d, TILE,
                           1, *route, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"quantize_int8 failed: CUDA error {rc}")
    return q, s


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


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    libs = build(Path(sys.argv[1]))
    g = torch.Generator(device="cuda").manual_seed(1)
    x = (torch.randn(SHAPE, generator=g, device="cuda") * 3).to(torch.bfloat16)
    qe, se = ref.quantize_int8(x)
    fns = {name: (lambda lib=lib, v=(None if name == "old" else True): call(lib, x, v))
           for name, lib in libs.items()}
    fns["scalar_route"] = lambda: call(libs["new"], x, False)
    wrong = {}
    for name, fn in fns.items():
        q, s = fn()
        wrong[name] = int((q != qe).sum()) + int((s != se).sum())
        if name != "no_division" and wrong[name]:
            raise AssertionError(f"{name}: {wrong[name]} codes or scales differ from the plain "
                                 "version")
    n = x.numel()
    nbytes = n * (2 + 1) + se.numel() * 4
    bound_ms = nbytes / HW.hbm_bandwidth * 1e3
    old_new = turns(fns["old"], fns["new"], 20)
    rows = {"old_ms": old_new["a_ms"], "new_ms": old_new["b_ms"],
            "old_new_readings": old_new["readings"], "bound_ms": bound_ms, "bytes": nbytes,
            "mismatches_vs_plain": wrong,
            "copies": {name: turns(fns[name], fns["new"], 20)
                       for name in (*COPIES, "scalar_route")}}
    print(f"quantize_int8 x {SHAPE} bf16, tile {TILE}: old {rows['old_ms']:.4f} ms, new "
          f"{rows['new_ms']:.4f} ms (readings "
          f"{', '.join(f'{r:.4f}' for r in old_new['readings'])}), bound {bound_ms:.4f} ms "
          f"({nbytes} bytes at {HW.hbm_bandwidth / 1e12:g} TB/s)")
    for name, r in rows["copies"].items():
        print(f"{name}: {r['a_ms']:.4f} ms, new {r['b_ms']:.4f} ms (readings "
              f"{', '.join(f'{v:.4f}' for v in r['readings'])}); codes or scales off the plain "
              f"version: {wrong[name]}")
    print(smi)
    print(json.dumps({"card": smi, "ab_int8": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
