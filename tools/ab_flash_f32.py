#!/usr/bin/env python3
"""Time the flash forward's f32 route against another version of it.

    mkdir -p build/flash_f32_parent
    git archive 4dba71b src/repro_torch/csrc/flash_attention.cu \\
        | tar -x -C build/flash_f32_parent
    python3 tools/ab_flash_f32.py \\
        build/flash_f32_parent/src/repro_torch/csrc/flash_attention.cu [VARIANT.cu ...]

Builds the given ``flash_attention.cu`` ("old"; commit 4dba71b's takes f32
at every head dim on the CUDA cores' FMA kernel), today's source ("new",
split TF32 on ``mma.sync`` at head dims 64 and 128), the copies of today's
source that ``ERROR_VARIANTS`` makes and any further source with today's C
interface (a copy of today's with one piece changed or taken out) into
``build/ab_flash_f32/`` with ``-Xptxas -v``, and prints what ptxas says of
each f32 kernel (registers, spills). Then, on one NVIDIA GPU, in f32 at the
ViT block's shape (200, 196, 6 heads of 64, non-causal: the vision path's)
and at (2, 300, 4/2 heads of 64, causal):

* holds old and new to the plain version ``ref.flash_attention`` at 2e-5
  (``chip_smoke.py``'s f32 tolerance) and checks that two calls of new give
  the same bits;
* times old and new in turns (old, new, new, old), each the device time of
  one call from CUDA-graph replay, beside SDPA on the same inputs (f32, TF32
  off) and each route's bound: for new the larger of the bytes at 3.35 TB/s
  and the three TF32 products at 495 TFLOP/s, for old the larger of the
  bytes and the f32 operations at 67 TFLOP/s on the CUDA cores;
* times each variant in turns with new (variant, new, new, variant), its
  error against the plain version reported but not held;
* measures the card's rate of ``mma.sync.m16n8k8`` in TF32 (the route's
  instruction) with a kernel of independent products and nothing else
  (``MMA_RATE_SOURCE``): the most the route's products could reach.

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

from repro_torch.config import HW  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _SIGNATURES, flash_attention_cuda, fwd_route, softmax_scale)

OUT = ROOT / "build" / "ab_flash_f32"
# b, s, h, hkv, hd, causal: the ViT block at the COS batch, then chip_smoke.py's
# first f32 case.
SHAPES = ((200, 196, 6, 6, 64, False), (2, 300, 4, 2, 64, True))
TOL = 2e-5

# mma3 of today's source: the two small products, then hi.hi, all into the
# running accumulator d.
_MMA3_BODY = """\
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma_tf32(d[d0 + i], a_hi.x, a_hi.y, a_hi.z, a_hi.w, k0_of(b_lo[i], s), k4_of(b_lo[i], s));
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma_tf32(d[d0 + i], a_lo.x, a_lo.y, a_lo.z, a_lo.w, k0_of(b_hi[i], s), k4_of(b_hi[i], s));
#pragma unroll
  for (int i = 0; i < N; ++i)
    mma_tf32(d[d0 + i], a_hi.x, a_hi.y, a_hi.z, a_hi.w, k0_of(b_hi[i], s), k4_of(b_hi[i], s));
"""


def _mma3_body(small_into: str, big_into: str) -> str:
    """mma3 with the two small products accumulated into ``small_into`` and
    hi.hi into ``big_into`` ("c[i]", a fresh accumulator of the k-step that
    is added to d[d0 + i] in f32 on the CUDA cores, or "d[d0 + i]")."""
    small = _MMA3_BODY.replace("mma_tf32(d[d0 + i]", f"mma_tf32({small_into}")
    head, big = small.rsplit("#pragma unroll\n", 1)
    return ("  float c[N][4];\n#pragma unroll\n"
            "  for (int i = 0; i < N; ++i) c[i][0] = c[i][1] = c[i][2] = c[i][3] = 0.f;\n"
            + head + "#pragma unroll\n" + big.replace(f"mma_tf32({small_into}",
                                                      f"mma_tf32({big_into}")
            + "#pragma unroll\n  for (int i = 0; i < N; ++i)\n#pragma unroll\n"
            "    for (int e = 0; e < 4; ++e) d[d0 + i][e] += c[i][e];\n")


# Copies of today's source with one piece changed, to find where the route's
# error against the plain version comes from; each a list of (text of today's
# source, what replaces it).
ERROR_VARIANTS = {
    # 2^x in f64, then rounded to f32 (within an ulp), in place of
    # ex2.approx (about 2 ulp; exp2f is the same instruction).
    "exp2_f64": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                  "y = static_cast<float>(exp2(static_cast<double>(x)));")],
    # hi.lo and lo.hi into their own accumulator, added to d after hi.hi.
    "split_acc": [(_MMA3_BODY, _mma3_body("c[i]", "d[d0 + i]"))],
    # All three products into a fresh accumulator, added to d on the CUDA
    # cores: the running sums over the k-steps leave the tensor cores.
    "fresh_acc": [(_MMA3_BODY, _mma3_body("c[i]", "c[i]"))],
    # The same for O = P.V only; S = Q.K^T as today.
    "fresh_acc_pv": [
        ("// 2^x on the MUFU unit", "template <int N, int M>\n"
         "__device__ __forceinline__ void mma3_fresh(float (&d)[M][4], int d0, const float4 a_hi,\n"
         "    const float4 a_lo, const float4 (&b_hi)[N], const float4 (&b_lo)[N], int s) {\n"
         + _mma3_body("c[i]", "c[i]") + "}\n\n// 2^x on the MUFU unit"),
        ("mma3(o[s], n0,", "mma3_fresh(o[s], n0,")],
}


def error_variants() -> dict:
    """Write each of ERROR_VARIANTS beside the libraries; {name: path}."""
    OUT.mkdir(parents=True, exist_ok=True)
    today = (_build.CSRC / "flash_attention.cu").read_text()
    paths = {}
    for name, edits in ERROR_VARIANTS.items():
        src = today
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"variant {name}: its text is not in today's source once")
            src = src.replace(old, new)
        paths[name] = OUT / f"{name}.cu"
        paths[name].write_text(src)
    return paths


# 16 warps an SM, each with 8 independent accumulators, ITERS x 8 products.
MMA_RATE_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(512) mma_rate(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a0 = threadIdx.x, a1 = a0 + 1, a2 = a0 + 2, a3 = a0 + 3, b0 = a0 ^ 5, b1 = a0 ^ 9;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                   "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                   : "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
                   : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_run(float* out, int iters, int blocks, void* stream) {
  mma_rate<<<blocks, 512, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_rate() -> dict:
    """TF32 mma.sync m16n8k8 FLOP/s over every SM, timed by CUDA events."""
    src = OUT / "mma_rate.cu"
    src.write_text(MMA_RATE_SOURCE)
    lib_path = OUT / "libmma_rate.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_rate_run.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters, blocks = 4096, 4 * sms
    out = torch.empty(blocks * 512, device="cuda")

    def run():
        if lib.mma_rate_run(out.data_ptr(), iters, blocks,
                            torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("mma_rate failed")

    ms = device_ms(run, 3)
    flops = blocks * 16 * iters * 8 * 2 * 16 * 8 * 8
    return {"ms": ms, "tflops": flops / ms / 1e9, "sms": sms}


def build(sources: dict) -> dict:
    """Each source into its own library, all at once, with ptxas's report;
    {name: its flash_attention_fwd, called without the route argument},
    "old" with the parent's C signature (no route)."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
         "-o", str(OUT / f"libflash_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        lines = out.splitlines()
        print(f"--- ptxas, {name}: the f32 kernels ---")
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and ("tf32" in line or "f32" in line):
                print("\n".join(lines[i:i + 4]))
        if proc.returncode != 0:
            print(out)
            raise RuntimeError(f"nvcc failed for {name}")
        fn = ctypes.CDLL(str(OUT / f"libflash_{name}.so")).flash_attention_fwd
        args, fn.restype = _SIGNATURES["flash_attention_fwd"]
        if name == "old":
            fn.argtypes = args[:-2] + args[-1:]
            libs[name] = fn
        else:
            fn.argtypes = args
            libs[name] = lambda *a, fn=fn: fn(*a[:-1], None, a[-1])
    return libs


def call(fwd, q, k, v, causal):
    b, s, h, hd = q.shape
    out = torch.empty_like(q)
    rc = fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
             0, b, s, h, k.shape[2], hd, *q.stride()[:3], *k.stride()[:3],
             *v.stride()[:3], int(causal), -1, 0.0, softmax_scale(hd),
             torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd failed: CUDA error {rc}")
    return out


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


def randn(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda")


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    variants = {**error_variants(), **{Path(v).stem: Path(v) for v in sys.argv[2:]}}
    libs = build({"old": Path(sys.argv[1]), "new": _build.CSRC / "flash_attention.cu",
                  **variants})
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for b, s, h, hkv, hd, causal in SHAPES:
        q, k, v = randn((b, s, h, hd), 1), randn((b, s, hkv, hd), 2), randn((b, s, hkv, hd), 3)
        want = ref.flash_attention(q, ops.repeat_kv(k, h // hkv), ops.repeat_kv(v, h // hkv),
                                   causal=causal)
        old = lambda: call(libs["old"], q, k, v, causal)  # noqa: E731
        new = lambda: call(libs["new"], q, k, v, causal)  # noqa: E731
        got_new, again = new(), new()
        errs = {"old": float((old() - want).abs().max()), "new": float((got_new - want).abs().max())}
        for name in ("old", "new"):
            torch.testing.assert_close(old() if name == "old" else got_new, want, atol=TOL,
                                       rtol=TOL, msg=f"{name} at {(b, s, h, hkv, hd, causal)}")
        bit_equal = torch.equal(got_new, again)
        if not bit_equal:
            raise AssertionError("two calls of new differ")
        # The main path's wrapper takes the same route and gives the same bits.
        if not torch.equal(flash_attention_cuda(q, k, v, causal=causal), got_new):
            raise AssertionError("the wrapper and today's library differ")
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4 * hd * b * h * pairs
        nbytes = (2 * b * s * h * hd + 2 * b * s * hkv * hd) * 4
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        iters = 20
        r = turns(old, new, iters)
        row = {"old_ms": r["a_ms"], "new_ms": r["b_ms"], "readings": r["readings"],
               "sdpa_ms": device_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=hkv != h), iters),
               "bound_ms": max(3 * flops / HW.peak_flops_tf32, nbytes / HW.hbm_bandwidth) * 1e3,
               "fma_bound_ms": max(flops / HW.peak_flops_f32, nbytes / HW.hbm_bandwidth) * 1e3,
               "tf32x3_floor_ms": 3 * flops / HW.peak_flops_tf32 * 1e3,
               "max_abs_err": errs, "new_bit_equal": bit_equal,
               "route": fwd_route(hd, torch.float32)[0]}
        for name in variants:
            fn = lambda lib=libs[name]: call(lib, q, k, v, causal)  # noqa: E731
            vr = turns(fn, new, iters)
            row[f"{name}_ms"] = vr["a_ms"]
            row[f"{name}_readings"] = vr["readings"]
            row[f"{name}_max_abs_err"] = float((fn() - want).abs().max())
        rows[f"{b}x{s} {h}/{hkv} hd {hd} {'causal' if causal else 'non-causal'}"] = row
        del q, k, v, want, qt, kt, vt
        torch.cuda.empty_cache()
    rate = mma_rate()
    print(f"mma.sync m16n8k8 TF32, independent products on {rate['sms']} SMs: "
          f"{rate['tflops']:.1f} TFLOP/s ({HW.peak_flops_tf32 / 1e12:.0f} the TF32 peak)")
    for name, r in rows.items():
        print(f"{name} f32: old (FMA) {r['old_ms']:.4f} ms, new ({r['route']}) "
              f"{r['new_ms']:.4f} ms (readings "
              f"{', '.join(f'{x:.4f}' for x in r['readings'])}), SDPA {r['sdpa_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms (old's f32 FMA bound {r['fma_bound_ms']:.4f} ms), "
              f"3xTF32 floor {r['tf32x3_floor_ms']:.4f} ms; "
              f"max abs err old {r['max_abs_err']['old']:.3g}, new {r['max_abs_err']['new']:.3g}"
              + "".join(f"; {v} {r[v + '_ms']:.4f} ms (err {r[v + '_max_abs_err']:.3g})"
                        for v in variants))
    print(smi)
    print(json.dumps({"card": smi, "ab": rows, "mma_sync_tf32": rate}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
