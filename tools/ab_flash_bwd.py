#!/usr/bin/env python3
"""Time the port's flash-attention backward against another version of it.

    mkdir -p build/flash_bwd_parent
    git archive a67ab9a src/repro_torch/csrc/flash_attention_bwd.cu \\
        | tar -x -C build/flash_bwd_parent
    python3 tools/ab_flash_bwd.py \\
        build/flash_bwd_parent/src/repro_torch/csrc/flash_attention_bwd.cu [VARIANT.cu ...]

Builds the given ``flash_attention_bwd.cu`` ("old"; commit a67ab9a's runs
bf16 on ``mma.sync``), today's source ("new") and copies of today's source
with one piece changed or taken out (``VARIANTS``, and any further source
given) into ``build/ab_flash_bwd/`` with ``-Xptxas -v``, and prints what
ptxas says of each kernel (registers, spills, and any line on ``wgmma``: one
serialized by the compiler runs several times slower). All share one C
interface. Then, on one NVIDIA GPU, at the training path's shape (B 2,
S 4,096, 32 query and 8 KV heads, causal, bf16) at head dims 128 (the
path's), 64 and 256 (gemma2's; its route is ``mma.sync`` in both versions,
so its two times measure the noise):

* holds old and new to the plain version ``ref.flash_attention_bwd`` at
  hd 128 and to each other at every head dim (``assert_close`` at 2e-2,
  ``chip_smoke.py``'s bf16 tolerance), and checks that two calls of each
  give the same bits;
* reports each call's peak device memory above its inputs and outputs;
* times old and new in turns (old, new, new, old), each the device time of
  one call from CUDA-graph replay, and each kernel of a call (the D
  pre-pass, dK/dV, dQ) under ``torch.profiler``;
* times each variant in turns with today's at hd 128 and by kernel, its
  error against new reported but not held (a variant with a piece taken out
  computes something else).

Prints the card's name and power limit and one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(0, str(ROOT))

from ab_ssd import turns  # noqa: E402
from ab_ssd_bwd import peak_mb  # noqa: E402
from chip_smoke import kernel_ms  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    _BWD_SIGNATURES, flash_attention_cuda, softmax_scale)

OUT = ROOT / "build" / "ab_flash_bwd"
SHAPE = (2, 4096, 32, 8)      # b, s, h, hkv: the train step's attention, causal
HEAD_DIMS = (128, 64, 256)    # the path's first
TOL = 2e-2                    # chip_smoke.py's bf16 tolerance
# Copies of today's source with one piece changed or taken out: {name:
# [(text, replacement), ...]}; every occurrence of each text is replaced, and
# each must occur.
VARIANTS = {
    # A deeper ring: three stages, loads two tiles ahead.
    "stages3": [("constexpr int kBwdStages = 2;", "constexpr int kBwdStages = 3;")],
    # No dV += P^T dO and dK += dS^T Q in the dK/dV kernel.
    "no_dvdk": [("          wgmma_rs(dv, pa[kk], sw128_desc(gs + kk * 16 * 128, kBM * 128, 1024));\n",
                 "          ;\n"),
                ("        wgmma_rs(dk, sa[kk], sw128_desc(qs + kk * 16 * 128, kBM * 128, 1024));\n",
                 "        ;\n")],
    # No dQ += dS K in the dQ kernel.
    "no_dq": [("        wgmma_rs(dq, sa[kk], sw128_desc(ks + kk * 16 * 128, kBN * 128, 1024));\n",
               "        ;\n")],
    # No exp2 and no mask in either kernel: P = S.
    "no_exp": [
        ("          else pr = ex2_ftz(st[i] * scale_log2 - ((e & 1) ? l2.y : l2.x));",
         "          else pr = st[i] + 0.f * l2.x;"),
        ("          if (masked && !live(p, q0 + 8 * j", "          if (false && !live(p, q0 + 8 * j"),
        ("        else pr = ex2_ftz(sc[i2] * scale_log2 - (hi ? lse1 : lse0));",
         "        else pr = sc[i2] + 0.f * lse0;"),
        ("        if (masked && !live(p, hi ? qpos1", "        if (false && !live(p, hi ? qpos1")],
    # P is computed only after dP's product is done, not while it runs.
    "no_p_overlap": [
        ("      if constexpr (CAP) {  // dS^T needs tanh's factor: wait for dP^T first\n",
         "      {\n"),
        ("      if constexpr (CAP) {  // dS needs tanh's factor: wait for dP first\n", "      {\n")],
    # Every refill of both rings loads the first tile again (from L2): the
    # time without the loads' trips to device memory.
    "hot_loads": [
        ("    const int h = hk * rep + it / n_t, q0 = (t_lo + it % n_t) * kBM;\n"
         "    const uint32_t bar = full(s);",
         "    const int h = hk * rep, q0 = t_lo * kBM;\n"
         "    const uint32_t bar = full(s);"),
        ("    const int s = i % kBwdStages, kv0 = (t_lo + i) * kBN;",
         "    const int s = i % kBwdStages, kv0 = t_lo * kBN;")],
}


def variant_sources() -> dict:
    today = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    out = {}
    for name, edits in VARIANTS.items():
        src = today
        for text, repl in edits:
            if text not in src:
                raise RuntimeError(f"variant {name}: {text[:60]!r}... is not in the source")
            src = src.replace(text, repl)
        path = OUT / f"flash_attention_bwd_{name}.cu"
        path.write_text(src)
        out[name] = path
    return out


def build(sources: dict) -> tuple:
    """The libraries, built in parallel, and ptxas's report of each kernel:
    {source: {kernel: line}}."""
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
         "-o", str(OUT / f"libflash_attention_bwd_{name}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, src in sources.items()}
    libs, report = {}, {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        print(f"--- ptxas, {name} ---")
        kernel, rows = None, {}
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:   # bwd_dkdv_wgmma<Li128ELb0E>, from its mangled name
                found = re.search(r"(bwd_[a-z0-9_]+)I(.*?)EE", m.group(1))
                kernel = (f"{found.group(1)[found.group(1).rfind('bwd_'):]}<{found.group(2)}>"
                          if found else m.group(1))
            elif "Used" in line or "spill" in line:
                rows[kernel] = (rows.get(kernel, "") + " " + line.split(":", 1)[-1].strip()).strip()
            elif "error" in line or "C75" in line or ("wgmma" in line and "warning" in line):
                print(line.strip())
        for kernel, line in rows.items():
            print(f"{kernel}: {line}")
        report[name] = rows
        if proc.returncode != 0:
            print(out)
            raise RuntimeError(f"nvcc failed for {name}")
        lib = ctypes.CDLL(str(OUT / f"libflash_attention_bwd_{name}.so"))
        argtypes, restype = _BWD_SIGNATURES["flash_attention_bwd"]
        lib.flash_attention_bwd.argtypes, lib.flash_attention_bwd.restype = argtypes, restype
        libs[name] = lib
    return libs, report


def call(lib, q, k, v, out, lse, do):
    """One backward call through ``lib``: (dq, dk, dv)."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dsum = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    rc = lib.flash_attention_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                 do.data_ptr(), lse.data_ptr(), dsum.data_ptr(), dq.data_ptr(),
                                 dk.data_ptr(), dv.data_ptr(), 1, b, s, h, hkv, hd, 1, -1, 0.0,
                                 softmax_scale(hd), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_bwd failed: CUDA error {rc}")
    return dq, dk, dv


def max_err(got, want) -> float:
    return max(float((a.float() - w.float()).abs().max()) for a, w in zip(got, want))


def close(got, want) -> bool:
    """torch.testing.assert_close's test at TOL, absolute and relative."""
    return all(torch.allclose(a.float(), w.float(), atol=TOL, rtol=TOL) for a, w in zip(got, want))


def inputs(hd: int):
    b, s, h, hkv = SHAPE
    g = torch.Generator(device="cuda").manual_seed(hd)
    q, do = (torch.randn((b, s, h, hd), generator=g, device="cuda").bfloat16() for _ in range(2))
    k, v = (torch.randn((b, s, hkv, hd), generator=g, device="cuda").bfloat16() for _ in range(2))
    out, lse = flash_attention_cuda(q, k, v, lse=True)
    return q, k, v, out, lse, do


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    extra = {Path(a).stem: Path(a) for a in sys.argv[2:]}
    variants = {**variant_sources(), **extra}
    libs, ptxas = build({"old": Path(sys.argv[1]),
                         "new": _build.CSRC / "flash_attention_bwd.cu", **variants})
    b, s, h, hkv = SHAPE
    rows = {"shape": {"b": b, "s": s, "h": h, "hkv": hkv, "causal": True}, "ptxas": ptxas,
            "by_head_dim": {}, "variants": {}}
    for hd in HEAD_DIMS:
        args = inputs(hd)
        got = {name: call(libs[name], *args) for name in ("old", "new")}
        again = call(libs["new"], *args)
        equal = all(torch.equal(a, c) for a, c in zip(got["new"], again))
        equal_old = all(torch.equal(a, c) for a, c in zip(got["old"], call(libs["old"], *args)))
        r = {"new_vs_old_max_abs": max_err(got["new"], got["old"]),
             "bit_equal_calls": {"new": equal, "old": equal_old}}
        ok = close(got["new"], got["old"]) and equal and equal_old
        if hd == HEAD_DIMS[0]:
            want = ref.flash_attention_bwd(*args[:3], args[5])
            r["max_abs_vs_plain"] = {name: max_err(g, want) for name, g in got.items()}
            ok = ok and all(close(g, want) for g in got.values())
            del want
        del again
        torch.cuda.empty_cache()
        if not ok:
            raise AssertionError(f"hd {hd}: {r}")
        fns = {name: (lambda lib=lib: call(lib, *args)) for name, lib in libs.items()}
        r["peak_mb_above_inputs"] = {name: peak_mb(fns[name]) for name in ("old", "new")}
        old_new = turns(fns["old"], fns["new"], 10)
        r.update(old_ms=old_new["a_ms"], new_ms=old_new["b_ms"], readings=old_new["readings"],
                 old_by_kernel=kernel_ms(fns["old"]), new_by_kernel=kernel_ms(fns["new"]))
        print(f"hd {hd}: old {r['old_ms']:.4f} ms, new {r['new_ms']:.4f} ms (readings "
              f"{', '.join(f'{x:.4f}' for x in r['readings'])}); new vs old max abs "
              f"{r['new_vs_old_max_abs']:.3g}, vs plain {r.get('max_abs_vs_plain')}; calls "
              f"bit-equal {r['bit_equal_calls']}; peak MB above the inputs "
              f"{r['peak_mb_above_inputs']}")
        for name in ("old", "new"):
            print(f"  {name} by kernel (ms): " + ", ".join(
                f"{k} {v:.4f}" for k, v in r[f"{name}_by_kernel"].items()))
        if hd == HEAD_DIMS[0]:
            for name in variants:
                vr = turns(fns[name], fns["new"], 10)
                vr["max_abs_vs_new"] = max_err(call(libs[name], *args), got["new"])
                vr["by_kernel"] = kernel_ms(fns[name])
                rows["variants"][name] = vr
                print(f"variant {name}: {vr['a_ms']:.4f} ms, new {vr['b_ms']:.4f} ms (readings "
                      f"{', '.join(f'{x:.4f}' for x in vr['readings'])}), max abs vs new "
                      f"{vr['max_abs_vs_new']:.3g}; by kernel " + ", ".join(
                          f"{k} {v:.4f}" for k, v in vr["by_kernel"].items()))
        rows["by_head_dim"][hd] = r
        del args, got, fns
        torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"card": smi, "ab_flash_bwd": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
