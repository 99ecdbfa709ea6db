#!/usr/bin/env python3
"""Do the attention checks at whisper's shapes catch a kernel that drops
the keys past the last full tile?

    python3 tools/tail_tile_check.py

whisper-small's 1,500 frames are not a multiple of the 128-key tile, so its
attention runs a partial last tile of 92 keys. On one NVIDIA GPU, at
whisper's shapes, this holds today's kernel and a version of it that never
reads those 92 keys against the plain version (``ref``), on seeded bf16
inputs as ``chip_smoke.py`` draws them:

* flash, (B, 1500, 12 heads of 64), non-causal, B = 4 and 8: the version
  without the tail is a copy of ``csrc/flash_attention.cu`` whose
  ``kv_tiles`` rounds the last tile down (``t_hi = hi / bn``), built into
  ``build/tail_tile_check/``; producer and consumers read the same count,
  so it runs to its end;
* decode over the 1,500-frame cross cache, (4, 12/12 heads, hd 64): the
  version without the tail is today's kernel called with length 1,408.

For each it prints the max abs error and the relative L2, and the verdict
of each check ``chip_smoke.py`` makes: the max-abs bound (flash: max abs
<= 2e-2; decode: ``assert_close`` at atol = rtol = 3e-2) and relative L2
<= ``ATTN_REL_TOL`` (1e-2). Exits non-zero unless today's kernels pass both
and every version without the tail fails the relative L2. Prints the card's
name and power limit and one JSON line.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402

OUT = ROOT / "build" / "tail_tile_check"
FLASH_MAX_ABS = 2e-2     # chip_smoke.py's BF16_TOL, a max-abs bound on flash
DECODE_TOL = 3e-2        # chip_smoke.py's DECODE_BF16_TOL, atol = rtol of assert_close
ATTN_REL_TOL = 1e-2      # chip_smoke.py's ATTN_REL_TOL, relative L2
FRAMES, HEADS, HD, TILE = 1500, 12, 64, 128
KEPT = FRAMES // TILE * TILE     # 1,408 keys in full tiles
ROUND_UP = "  t_hi = (hi + bn - 1) / bn;\n"
ROUND_DOWN = "  t_hi = hi / bn;\n"


def randn(shape, seed):
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def rel_err(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm())


def no_tail_flash():
    """flash_attention_cuda on the copy of today's source whose kv_tiles
    drops the partial last tile; the wrapper loads it as it loads today's."""
    csrc = OUT / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(_build.CSRC, csrc)
    src = (csrc / "flash_attention.cu").read_text()
    if src.count(ROUND_UP) != 1:
        raise RuntimeError("kv_tiles's rounding is not in today's flash_attention.cu once")
    (csrc / "flash_attention.cu").write_text(src.replace(ROUND_UP, ROUND_DOWN))

    def run(q, k, v):
        saved = _build.CSRC, _build.BUILD_DIR, _build._LIBS.pop("flash_attention", None)
        _build.CSRC, _build.BUILD_DIR = csrc, OUT / "lib"
        try:
            return flash_attention_cuda(q, k, v, causal=False)
        finally:
            _build.CSRC, _build.BUILD_DIR = saved[0], saved[1]
            _build._LIBS.pop("flash_attention", None)
            if saved[2] is not None:
                _build._LIBS["flash_attention"] = saved[2]
    return run


def verdicts(got, want, max_abs_ok):
    err = float((got.float() - want.float()).abs().max())
    rel = rel_err(got, want)
    return dict(max_abs=err, rel_l2=rel, max_abs_check=bool(max_abs_ok(got, want, err)),
                rel_l2_check=rel <= ATTN_REL_TOL)


def assert_close_ok(got, want, _err):
    try:
        torch.testing.assert_close(got.float(), want.float(), atol=DECODE_TOL, rtol=DECODE_TOL)
    except AssertionError:
        return False
    return True


def main() -> int:
    if not torch.cuda.is_available():
        print("tail_tile_check: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    OUT.mkdir(parents=True, exist_ok=True)
    flash_no_tail = no_tail_flash()
    rows = {}
    for b in (4, 8):
        q, k, v = (randn((b, FRAMES, HEADS, HD), seed) for seed in (21, 22, 23))
        want = ref.flash_attention(q, k, v, causal=False)
        within = (lambda got, w, err: err <= FLASH_MAX_ABS)
        rows[f"flash {b} x {FRAMES}"] = {
            "kernel": verdicts(flash_attention_cuda(q, k, v, causal=False), want, within),
            "no tail": verdicts(flash_no_tail(q, k, v), want, within),
            "output rms": float(want.float().pow(2).mean().sqrt())}
        del q, k, v, want
        torch.cuda.empty_cache()
    q = randn((4, HEADS, HD), 7)
    k, v = randn((4, FRAMES, HEADS, HD), 8), randn((4, FRAMES, HEADS, HD), 9)
    want = ref.decode_attention(q, k, v, FRAMES)
    rows[f"decode 4 x {FRAMES}"] = {
        "kernel": verdicts(decode_attention_cuda(q, k, v, FRAMES), want, assert_close_ok),
        "no tail": verdicts(decode_attention_cuda(q, k, v, KEPT), want, assert_close_ok),
        "output rms": float(want.float().pow(2).mean().sqrt())}
    ok = True
    for name, r in rows.items():
        for which in ("kernel", "no tail"):
            x = r[which]
            print(f"{name}, {which}: max abs {x['max_abs']:.4g}, relative L2 {x['rel_l2']:.4g}; "
                  f"max-abs check {'passes' if x['max_abs_check'] else 'fails'}, relative L2 "
                  f"check {'passes' if x['rel_l2_check'] else 'fails'} (output rms "
                  f"{r['output rms']:.4g})")
        ok &= r["kernel"]["max_abs_check"] and r["kernel"]["rel_l2_check"]
        ok &= not r["no tail"]["rel_l2_check"]
    print(smi)
    print(json.dumps({"tail_tile_check": rows, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
