"""The port's kernel modules against the JAX package's kernels.

On the CPU the port's kernel entry points take their plain PyTorch versions;
these are held to the JAX oracles (``repro.kernels.ref``) and to the Pallas
kernels in interpret mode, on the same numpy inputs. The CUDA kernels
themselves are held to the plain versions in ``test_torch_cuda.py``.
"""
import math
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.int8_transfer import dequantize_int8_pallas, quantize_int8_pallas
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import int8_transfer as tik
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

ROOT = Path(__file__).resolve().parents[1]

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return jnp.asarray(x).astype(_JNP[dtype]), torch.from_numpy(x).to(_TORCH[dtype])


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy() if t.is_floating_point() else t.numpy()
    return np.asarray(t, np.float32) if jnp.issubdtype(t.dtype, jnp.floating) else np.asarray(t)


# ---------------------------------------------------------------------------
# int8 wire
# ---------------------------------------------------------------------------
INT8_SHAPES = [(4, 100, 256), (3, 384), (2, 7, 512), (1, 128),   # test_int8_roundtrip
               (5, 96), (3, 200), (7, 96), (11, 3, 200), (1, 200),  # awkward shapes
               (3, 80), (9, 5120)]                                 # tile 16; the model's width


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", INT8_SHAPES)
def test_int8_plain_bit_exact_with_jax(shape, dtype):
    """q and scales bit-exact with the JAX oracle run eagerly, dequantize
    exact with the oracle's. The Pallas kernel runs under jit, where XLA
    rewrites ``/ 127.0`` as a multiply by the rounded reciprocal: its scales
    may differ by one ulp. Its q agrees exactly in every tile whose scale
    agrees, and elsewhere by at most one where x / scale sat on a tie."""
    jx, tx = _both(_normal(shape, seed=len(shape) * 1000 + shape[-1], scale=3.0), dtype)
    q, s = tops.quantize_int8(tx)
    qe, se = jref.quantize_int8(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(_np(q), np.asarray(qe))
    np.testing.assert_array_equal(_np(s), np.asarray(se))
    qp, sp = quantize_int8_pallas(jx, row_block=4, interpret=True)
    np.testing.assert_array_max_ulp(_np(s), np.asarray(sp), maxulp=1)
    tile = shape[-1] // s.shape[-1]
    same_scale = np.repeat(_np(s) == np.asarray(sp), tile, axis=-1)
    qd = _np(q).astype(np.int32) - np.asarray(qp).astype(np.int32)
    assert not qd[same_scale].any()
    assert np.abs(qd).max() <= 1
    x = tops.dequantize_int8(q, s, dtype=_TORCH[dtype])
    xe = jref.dequantize_int8(qe, se, dtype=_JNP[dtype])
    assert x.dtype == _TORCH[dtype]
    np.testing.assert_array_equal(_np(x), _np(xe))
    # Given the same codes and scales, the Pallas dequantize agrees exactly.
    xp = dequantize_int8_pallas(jnp.asarray(_np(q)), jnp.asarray(_np(s)),
                                dtype=_JNP[dtype], row_block=4, interpret=True)
    np.testing.assert_array_equal(_np(x), _np(xp))


def test_int8_rounds_half_to_even_and_clamps():
    """x / scale lands on .5 exactly: round half to even, as jnp.round."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -127.0, 0.0]], np.float32)
    q, s = tops.quantize_int8(torch.from_numpy(x))
    qe, se = jref.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(_np(q), np.asarray(qe))
    np.testing.assert_array_equal(_np(q)[0], [127, 0, 2, 2, 0, -2, -127, 0])
    np.testing.assert_array_equal(_np(s), np.asarray(se))


def test_wire_ratio_matches_jax():
    assert tops.INT8_WIRE_RATIO == 0.515625 == jops.INT8_WIRE_RATIO
    for tname in ("float32", "bfloat16"):
        for tile in (1, 16, 128):
            assert tops.compression_ratio(_TORCH[tname], tile) == \
                jops.compression_ratio(_JNP[tname], tile)
    with pytest.raises(ValueError):
        tops.compression_ratio(torch.bfloat16, 0)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # b, s, h, hkv, hd, causal, window, softcap
    (2, 96, 4, 4, 32, True, None, None),
    (1, 160, 2, 2, 64, True, None, None),    # s not a multiple of the 32 block
    (2, 128, 4, 4, 16, True, 24, None),      # sliding window
    (1, 96, 2, 2, 32, False, None, None),    # bidirectional
    (2, 64, 4, 4, 32, True, None, 50.0),     # softcap
    (1, 128, 4, 4, 16, True, 16, 50.0),      # gemma2-like: window + softcap
    (2, 96, 8, 2, 32, True, None, None),     # GQA 4:1, passed as Hkv heads
    (1, 64, 4, 1, 16, True, 16, None),       # MQA + window
]


@pytest.mark.parametrize("b,s,h,hkv,hd,causal,window,cap", FLASH_CASES)
def test_flash_plain_matches_jax_ref_and_pallas(b, s, h, hkv, hd, causal, window, cap):
    rep = h // hkv
    qn = _normal((b, s, h, hd), 1)
    kn, vn = _normal((b, s, hkv, hd), 2), _normal((b, s, hkv, hd), 3)
    out = tops.flash_attention(torch.from_numpy(qn), torch.from_numpy(kn),
                               torch.from_numpy(vn), causal=causal, window=window,
                               softcap=cap)
    assert out.shape == (b, s, h, hd) and out.dtype == torch.float32
    krep, vrep = np.repeat(kn, rep, axis=2), np.repeat(vn, rep, axis=2)
    exp = jref.flash_attention(jnp.asarray(qn), jnp.asarray(krep), jnp.asarray(vrep),
                               causal=causal, window=window, softcap=cap)
    pal = flash_attention_pallas(jnp.asarray(qn), jnp.asarray(krep), jnp.asarray(vrep),
                                 causal=causal, window=window, softcap=cap,
                                 q_block=32, kv_block=32, interpret=True)
    np.testing.assert_allclose(_np(out), np.asarray(exp), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(out), np.asarray(pal), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("window", [0, 8, 40])
def test_flash_noncausal_window_holds_to_ref(window):
    """causal=False with a window admits future keys (ref.py); the Pallas
    kernel's tile skip does not, so the port is held to ref.py alone."""
    qn, kn, vn = (_normal((2, 96, 2, 32), i) for i in (4, 5, 6))
    out = tops.flash_attention(*(torch.from_numpy(a) for a in (qn, kn, vn)),
                               causal=False, window=window)
    exp = jref.flash_attention(*(jnp.asarray(a) for a in (qn, kn, vn)),
                               causal=False, window=window)
    np.testing.assert_allclose(_np(out), np.asarray(exp), atol=2e-5, rtol=2e-5)
    # Future keys matter: the causal answer differs.
    causal = tref.flash_attention(*(torch.from_numpy(a) for a in (qn, kn, vn)),
                                  causal=True, window=window)
    assert float((out - causal).abs().max()) > 1e-2


@pytest.mark.parametrize("causal,window,cap", [(True, None, None), (True, 16, 50.0),
                                               (False, None, None)])
def test_flash_plain_bf16_matches_jax_ref(causal, window, cap):
    """bf16 inputs: P is cast to V's type before P.V, as in the oracle."""
    qn, kn, vn = (_normal((2, 64, 4, 32), i) for i in (7, 8, 9))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "bfloat16") for a in (qn, kn, vn))
    out = tops.flash_attention(tq, tk, tv, causal=causal, window=window, softcap=cap)
    exp = jref.flash_attention(jq, jk, jv, causal=causal, window=window, softcap=cap)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(exp), atol=2e-2, rtol=2e-2)


# ---------------------------------------------------------------------------
# Dispatch: CUDA wrappers take CUDA tensors only
# ---------------------------------------------------------------------------
def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="CUDA"):
        tik.quantize_int8_cuda(x)
    with pytest.raises(ValueError, match="CUDA"):
        tik.dequantize_int8_cuda(x.to(torch.int8), torch.zeros(4, 1))
    q = torch.zeros(1, 64, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfk.flash_attention_cuda(q, q, q)


def test_flash_wrapper_rejects_unsupported_head_dim():
    q = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="head_dim"):
        tfk.flash_attention_cuda(q, q, q)


def test_launch_counts_reset():
    tops.reset_launch_counts()
    assert tops.launch_counts() == {"flash_attention": 0, "quantize_int8": 0,
                                    "dequantize_int8": 0}
    # The plain versions launch nothing.
    tops.quantize_int8(torch.ones(2, 128))
    assert sum(tops.launch_counts().values()) == 0


def test_softmax_scale_is_f32():
    for hd in (64, 128, 256):
        want = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
        assert tfk.softmax_scale(hd) == want
        assert abs(tfk.softmax_scale(hd) - 1 / math.sqrt(hd)) < 1e-7


# ---------------------------------------------------------------------------
# The port imports neither jax nor repro
# ---------------------------------------------------------------------------
def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


def test_port_sources_name_no_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), (f, line)
