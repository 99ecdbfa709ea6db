"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. The file imports neither JAX nor ``conftest``, so it
also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import int8_transfer as tik
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 100, 256), (3, 384), (11, 3, 200), (1, 200), (7, 96),
                                   (3, 80), (9, 5120), (5, 97), (2, 1)])
def test_cuda_int8_bit_exact(card, shape, dtype):
    x = torch.from_numpy(_normal(shape, 11, 3.0)).to(card, _TORCH[dtype])
    q, s = tik.quantize_int8_cuda(x)
    qe, se = tref.quantize_int8(x)
    assert torch.equal(q, qe) and torch.equal(s, se)
    for out in ("float32", "bfloat16"):
        assert torch.equal(tik.dequantize_int8_cuda(q, s, _TORCH[out]),
                           tref.dequantize_int8(qe, se, _TORCH[out]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hkv,hd,causal,window,cap", [
    (2, 200, 4, 2, 64, True, None, None),
    (1, 333, 4, 4, 128, True, 64, None),
    (1, 256, 2, 1, 256, True, 100, 50.0),
    (2, 130, 4, 4, 64, False, None, None),
    (1, 190, 4, 2, 128, False, 30, None),
    (1, 1, 2, 2, 64, True, None, None),
])
def test_cuda_flash_matches_plain(card, dtype, b, s, h, hkv, hd, causal, window, cap):
    dt = _TORCH[dtype]
    q = torch.from_numpy(_normal((b, s, h, hd), 1)).to(card, dt)
    k = torch.from_numpy(_normal((b, s, hkv, hd), 2)).to(card, dt)
    v = torch.from_numpy(_normal((b, s, hkv, hd), 3)).to(card, dt)
    out = tfk.flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=cap)
    rep = h // hkv
    exp = tref.flash_attention(q, tops.repeat_kv(k, rep), tops.repeat_kv(v, rep),
                               causal=causal, window=window, softcap=cap)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_cuda_flash_refuses_grad_and_counts_launches(card):
    q = torch.zeros(1, 64, 2, 64, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        tops.flash_attention(q, q, q)
    # Under no_grad nothing is recorded, so the kernel runs.
    tops.reset_launch_counts()
    with torch.no_grad():
        tops.flash_attention(q, q, q)
        tops.dequantize_int8(*tops.quantize_int8(q[0]), dtype=torch.float32)
    assert tops.launch_counts() == {"flash_attention": 1, "quantize_int8": 1,
                                    "dequantize_int8": 1}
