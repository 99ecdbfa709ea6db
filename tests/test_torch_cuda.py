"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: a CUDA
kernel has no CPU mode. The file imports neither JAX nor ``conftest``, so it
also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import copy
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as tdk
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import int8_transfer as tik
from repro_torch.kernels.int8_cases import INT8_ADVERSARIAL, int8_adversarial
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tsk
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.profiler import profile_layered
from repro_torch.core.tier_split import make_vision_executor
from repro_torch.cos.objectstore import ObjectStore
from repro_torch.cos.server import HapiServer, PostRequest, _leaves
from repro_torch.launch.serve import serve
from repro_torch.models import layers as tl
from repro_torch.models import vision as tv

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
@pytest.mark.parametrize("case", INT8_ADVERSARIAL)
def test_cuda_int8_bit_exact_on_adversarial_inputs(card, case, dtype):
    x = torch.from_numpy(int8_adversarial(case)).to(card, _TORCH[dtype])
    tops.reset_launch_counts()
    q, s = tik.quantize_int8_cuda(x)
    qe, se = tref.quantize_int8(x)
    assert tik.quantize_routes == {"vector": 1, "scalar": 0}
    assert torch.equal(q, qe) and torch.equal(s, se)
    for out in ("float32", "bfloat16"):
        assert torch.equal(tik.dequantize_int8_cuda(q, s, _TORCH[out]),
                           tref.dequantize_int8(qe, se, _TORCH[out]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,route", [
    ("bfloat16", 5120, "vector"), ("bfloat16", 192, "vector"), ("bfloat16", 96, "vector"),
    ("bfloat16", 80, "vector"), ("bfloat16", 8, "vector"), ("bfloat16", 12, "scalar"),
    ("bfloat16", 97, "scalar"), ("float32", 5120, "vector"), ("float32", 96, "vector"),
    ("float32", 80, "vector"), ("float32", 8, "vector"), ("float32", 12, "vector"),
    ("float32", 2, "scalar"), ("float32", 97, "scalar"),
])
def test_cuda_int8_every_route_and_lane_count(card, dtype, d, route):
    """Every tile the vector route takes (1 to 32 lanes a tile) and the
    scalar route's, bit-exact; 37 rows, so the last warp's chunks are ragged;
    the route is counted once per launch."""
    x = torch.from_numpy(_normal((37, d), 41, 3.0)).to(card, _TORCH[dtype])
    tops.reset_launch_counts()
    q, s = tik.quantize_int8_cuda(x)
    qe, se = tref.quantize_int8(x)
    assert tik.quantize_route(x, math.gcd(d, 128)) == route
    assert tik.quantize_routes == {"vector": int(route == "vector"),
                                   "scalar": int(route == "scalar")}
    assert torch.equal(q, qe) and torch.equal(s, se)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_int8_unaligned_view_takes_the_scalar_route(card, dtype):
    """A view 2 (or 4) bytes off 16-byte alignment: the scalar route, chosen
    before the launch, bit-exact; the aligned copy takes the vector route."""
    rows, d = 300, 5120
    buf = torch.from_numpy(_normal((rows * d + 1,), 42, 3.0)).to(card, _TORCH[dtype])
    view = buf[1:].view(rows, d)
    assert view.is_contiguous() and view.data_ptr() % 16
    tops.reset_launch_counts()
    q, s = tik.quantize_int8_cuda(view)
    qa, sa = tik.quantize_int8_cuda(view.clone())
    assert tik.quantize_routes == {"vector": 1, "scalar": 1}
    qe, se = tref.quantize_int8(view)
    assert torch.equal(q, qe) and torch.equal(s, se)
    assert torch.equal(qa, qe) and torch.equal(sa, se)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("b,s,h,hkv,causal,window,cap", [
    (2, 200, 4, 2, True, None, None),
    (1, 333, 4, 4, True, 64, None),
    (1, 256, 6, 1, True, 16, 50.0),
    (2, 130, 4, 4, False, None, None),
    (1, 190, 4, 2, False, 30, None),
])
def test_cuda_flash_f32_small_head_dims(card, hd, b, s, h, hkv, causal, window, cap):
    """Head dims 16 and 32 in f32, the smoke configs' attention."""
    q = torch.from_numpy(_normal((b, s, h, hd), 4)).to(card)
    k = torch.from_numpy(_normal((b, s, hkv, hd), 5)).to(card)
    v = torch.from_numpy(_normal((b, s, hkv, hd), 6)).to(card)
    out = tfk.flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=cap)
    rep = h // hkv
    exp = tref.flash_attention(q, tops.repeat_kv(k, rep), tops.repeat_kv(v, rep),
                               causal=causal, window=window, softcap=cap)
    torch.testing.assert_close(out, exp, atol=2e-5, rtol=2e-5)


# S around the 16-row strips, the 32-row warps and the 32- and 16-key tiles
# of the split-TF32 route (f32 at head dims 64 and 128), and the ViT's 196,
# which leaves a warp's last strip empty; with every mask
# (causal, window, a window that admits future keys, soft-cap), KV heads 1
# and 2, and views of a fused QKV tensor.
_F32_TC_SEQS = (1, 63, 64, 65, 127, 129, 196, 1000)
_F32_TC_MASKS = ((True, None, None), (False, None, None), (True, 100, None), (False, 50, None),
                 (True, None, 30.0), (False, 20, 50.0))
_F32_TC_CASES = [
    (2 if s < 1000 else 1, s, 4, (1, 2)[(i + hd // 64) % 2], hd,
     *_F32_TC_MASKS[(i + hd // 64) % len(_F32_TC_MASKS)], (i + hd // 64) % 3 == 0)
    for i, s in enumerate(_F32_TC_SEQS) for hd in (64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hkv,hd,causal,window,cap,fused", [
    (2, 200, 4, 2, 64, True, None, None, False),
    (1, 333, 4, 4, 128, True, 64, None, False),
    (1, 256, 2, 1, 256, True, 100, 50.0, False),
    (2, 130, 4, 4, 64, False, None, None, False),
    (1, 190, 4, 2, 128, False, 30, None, False),
    (1, 1, 2, 2, 64, True, None, None, False),
    (2, 196, 6, 6, 64, False, None, None, False),        # a ViT encoder block's attention
    (2, 600, 16, 16, 128, True, None, None, False),      # moonshot-v1-16b-a3b's heads, group 1
] + _F32_TC_CASES)
def test_cuda_flash_matches_plain(card, dtype, b, s, h, hkv, hd, causal, window, cap, fused):
    """The kernel of fwd_route's route against the plain version (f32 at
    2e-5, bf16 at 2e-2); in f32 also two calls bit-equal and the base-2
    log-sum-exp against ref.flash_attention_lse, which the f32 backward
    reads."""
    dt = _TORCH[dtype]
    if fused:
        qkv = torch.from_numpy(_normal((b, s, h + 2 * hkv, hd), 1)).to(card, dt)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
        assert not q.is_contiguous()
    else:
        q = torch.from_numpy(_normal((b, s, h, hd), 1)).to(card, dt)
        k = torch.from_numpy(_normal((b, s, hkv, hd), 2)).to(card, dt)
        v = torch.from_numpy(_normal((b, s, hkv, hd), 3)).to(card, dt)
    mask = dict(causal=causal, window=window, softcap=cap)
    route = tfk.fwd_route(hd, dt)[0]
    before = dict(tfk.fwd_routes)
    out, lse = tfk.flash_attention_cuda(q, k, v, lse=True, **mask)
    assert tfk.fwd_routes[route] == before[route] + 1
    rep = h // hkv
    exp, exp_lse = tref.flash_attention_lse(q, tops.repeat_kv(k, rep), tops.repeat_kv(v, rep),
                                            **mask)
    tol = 2e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
    if dtype == "float32":
        torch.testing.assert_close(lse, exp_lse, atol=tol, rtol=tol)
        again, lse_again = tfk.flash_attention_cuda(q, k, v, lse=True, **mask)
        assert torch.equal(again, out) and torch.equal(lse_again, lse)
        assert route == ("3xtf32" if hd in (64, 128) else "fma")


@pytest.mark.cuda
def test_cuda_flash_fwd_route_matches_the_kernel(card):
    """fwd_route against the C side's flash_attention_fwd_route, for every
    (dtype, head dim) either takes; both refuse the rest."""
    import ctypes
    lib = _build.load("flash_attention", tfk._SIGNATURES)
    codes = {torch.float32: 0, torch.bfloat16: 1}
    for dt, code in codes.items():
        for hd in (16, 32, 48, 64, 96, 128, 256):
            got = [ctypes.c_int() for _ in range(5)]
            rc = lib.flash_attention_fwd_route(code, hd, *(ctypes.byref(x) for x in got))
            try:
                want = tfk.fwd_route(hd, dt)
            except ValueError:
                assert rc == -1, (dt, hd)
                continue
            assert rc == 0
            assert (tfk.FWD_ROUTES[got[0].value], *(x.value for x in got[1:])) == want, (dt, hd)


@pytest.mark.cuda
def test_cuda_flash_tf32_launch_shares_rows_evenly(card):
    """The split-TF32 route's grid, from the C side's launcher: S's rows
    shared out over the fewest blocks of at most fwd_route's consumer warps,
    less than a warp's rows of padding a block; the ViT's S = 196 at hd 64
    is one block of 7 warps of 32 rows."""
    import ctypes
    lib = _build.load("flash_attention", tfk._SIGNATURES)
    blocks, warps = ctypes.c_int(), ctypes.c_int()
    for hd in tfk.TF32_HEAD_DIMS:
        _, bm, _, threads, _ = tfk.fwd_route(hd, torch.float32)
        consumers = threads // 32 - 1   # and a producer
        rows = bm // consumers
        for s in (1, 15, 16, 17, 63, 64, 65, 196, 1000, 4096):
            assert lib.flash_attention_tf32_launch(hd, s, ctypes.byref(blocks),
                                                   ctypes.byref(warps)) == 0
            assert 1 <= warps.value <= consumers, (hd, s)
            assert 0 <= blocks.value * warps.value * rows - s < rows * blocks.value, (hd, s)
            assert blocks.value == -(-s // (rows * consumers)), (hd, s)
    lib.flash_attention_tf32_launch(64, 196, ctypes.byref(blocks), ctypes.byref(warps))
    assert (blocks.value, warps.value) == (1, 7)
    assert lib.flash_attention_tf32_launch(256, 196, ctypes.byref(blocks),
                                           ctypes.byref(warps)) == -1


def _flash_check(q, k, v, causal, window, cap):
    out = tfk.flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=cap)
    rep = q.shape[2] // k.shape[2]
    exp = tref.flash_attention(q, tops.repeat_kv(k, rep), tops.repeat_kv(v, rep),
                               causal=causal, window=window, softcap=cap)
    assert out.dtype == q.dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), exp.float(), atol=2e-2, rtol=2e-2)


_FLASH_SEQS = (1, 63, 127, 129, 1000, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("s", _FLASH_SEQS)
def test_cuda_flash_bf16_sequence_edges(card, s, hd):
    """The wgmma kernel across ragged q and KV tiles (S around the 128-row q
    tile and the 64/128-key KV tile), GQA groups 1, 4 and 8 in turn."""
    rep = (1, 4, 8)[(_FLASH_SEQS.index(s) + hd // 64) % 3]
    hkv = 2 if s >= 1000 else 1
    q = torch.from_numpy(_normal((1, s, hkv * rep, hd), 21)).to(card, torch.bfloat16)
    k = torch.from_numpy(_normal((1, s, hkv, hd), 22)).to(card, torch.bfloat16)
    v = torch.from_numpy(_normal((1, s, hkv, hd), 23)).to(card, torch.bfloat16)
    _flash_check(q, k, v, True, None, None)


@pytest.mark.cuda
@pytest.mark.parametrize("s,hd,causal,window,cap", [
    (1000, 128, True, 100, None),      # window crossing tiles
    (4096, 256, True, 1024, 50.0),     # gemma2 local
    (129, 64, False, None, None),      # bidirectional
    (1000, 64, False, 100, 30.0),      # future keys admitted, softcap
    (127, 256, False, 0, None),        # window 0
    (63, 128, True, None, 50.0),
])
def test_cuda_flash_bf16_masks(card, s, hd, causal, window, cap):
    q = torch.from_numpy(_normal((2, s, 8, hd), 24)).to(card, torch.bfloat16)
    k = torch.from_numpy(_normal((2, s, 2, hd), 25)).to(card, torch.bfloat16)
    v = torch.from_numpy(_normal((2, s, 2, hd), 26)).to(card, torch.bfloat16)
    _flash_check(q, k, v, causal, window, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("s,hd", [(129, 128), (1000, 64), (300, 256)])
def test_cuda_flash_bf16_strided_views_of_fused_qkv(card, s, hd):
    """q, k and v as views of one (B, S, H + 2 Hkv, hd) tensor: the tensor
    maps take the fused tensor's strides."""
    h, hkv = 8, 2
    qkv = torch.from_numpy(_normal((2, s, h + 2 * hkv, hd), 27)).to(card, torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
    assert not q.is_contiguous()
    _flash_check(q, k, v, True, None, None)
    _flash_check(q, k, v, False, 50, None)


@pytest.mark.cuda
def test_cuda_flash_tile_config_matches_the_kernel(card):
    import ctypes
    lib = _build.load("flash_attention", tfk._SIGNATURES)
    for hd in tfk.HEAD_DIMS:
        got = [ctypes.c_int() for _ in range(4)]
        assert lib.flash_attention_tile(hd, *(ctypes.byref(x) for x in got)) == 0
        assert tuple(x.value for x in got) == tfk.tile_config(hd)


@pytest.mark.cuda
def test_cuda_flash_refuses_grad_and_counts_launches(card):
    """The forward wrapper alone refuses an input that requires grad (it
    records no graph); ops.flash_attention takes it through FlashAttentionFn,
    one forward and one backward launch; under no_grad the forward runs."""
    q = torch.zeros(1, 64, 2, 64, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        tfk.flash_attention_cuda(q, q, q)
    tops.reset_launch_counts()
    tops.flash_attention(q, q, q).sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    # Under no_grad nothing is recorded, so the kernel runs.
    with torch.no_grad():
        tops.flash_attention(q, q, q)
        tops.dequantize_int8(*tops.quantize_int8(q[0]), dtype=torch.float32)
    assert tops.launch_counts() == {"flash_attention": 2, "flash_attention_bwd": 1,
                                    "quantize_int8": 1, "dequantize_int8": 1,
                                    "decode_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}


# b, s, h, hkv, hd, causal, window, softcap: GQA groups of 4 (mistral), a window
# with a soft-cap (gemma2), head dim 16 (the smoke configs), S off every tile.
FLASH_BWD_CASES = [
    (2, 300, 8, 2, 128, True, None, None),
    (1, 1000, 8, 2, 128, True, 100, 50.0),
    (2, 129, 4, 4, 64, True, None, None),
    (1, 77, 4, 1, 64, False, None, None),
    (1, 190, 4, 2, 64, False, 30, 30.0),
    (1, 333, 4, 2, 256, True, 64, 50.0),
    (1, 200, 2, 1, 256, False, None, None),
    (1, 1, 2, 2, 64, True, None, None),
    (1, 127, 2, 2, 128, True, 0, None),
]
FLASH_BWD_F32_CASES = [
    (4, 32, 4, 2, 16, True, None, None),       # the smoke configs' attention
    (4, 300, 4, 2, 16, True, 16, 50.0),        # gemma2 smoke, local
    (2, 257, 8, 2, 32, True, None, None),
    (1, 190, 4, 4, 32, False, 30, None),
    (2, 100, 4, 1, 64, True, None, 30.0),
    (1, 129, 2, 2, 128, False, None, None),
    (1, 70, 4, 2, 256, True, 20, None),
]


def _flash_bwd_check(card, dt, b, s, h, hkv, hd, causal, window, cap):
    tol = 2e-5 if dt == torch.float32 else 2e-2
    q = torch.from_numpy(_normal((b, s, h, hd), 31)).to(card, dt)
    k = torch.from_numpy(_normal((b, s, hkv, hd), 32)).to(card, dt)
    v = torch.from_numpy(_normal((b, s, hkv, hd), 33)).to(card, dt)
    do = torch.from_numpy(_normal((b, s, h, hd), 34)).to(card, dt)
    rep = h // hkv
    out, lse = tfk.flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=cap,
                                        lse=True)
    exp, exp_lse = tref.flash_attention_lse(q, tops.repeat_kv(k, rep), tops.repeat_kv(v, rep),
                                            causal=causal, window=window, softcap=cap)
    torch.testing.assert_close(lse, exp_lse, atol=tol, rtol=tol)
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)
    grads = tfk.flash_attention_bwd_cuda(q, k, v, out, lse, do, causal=causal, window=window,
                                         softcap=cap)
    want = tref.flash_attention_bwd(q, k, v, do, causal=causal, window=window, softcap=cap)
    for name, got, exp_g in zip(("dq", "dk", "dv"), grads, want):
        assert got.dtype == dt and got.shape == exp_g.shape, name
        torch.testing.assert_close(got.float(), exp_g.float(), atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,hd,causal,window,cap", FLASH_BWD_CASES)
def test_cuda_flash_bwd_bf16_matches_plain(card, b, s, h, hkv, hd, causal, window, cap):
    _flash_bwd_check(card, torch.bfloat16, b, s, h, hkv, hd, causal, window, cap)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,hd,causal,window,cap", FLASH_BWD_F32_CASES)
def test_cuda_flash_bwd_f32_matches_plain(card, b, s, h, hkv, hd, causal, window, cap):
    _flash_bwd_check(card, torch.float32, b, s, h, hkv, hd, causal, window, cap)


def _flash_bwd_inputs(card, b, s, h, hkv, hd, causal, window, cap, seed=41):
    q = torch.from_numpy(_normal((b, s, h, hd), seed)).to(card, torch.bfloat16)
    k = torch.from_numpy(_normal((b, s, hkv, hd), seed + 1)).to(card, torch.bfloat16)
    v = torch.from_numpy(_normal((b, s, hkv, hd), seed + 2)).to(card, torch.bfloat16)
    do = torch.from_numpy(_normal((b, s, h, hd), seed + 3)).to(card, torch.bfloat16)
    out, lse = tfk.flash_attention_cuda(q, k, v, causal=causal, window=window, softcap=cap,
                                        lse=True)
    return q, k, v, out, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,hkv,hd,causal,window,cap", FLASH_BWD_CASES)
def test_cuda_flash_bwd_bf16_calls_are_bit_equal(card, b, s, h, hkv, hd, causal, window, cap):
    """No atomics: each kernel owns its output, so two calls give the same
    bits on every route."""
    q, k, v, out, lse, do = _flash_bwd_inputs(card, b, s, h, hkv, hd, causal, window, cap)
    mask = dict(causal=causal, window=window, softcap=cap)
    first = tfk.flash_attention_bwd_cuda(q, k, v, out, lse, do, **mask)
    second = tfk.flash_attention_bwd_cuda(q, k, v, out, lse, do, **mask)
    for name, a, c in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, c), name


@pytest.mark.cuda
def test_cuda_flash_bwd_tile_config_matches_the_kernel(card):
    import ctypes
    lib = _build.load("flash_attention_bwd", tfk._BWD_SIGNATURES)
    takes = ([(torch.bfloat16, 1, hd) for hd in tfk.HEAD_DIMS]
             + [(torch.float32, 0, hd) for hd in tfk.F32_HEAD_DIMS])
    for dtype, code, hd in takes:
        got = (ctypes.c_int * 11)()
        assert lib.flash_attention_bwd_tile(code, hd, got) == 0
        route, dkdv, dq = tfk.bwd_tile_config(hd, dtype)
        assert list(got) == [tfk.BWD_ROUTES.index(route), *dkdv, *dq], (dtype, hd)
    got = (ctypes.c_int * 11)()
    assert lib.flash_attention_bwd_tile(1, 96, got) == -1
    assert lib.flash_attention_bwd_tile(0, 48, got) == -1


@pytest.mark.cuda
def test_cuda_flash_bwd_takes_a_view_off_16_bytes(card):
    """The wgmma route's TMA needs 16-byte aligned tensors: a packed view
    that starts 2 bytes into its storage gives the bits of an aligned copy."""
    b, s, h, hkv, hd = 1, 200, 4, 2, 128
    q, k, v, out, lse, do = _flash_bwd_inputs(card, b, s, h, hkv, hd, True, None, None)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
    q_off = flat[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 != 0 and q_off.is_contiguous()
    want = tfk.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    got = tfk.flash_attention_bwd_cuda(q_off, k, v, out, lse, do)
    for name, a, c in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(a, c), name


@pytest.mark.cuda
def test_cuda_flash_fn_under_autograd_and_remat(card):
    """FlashAttentionFn's gradients on strided views of a fused QKV tensor
    equal the backward kernel's on packed copies, also when the attention is
    rematerialised by torch.utils.checkpoint (the forward runs twice)."""
    h, hkv, hd, s = 8, 2, 128, 300
    qkv = torch.from_numpy(_normal((2, s, h + 2 * hkv, hd), 35)).to(card, torch.bfloat16)
    do = torch.from_numpy(_normal((2, s, h, hd), 36)).to(card, torch.bfloat16)
    results = []
    for remat in (False, True):
        leaf = qkv.clone().requires_grad_()
        q, k, v = leaf[:, :, :h], leaf[:, :, h:h + hkv], leaf[:, :, h + hkv:]
        tops.reset_launch_counts()
        if remat:
            out = torch.utils.checkpoint.checkpoint(tops.flash_attention, q, k, v,
                                                    use_reentrant=False)
        else:
            out = tops.flash_attention(q, k, v)
        out.backward(do)
        counts = tops.launch_counts()
        assert counts["flash_attention"] == (2 if remat else 1)
        assert counts["flash_attention_bwd"] == 1
        results.append(leaf.grad)
    assert torch.equal(results[0], results[1])
    q, k, v = (t.contiguous() for t in (qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]))
    out, lse = tfk.flash_attention_cuda(q, k, v, lse=True)
    want = tfk.flash_attention_bwd_cuda(q, k, v, out, lse, do)
    assert torch.equal(results[0], torch.cat(want, dim=2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,hd,length,window,cap", [
    (2, 1024, 8, 2, 64, 700, None, None),      # tests/test_kernels.py's cases
    (1, 512, 4, 4, 128, 512, None, None),
    (2, 768, 16, 8, 64, 100, None, None),
    (1, 300, 8, 8, 64, 300, None, None),
    (3, 64, 4, 2, 128, 1, None, None),         # one live key
    (2, 200, 8, 1, 256, 77, None, 50.0),       # MQA, hd 256, softcap
    (1, 4096, 16, 8, 256, 3000, 1024, 50.0),   # gemma2 local layer
    (4, 544, 32, 8, 128, 544, None, None),     # the serving path's shape
    (4, 544, 16, 16, 128, 544, None, None),    # moonshot-v1-16b-a3b's decode, group 1
    (2, 100, 4, 4, 64, 90, 0, None),           # window 0: the newest key alone
])
def test_cuda_decode_attention_matches_plain(card, dtype, b, s, hq, hkv, hd, length,
                                             window, cap):
    dt = _TORCH[dtype]
    q = torch.from_numpy(_normal((b, hq, hd), 1)).to(card, dt)
    k = torch.from_numpy(_normal((b, s, hkv, hd), 2)).to(card, dt)
    v = torch.from_numpy(_normal((b, s, hkv, hd), 3)).to(card, dt)
    out = tdk.decode_attention_cuda(q, k, v, length, window=window, softcap=cap)
    exp = tref.decode_attention(q, k, v, length, window=window, softcap=cap)
    assert out.dtype == dt and out.shape == (b, hq, hd)
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,hd", [("float32", 16), ("float32", 32), ("bfloat16", 16)])
@pytest.mark.parametrize("rep", [1, 2, 4, 6, 8])
@pytest.mark.parametrize("b,s,hkv,length,window,cap", [
    (2, 100, 2, 37, None, None),        # one split
    (1, 700, 2, 650, 300, 30.0),        # splits combined in a cluster, window, softcap
    (1, 20000, 1, 19000, None, None),   # long splits: scratch and counters
])
def test_cuda_decode_small_head_dims_and_group_6(card, dtype, hd, rep, b, s, hkv, length,
                                                 window, cap):
    """Head dims 16 and 32 (half a warp idle in the f32 kernel's P.V at 16)
    with every group size, 6 among them, and both combines; bf16 caches at
    16 only (no config decodes one at 32)."""
    dt = _TORCH[dtype]
    q = torch.from_numpy(_normal((b, hkv * rep, hd), 7)).to(card, dt)
    k = torch.from_numpy(_normal((b, s, hkv, hd), 8)).to(card, dt)
    v = torch.from_numpy(_normal((b, s, hkv, hd), 9)).to(card, dt)
    out = tdk.decode_attention_cuda(q, k, v, length, window=window, softcap=cap)
    exp = tref.decode_attention(q, k, v, length, window=window, softcap=cap)
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(out.float(), exp.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,length", [(128, 544), (128, 32768), (64, 100), (256, 3000)])
def test_cuda_decode_bf16_group_6(card, hd, length):
    """grok-1's group of 48 query heads on 8: rows 6 and 7 of the mma tile
    are padding and are never written out."""
    b, s = 2, max(length, 64)
    q = torch.from_numpy(_normal((b, 48, hd), 10)).to(card, torch.bfloat16)
    k = torch.from_numpy(_normal((b, s, 8, hd), 11)).to(card, torch.bfloat16)
    v = torch.from_numpy(_normal((b, s, 8, hd), 12)).to(card, torch.bfloat16)
    out = tdk.decode_attention_cuda(q, k, v, length)
    exp = tref.decode_attention(q, k, v, length)
    assert out.shape == (b, 48, hd)
    torch.testing.assert_close(out.float(), exp.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(4, 2), (4, 4)])
def test_cuda_decode_f32_query_on_bf16_cache_small_head_dims(card, hq, hkv):
    """The smoke models' decode: an f32 q (split into two bf16 parts) against
    the bf16 cache at hd 16, groups 2 and 1."""
    q = torch.from_numpy(_normal((4, hq, 16), 13)).to(card)
    k = torch.from_numpy(_normal((4, 48, hkv, 16), 14)).to(card, torch.bfloat16)
    v = torch.from_numpy(_normal((4, 48, hkv, 16), 15)).to(card, torch.bfloat16)
    for length in (1, 17, 48):
        out = tops.decode_attention(q, k, v, length)
        exp = tref.decode_attention(q, k, v, length)
        torch.testing.assert_close(out.float(), exp.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 300])
def test_cuda_decode_consecutive_calls_and_graph_replay(card, window):
    """Calls at lengths 1, 33, 544 and 32,768 one after another: one split,
    splits combined in a cluster, and at 32,768 splits combined through the
    scratch and its counters. Then 5 calls captured in one CUDA graph and
    replayed twice give the eager results, so every call leaves the counters
    at 0."""
    b, s, hq, hkv, hd = 4, 32768, 32, 8, 128
    q = torch.from_numpy(_normal((b, hq, hd), 31)).to(card, torch.bfloat16)
    k = torch.from_numpy(_normal((b, s, hkv, hd), 32)).to(card, torch.bfloat16)
    v = torch.from_numpy(_normal((b, s, hkv, hd), 33)).to(card, torch.bfloat16)
    lengths = (1, 33, 544, 32768)
    for length in lengths + lengths:
        out = tdk.decode_attention_cuda(q, k, v, length, window=window)
        exp = tref.decode_attention(q, k, v, length, window=window)
        torch.testing.assert_close(out.float(), exp.float(), atol=3e-2, rtol=3e-2)
    torch.cuda.synchronize()
    captured = (1, 33, 544, 32768, 544)
    eager = [tdk.decode_attention_cuda(q, k, v, n, window=window) for n in captured]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [tdk.decode_attention_cuda(q, k, v, n, window=window) for n in captured]
    for _ in range(2):
        for o in outs:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, eager):
            torch.testing.assert_close(got.float(), want.float(), atol=1e-6, rtol=0)


@pytest.mark.cuda
def test_cuda_decode_attention_f32_query_on_bf16_cache(card):
    """An f32 model decodes against the bf16 cache: q is read as f32."""
    q = torch.from_numpy(_normal((2, 8, 128), 4)).to(card)
    k = torch.from_numpy(_normal((2, 96, 2, 128), 5)).to(card, torch.bfloat16)
    v = torch.from_numpy(_normal((2, 96, 2, 128), 6)).to(card, torch.bfloat16)
    out = tops.decode_attention(q, k, v, 70)
    exp = tref.decode_attention(q, k, v, 70)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), exp.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 512, 8, 64, 128, 128),     # tests/test_kernels.py's cases
    (1, 256, 4, 32, 64, 64),
    (1, 256, 4, 32, 16, 128),
    (2, 128, 8, 64, 128, 128),
    (1, 512, 4, 64, 128, 256),     # mamba2's chunk
    (2, 48, 3, 16, 16, 16),        # the smoke model's shape
    (4, 512, 128, 64, 16, 256),    # jamba-v0.1-52b's prefill: 128 heads, N 16
])
def test_cuda_ssd_scan_matches_plain(card, dtype, b, s, h, p, n, chunk):
    dt = _TORCH[dtype]
    rng = np.random.default_rng(9)
    x = torch.from_numpy(_normal((b, s, h, p), 10)).to(card, dt)
    dts = torch.nn.functional.softplus(torch.from_numpy(_normal((b, s, h), 11))).to(card)
    a = -torch.exp(torch.from_numpy(rng.standard_normal(h).astype(np.float32)) * 0.3).to(card)
    B_ = torch.from_numpy(_normal((b, s, n), 12, 0.3)).to(card, dt)
    C_ = torch.from_numpy(_normal((b, s, n), 13, 0.3)).to(card, dt)
    y, st = tsk.ssd_scan_cuda(x, dts * a, dts, B_, C_, chunk=chunk)
    ye, ste = tref.ssd_chunked(x, dts * a, dts, B_, C_, chunk=chunk)
    assert y.dtype == torch.float32 and st.dtype == torch.float32
    torch.testing.assert_close(y, ye, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(st, ste, atol=2e-3, rtol=2e-3)


def _ssd_case(card, dt, b, s, h, p, n, a_log, dta_scale=1.0):
    """Inputs made with numpy from fixed seeds; the decay rate is
    ``-exp(a_log)`` per head, so ``a_log`` -4 decays slowly."""
    x = torch.from_numpy(_normal((b, s, h, p), 20)).to(card, dt)
    dts = torch.nn.functional.softplus(torch.from_numpy(_normal((b, s, h), 21))).to(card)
    a = -torch.exp(torch.from_numpy(np.asarray(a_log, np.float32)
                                    + _normal((h,), 22, 0.1))).to(card)
    B_ = torch.from_numpy(_normal((b, s, n), 23, 0.3)).to(card, dt)
    C_ = torch.from_numpy(_normal((b, s, n), 24, 0.3)).to(card, dt)
    return x, dts * a * dta_scale, dts, B_, C_


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("what,b,s,h,p,n,chunk,a_log,dta_scale", [
    # exp(-4): the decay carries across a whole chunk and y grows well above
    # 1, so a G' or state rounded to one bf16 would miss the tolerance.
    ("slow decay", 2, 512, 4, 64, 128, 256, -4.0, 1.0),
    ("slow decay, 3 chunks", 1, 768, 2, 64, 128, 256, -4.0, 1.0),
    # dtA x 200: exp(cum_i - cum_j) above the diagonal overflows to inf.
    ("overflow", 1, 128, 2, 32, 64, 64, 0.0, 200.0),
    ("overflow, 4 chunks", 1, 256, 3, 64, 128, 64, 0.0, 200.0),
    # The state carried through registers three times.
    ("4 chunks", 2, 512, 3, 32, 64, 128, 0.0, 1.0),
    ("8 chunks, N 16", 1, 128, 4, 16, 16, 16, -2.0, 1.0),
    ("smoke shape, H 3", 2, 48, 3, 16, 16, 16, 0.0, 1.0),
    ("P 48, N 48, chunk 48", 1, 144, 2, 48, 48, 48, -1.0, 1.0),
])
def test_cuda_ssd_scan_hard_cases(card, dtype, what, b, s, h, p, n, chunk, a_log, dta_scale):
    args = _ssd_case(card, _TORCH[dtype], b, s, h, p, n, a_log, dta_scale)
    y, st = tsk.ssd_scan_cuda(*args, chunk=chunk)
    ye, ste = tref.ssd_chunked(*args, chunk=chunk)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    if what.startswith("slow decay"):
        assert float(ye.abs().max()) > 10.0
    torch.testing.assert_close(y, ye, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(st, ste, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(8, 256), (100, 256), (250, 256), (64, 8), (96, 24)])
def test_cuda_ssd_scan_chunks_off_16(card, dtype, s, chunk):
    """Short prompts (one chunk of 8, 100 or 250 steps) and small chunks: the
    bf16 wrapper pads each chunk with zero steps to a multiple of 16."""
    args = _ssd_case(card, _TORCH[dtype], 2, s, 4, 64, 128, -1.0)
    tsk.launches = 0
    y, st = tsk.ssd_scan_cuda(*args, chunk=chunk)
    ye, ste = tref.ssd_chunked(*args, chunk=chunk)
    assert tsk.launches == 1 and y.shape == (2, s, 4, 64)
    torch.testing.assert_close(y, ye, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(st, ste, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
def test_cuda_ssd_launch_config_matches_the_kernel(card):
    import ctypes
    lib = _build.load("ssd_scan", tsk._SIGNATURES)
    for b, h, p, n, q in [(4, 64, 64, 128, 256), (2, 3, 16, 16, 16), (1, 4, 32, 64, 64),
                          (2, 8, 48, 128, 128), (1, 2, 64, 16, 4096)]:
        grid = (ctypes.c_int * 3)()
        threads, smem = ctypes.c_int(), ctypes.c_int()
        assert lib.ssd_scan_launch(b, h, n, p, q, grid, ctypes.byref(threads),
                                   ctypes.byref(smem)) == 0
        assert ((tuple(grid), threads.value, smem.value)
                == tsk.launch_config(b, h, p, n, q))
    for b, h, p, n, q in [(1, 1, 64, 120, 64), (1, 1, 40, 64, 64), (1, 1, 64, 64, 40),
                          (1, 1, 80, 64, 64), (1, 1, 64, 144, 64), (1, 1, 64, 128, 16384)]:
        grid = (ctypes.c_int * 3)()
        threads, smem = ctypes.c_int(), ctypes.c_int()
        assert lib.ssd_scan_launch(b, h, n, p, q, grid, ctypes.byref(threads),
                                   ctypes.byref(smem)) != 0
        with pytest.raises(ValueError):
            tsk.launch_config(b, h, p, n, q)


@pytest.mark.cuda
def test_cuda_ssd_f32_takes_multiples_of_4_where_bf16_refuses(card):
    """Head dim 24 and chunk 40: the bf16 kernel raises, the f32 kernel runs."""
    x, dta, dts, B_, C_ = _ssd_case(card, torch.float32, 1, 80, 2, 24, 16, 0.0)
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="multiples of 16"):
        tsk.ssd_scan_cuda(x.to(bf), dta, dts, B_.to(bf), C_.to(bf), chunk=40)
    y, st = tsk.ssd_scan_cuda(x, dta, dts, B_, C_, chunk=40)
    ye, ste = tref.ssd_chunked(x, dta, dts, B_, C_, chunk=40)
    torch.testing.assert_close(y, ye, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(st, ste, atol=2e-3, rtol=2e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_scan_takes_unaligned_views(card, dtype):
    """Views that start 2 elements into their storage: the kernels copy 16
    bytes at a time, so the wrapper hands them aligned copies."""
    args = _ssd_case(card, _TORCH[dtype], 1, 128, 2, 32, 64, -1.0)
    views = []
    for t in args:
        flat = torch.empty(t.numel() + 2, dtype=t.dtype, device=card)
        flat[2:] = t.reshape(-1)
        views.append(flat[2:].view(t.shape))
    assert views[0].data_ptr() % 16
    y, st = tsk.ssd_scan_cuda(*views, chunk=64)
    ye, ste = tref.ssd_chunked(*args, chunk=64)
    torch.testing.assert_close(y, ye, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(st, ste, atol=2e-3, rtol=2e-3)


def _rel(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm())


# The backward against ref.ssd_chunked_bwd, per gradient, relative L2: f32 to
# 1e-5 (f32 FMA on both sides, another summation order); bf16 to 1e-2 (the
# tensor-core route splits every f32 operand into two bf16 halves, about 16
# bits, and dx, dB and dC are rounded to bf16 on both sides: observed up to
# about 2e-4).
SSD_BWD_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
SSD_BWD_CASES = [
    # what, b, s, h, p, n, chunk, a_log, dstate
    ("smoke shape", 4, 32, 8, 16, 16, 16, 0.0, False),
    ("3 chunks", 2, 192, 3, 64, 128, 64, 0.0, True),
    ("slow decay", 1, 768, 2, 64, 128, 256, -4.0, False),
    ("S 100, chunk 256", 2, 100, 4, 64, 128, 256, -1.0, True),
    ("tile tails: chunk 100", 1, 300, 2, 48, 80, 100, -1.0, True),
    ("N 16, P 16, chunk 8", 2, 64, 3, 16, 16, 8, -2.0, False),
]


def _ssd_bwd_args(card, dt, b, s, h, p, n, a_log, dstate):
    args = _ssd_case(card, dt, b, s, h, p, n, a_log)
    dy = torch.from_numpy(_normal((b, s, h, p), 25)).to(card)
    ds = torch.from_numpy(_normal((b, h, n, p), 26)).to(card) if dstate else None
    return args, dy, ds


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("what,b,s,h,p,n,chunk,a_log,dstate", SSD_BWD_CASES)
def test_cuda_ssd_bwd_matches_plain(card, dtype, what, b, s, h, p, n, chunk, a_log, dstate):
    """The forward's states and the backward's five gradients against the
    plain versions; two calls give the same bits."""
    args, dy, ds = _ssd_bwd_args(card, _TORCH[dtype], b, s, h, p, n, a_log, dstate)
    y0, st0 = tsk.ssd_scan_cuda(*args, chunk=chunk)
    y, st, states = tsk.ssd_scan_cuda(*args, chunk=chunk, states=True)
    assert torch.equal(y, y0) and torch.equal(st, st0)
    _, _, want_states = tref.ssd_chunked(*args, chunk=chunk, states=True)
    assert states.shape == (b, s // min(chunk, s), h, n, p)
    torch.testing.assert_close(states, want_states, atol=2e-3, rtol=2e-3)
    tsk.bwd_launches = 0
    grads = tsk.ssd_scan_bwd_cuda(*args, states, dy, ds, chunk=chunk)
    assert tsk.bwd_launches == 1
    want = tref.ssd_chunked_bwd(*args, dy, ds, chunk=chunk, states=states)
    for name, got, exp, like in zip(("dx", "ddtA", "ddt", "dB", "dC"), grads, want, args):
        assert got.dtype == like.dtype and got.shape == like.shape, name
        assert torch.isfinite(got).all(), name
        assert _rel(got, exp) <= SSD_BWD_TOL[dtype], (name, _rel(got, exp))
    again = tsk.ssd_scan_bwd_cuda(*args, states, dy, ds, chunk=chunk)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))


@pytest.mark.cuda
def test_cuda_ssd_bwd_launch_config_matches_the_kernel(card):
    """Every launch the C side reports for a call, in order, is the one
    bwd_launch_config gives, on both routes (the tensor-core route at the
    chunk padded to tiles of 64); a launch past the last and a shape neither
    route takes are refused on both sides."""
    import ctypes

    def launch(code, k, b, s, h, n, p, q):
        grid = (ctypes.c_int * 3)()
        threads, smem = ctypes.c_int(), ctypes.c_int()
        rc = lib.ssd_scan_bwd_launch(code, k, b, s, h, n, p, q, grid, ctypes.byref(threads),
                                     ctypes.byref(smem))
        return rc, (tuple(grid), threads.value, smem.value)

    lib = _build.load("ssd_scan_bwd", tsk._BWD_SIGNATURES)
    for b, h, p, n, q, s in [(2, 64, 64, 128, 256, 4096), (4, 8, 16, 16, 16, 32),
                             (1, 3, 48, 80, 100, 300), (1, 2, 64, 128, 640, 640),
                             (2, 1, 1, 1, 1, 1)]:
        for dtype, code in ((torch.bfloat16, 1), (torch.float32, 0)):
            cfg = tsk.bwd_launch_config(b, h, p, n, q, s=s, dtype=dtype)
            qk = tsk.padded_chunk(q, tsk.BWD_TILE) if tsk.bwd_route(dtype, n, p, q) == "mma" \
                else q
            sk = s // q * qk
            for k, want in enumerate(cfg.values()):
                assert launch(code, k, b, sk, h, n, p, qk) == (0, want), (b, h, p, n, q, k)
            assert launch(code, len(cfg), b, sk, h, n, p, qk)[0] != 0
    for b, h, p, n, q in [(1, 1, 80, 64, 64), (1, 1, 64, 144, 64), (1, 1, 64, 128, 2000),
                          (1, 1, 0, 64, 64), (1, 1, 64, 0, 64)]:
        for code in (0, 1):
            assert launch(code, 0, b, q, h, n, p, q)[0] != 0
        with pytest.raises(ValueError):
            tsk.bwd_launch_config(b, h, p, n, q)


@pytest.mark.cuda
@pytest.mark.parametrize("what,b,s,h,p,n,chunk,a_log,dstate", [
    c for c in SSD_BWD_CASES if c[4] % 16 == 0 and c[5] % 16 == 0])
def test_cuda_ssd_bwd_chunk_dstates_match_plain(card, what, b, s, h, p, n, chunk, a_log, dstate):
    """The tensor-core backward's first two launches alone: the gradient of
    the state leaving each chunk against ref.ssd_chunked_bwd's plain version
    ref.ssd_bwd_chunk_dstates (f32 on both sides; the kernel splits C^T dy's
    f32 operand hi/lo) to 1e-5 relative L2; two calls give the same bits."""
    args, dy, ds = _ssd_bwd_args(card, torch.bfloat16, b, s, h, p, n, a_log, dstate)
    x, dtA, dt, B_, C_ = args
    got = tsk.ssd_bwd_chunk_dstates_cuda(dtA, C_, dy, ds, chunk=chunk)
    want = tref.ssd_bwd_chunk_dstates(x, dtA, dt, B_, C_, dy, ds, chunk=chunk)
    assert got.shape == want.shape == (b, s // min(chunk, s), h, n, p)
    if want.any():
        assert _rel(got, want) <= 1e-5, _rel(got, want)
    else:
        assert not got.any()
    assert torch.equal(got, tsk.ssd_bwd_chunk_dstates_cuda(dtA, C_, dy, ds, chunk=chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_fn_under_autograd_and_remat(card, dtype):
    """ops.ssd_scan under autograd goes through SSDScanFn: one forward and one
    backward launch, the same gradients as the backward wrapper's; under
    torch.utils.checkpoint the forward runs twice and the gradients are the
    same bits; a loss on the final state alone reaches the inputs too."""
    args, dy, ds = _ssd_bwd_args(card, _TORCH[dtype], 2, 192, 4, 64, 128, -1.0, True)
    results = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in args]
        tops.reset_launch_counts()
        if remat:
            y, st = torch.utils.checkpoint.checkpoint(
                lambda *a: tops.ssd_scan(*a, chunk=64), *leaves, use_reentrant=False)
        else:
            y, st = tops.ssd_scan(*leaves, chunk=64)
        torch.autograd.backward((y, st), (dy, ds))
        counts = tops.launch_counts()
        assert (counts["ssd_scan"], counts["ssd_scan_bwd"]) == (2 if remat else 1, 1)
        results.append([t.grad for t in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*results))
    _, _, states = tsk.ssd_scan_cuda(*args, chunk=64, states=True)
    want = tsk.ssd_scan_bwd_cuda(*args, states, dy, ds, chunk=64)
    assert all(torch.equal(a, b) for a, b in zip(results[0], want))
    leaves = [t.clone().requires_grad_() for t in args]
    _, st = tops.ssd_scan(*leaves, chunk=64)
    (st * ds).sum().backward()
    want = tsk.ssd_scan_bwd_cuda(*args, states, torch.zeros_like(dy), ds, chunk=64)
    assert all(torch.equal(t.grad, w) for t, w in zip(leaves, want))


@pytest.mark.cuda
def test_cuda_serving_kernels_count_launches_and_refuse_bad_input(card):
    tops.reset_launch_counts()
    q = torch.zeros(1, 4, 64, device=card)
    kv = torch.zeros(1, 32, 2, 64, device=card)
    tops.decode_attention(q, kv, kv, 5)
    x = torch.zeros(1, 32, 2, 16, device=card)
    bc = torch.zeros(1, 32, 16, device=card)
    dts = torch.zeros(1, 32, 2, device=card)
    tops.ssd_scan(x, dts, dts, bc, bc, chunk=16)
    counts = tops.launch_counts()
    assert (counts["decode_attention"], counts["ssd_scan"]) == (1, 1)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tops.ssd_scan(x[:, :30], dts[:, :30], dts[:, :30], bc[:, :30], bc[:, :30], chunk=16)
    with pytest.raises(ValueError, match="length"):
        tops.decode_attention(q, kv, kv, 33)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 27, 27, 64), (3, 14, 14, 192), (2, 196, 384),
                                   (5, 25088)])
def test_cuda_int8_vision_boundaries_f32_bit_exact(card, shape):
    """The vision executor's boundaries: float32, tiles of 64 (AlexNet's split
    3) and 128."""
    x = torch.from_numpy(_normal(shape, 61, 2.0)).to(card)
    q, s = tik.quantize_int8_cuda(x)
    qe, se = tref.quantize_int8(x)
    assert s.shape[-1] == shape[-1] // math.gcd(shape[-1], 128)
    assert torch.equal(q, qe) and torch.equal(s, se)


@pytest.mark.cuda
@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("name,split", [("alexnet", 3), ("transformer", 11)])
def test_cuda_vision_executor_matches_the_cpu_port(card, name, split, compress):
    """The executor on the card against the port's plain path on the CPU, the
    same seeded weights: float32 acts to 1e-4 relative L2 (cuDNN's TF32 off;
    only the sums' order differs), int8 codes within one step. 5 images in
    microbatches of 2: 3 quantize launches, and 10 flash launches each for
    the ViT's blocks before split 11."""
    gpu = tv.PAPER_MODELS[name](device="cuda", generator=torch.Generator().manual_seed(0))
    cpu = tv.PAPER_MODELS[name](device="cpu", generator=torch.Generator().manual_seed(0))
    x = _normal((5, 224, 224, 3), 51)
    tops.reset_launch_counts()
    got = make_vision_executor(gpu, compress=compress)({"x": x}, split, 2)
    counts = tops.launch_counts()
    want = make_vision_executor(cpu, compress=compress, device="cpu")({"x": x}, split, 2)
    assert counts["quantize_int8"] == (3 if compress else 0)
    assert counts["flash_attention"] == (30 if name == "transformer" else 0)
    if compress:
        (q, s), (qe, se) = got, want
        assert q.dtype == np.int8 and s.dtype == np.float32 and q.shape == qe.shape
        assert np.abs(q.astype(np.int32) - qe.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(s, se, rtol=1e-4, atol=0)
    else:
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)


def _drain_through_executor(name, split, x, device):
    """The port's HapiServer (one accelerator) draining two POSTs of 4 images
    each through make_vision_executor on ``device``."""
    vm = tv.PAPER_MODELS[name](device=device, generator=torch.Generator().manual_seed(0))
    store = ObjectStore()
    store.put_dataset("live", {"x": x}, object_size=4)
    server = HapiServer(store, n_accelerators=1)
    server.register_executor(name, make_vision_executor(vm, compress=True, device=device))
    prof = profile_layered(vm)
    for i, oname in enumerate(store.object_names("live")):
        server.submit(PostRequest(i, 0, name, split, oname, 4, prof, 0.0, compress=True))
    return server.drain()


@pytest.mark.cuda
@pytest.mark.parametrize("name,split", [("alexnet", 3), ("transformer", 11)])
def test_cuda_hapi_server_drains_through_the_executor(card, name, split):
    """Two POSTs through the executor on the card, against the same drain on
    the CPU: codes within one step, scales to 1e-4, and the same requests,
    COS batches, measured wire bytes and virtual times."""
    x = _normal((8, 224, 224, 3), 52)
    tops.reset_launch_counts()
    got = _drain_through_executor(name, split, x, "cuda")
    assert tops.launch_counts()["quantize_int8"] == 2
    want = _drain_through_executor(name, split, x, "cpu")
    assert len(got) == len(want) == 2
    for r, w in zip(got, want):
        assert (r.req_id, r.object_name, r.cos_batch, r.act_bytes, r.started, r.finished) == \
            (w.req_id, w.object_name, w.cos_batch, w.act_bytes, w.started, w.finished)
        (q, s), (qe, se) = r.acts, w.acts
        assert q.dtype == np.int8 and q.shape == qe.shape
        assert np.abs(q.astype(np.int32) - qe.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(s, se, rtol=1e-4, atol=0)


def _cluster_through_executors(x, device):
    """The port's HapiCluster, two replicas of one accelerator each on one
    1 Gbps trunk, draining two tenants' bursts (AlexNet and the ViT, two
    objects of 4 images each) through make_vision_executor on ``device``."""
    from repro_torch.api import HapiCluster, NetworkSpec
    from repro_torch.config import HapiConfig

    c = (HapiCluster(seed=0).with_servers(2, n_accelerators=1)
         .with_network(NetworkSpec(trunk_bandwidth=1e9 / 8))
         .with_dataset("live", {"x": x}, object_size=4))
    for name in ("alexnet", "transformer"):
        vm = tv.PAPER_MODELS[name](device=device, generator=torch.Generator().manual_seed(0))
        c.with_executor(name, make_vision_executor(vm, compress=True, device=device))
    hapi = HapiConfig(compress_transfer=True)
    # The ViT at the paper's split (11, as Alg. 1 picks at a train batch of
    # 2,000), so its prefix holds encoder blocks; AlexNet at Alg. 1's.
    for t, (name, split) in enumerate((("alexnet", None), ("transformer", 11))):
        c.submit_burst("live", name, tenant=t, train_batch=8, hapi=hapi, b_max=2, split=split)
    return c, c.drain()


@pytest.mark.cuda
def test_cuda_fleet_drains_two_tenants_through_the_executors(card):
    """Two replicas serve two tenants' bursts through the executors on the
    card, against the same cluster on the CPU: codes within one step, scales
    to 1e-4, and the same replicas, COS batches, act_bytes, virtual times and
    event digests (card time never reaches the virtual clock)."""
    x = _normal((8, 224, 224, 3), 53)
    tops.reset_launch_counts()
    c, got = _cluster_through_executors(x, "cuda")
    counts = tops.launch_counts()
    cw, want = _cluster_through_executors(x, "cpu")
    assert len(got) == len(want) == 4 and len({r.server_id for r in got}) == 2
    vit = tv.PAPER_MODELS["transformer"](device="meta")
    blocks = sum(isinstance(layer, tv.EncoderBlock) for layer in list(vit.layers)[:11])
    assert blocks > 0
    assert counts["quantize_int8"] == sum(-(-4 // r.cos_batch) for r in got)
    assert counts["flash_attention"] == blocks * sum(-(-4 // r.cos_batch) for r in got
                                                     if r.tenant == 1)
    assert c.event_digest() == cw.event_digest()
    assert c.report().as_dict() == cw.report().as_dict()
    for r, w in zip(got, want):
        assert (r.req_id, r.tenant, r.server_id, r.object_name, r.cos_batch, r.act_bytes,
                r.started, r.finished) == \
            (w.req_id, w.tenant, w.server_id, w.object_name, w.cos_batch, w.act_bytes,
             w.started, w.finished)
        (q, s), (qe, se) = r.acts, w.acts
        assert q.dtype == np.int8 and q.shape == qe.shape
        assert np.abs(q.astype(np.int32) - qe.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(s, se, rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_cuda_server_refuses_an_executor_result_on_the_card(card):
    """An executor returns host arrays; a tensor on the card fails loudly."""
    with pytest.raises(TypeError, match="host arrays"):
        _leaves((np.zeros(3), {"a": torch.zeros(2, device=card)}))
    store = ObjectStore()
    store.put_dataset("live", {"x": np.zeros((2, 4), np.float32)}, object_size=2)
    server = HapiServer(store, n_accelerators=1)
    server.register_executor("m", lambda payload, split, b: torch.zeros(2, 4, device=card))
    prof = profile_layered(tv.alexnet(device="meta"))
    server.submit(PostRequest(0, 0, "m", 3, "live/part-00000", 2, prof, 0.0))
    with pytest.raises(TypeError, match="host arrays"):
        server.drain()


def _on_grid(t, step):
    """``t`` rounded to multiples of ``step``. The MoE tests put the router
    (multiples of 1/256) and its input (multiples of 1/64, |x| <= 4, exact in
    bf16) on such grids: every product is then a multiple of 2**-14 and every
    partial sum of the f32 gate logits is exact, whatever the order, so the
    card and the CPU route the same tokens."""
    return torch.round(t / step) * step


@pytest.mark.cuda
def test_cuda_moe_matches_the_cpu_at_moonshot_width(card):
    """moonshot-v1-16b-a3b's MoE (d 2048, 64 experts top-6, f 1408, bf16) at
    the published capacity 1.25, so slots drop: the card routes as the CPU
    does, its output is within 2e-2 relative L2 of the CPU's, and two calls
    on the card give the same bits."""
    cfg = get_config("moonshot-v1-16b-a3b")
    cpu = tl.MoE(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        cpu.router.copy_(_on_grid(cpu.router, 1 / 256))
    gpu = copy.deepcopy(cpu).to(card)
    x = _on_grid(torch.from_numpy(_normal((2, 256, cfg.d_model), 71)), 1 / 64).clamp(-4, 4)
    x = x.to(torch.bfloat16)
    with torch.no_grad():
        want, rw = tl.moe_apply(cpu, x, cfg), tl.moe_route(cpu, x, cfg)
        got, rg = tl.moe_apply(gpu, x.to(card), cfg), tl.moe_route(gpu, x.to(card), cfg)
        again = tl.moe_apply(gpu, x.to(card), cfg)
    assert not bool(rw.kept.all()), "capacity 1.25 must drop slots here"
    for name in ("top_e", "rank", "valid"):
        assert torch.equal(getattr(rg, name).cpu(), getattr(rw, name)), name
    assert torch.equal(torch.where(rg.valid, rg.buf_tok, -1).cpu(),
                       torch.where(rw.valid, rw.buf_tok, -1))
    assert torch.equal(got, again)
    err = (got.cpu().double() - want.double()).norm() / want.double().norm()
    assert got.dtype == torch.bfloat16 and float(err) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_cuda_smoke_serve_matches_the_cpu(card, arch):
    """serve() at its defaults (the f32 smoke config, the same seeded weights
    and prompts on both devices): the prefill's logits to 1e-4 relative L2;
    a flash launch per attention sublayer of the prefill and a decode launch
    per attention sublayer and step, an SSD launch per mamba sublayer."""
    tops.reset_launch_counts()
    got = serve(arch)
    counts = tops.launch_counts()
    want = serve(arch, device="cpu")
    assert np.array_equal(got["prompt"], want["prompt"])
    v = get_smoke_config(arch).vocab_size
    a, b = got["prefill_logits"][..., :v].cpu().double(), want["prefill_logits"][..., :v].double()
    assert torch.isfinite(a).all() and float((a - b).norm() / b.norm()) <= 1e-4
    steps = got["prompt"].shape[1] + got["tokens"].shape[1] - 1
    assert counts["flash_attention"] > 0
    assert counts["decode_attention"] == counts["flash_attention"] * steps
    assert (counts["ssd_scan"] > 0) == (arch == "jamba-v0.1-52b")
