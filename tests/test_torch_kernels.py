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

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.int8_transfer import dequantize_int8_pallas, quantize_int8_pallas
from repro.kernels.ssd_scan import ssd_scan_pallas
from repro.models import vision as jv
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch import convert
from repro_torch.kernels import decode_attention as tdk
from repro_torch.kernels import flash_attention as tfk
from repro_torch.kernels import int8_transfer as tik
from repro_torch.kernels.int8_cases import INT8_ADVERSARIAL, int8_adversarial
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tsk
from repro_torch.models import ssm as tssm
from repro_torch.models import vision as tv

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", INT8_ADVERSARIAL)
def test_int8_plain_bit_exact_with_jax_on_adversarial_inputs(case, dtype):
    """The card tests' adversarial inputs (exact ties, zero tiles, one 1e30
    per tile, subnormals): the plain version, which the kernel is held to
    bit for bit on the card, is bit-exact with the JAX oracle run eagerly."""
    jx, tx = _both(int8_adversarial(case), dtype)
    q, s = tops.quantize_int8(tx)
    qe, se = jref.quantize_int8(jx)
    np.testing.assert_array_equal(_np(q), np.asarray(qe))
    np.testing.assert_array_equal(_np(s), np.asarray(se))
    if case == "ties":
        assert (_np(s) == 2.0 ** -3).all()
        odd = np.abs(_np(q)) % 2 == 1
        assert not odd[np.abs(_np(q)) != 127].any()     # every tie went to even
    x = tops.dequantize_int8(q, s, dtype=_TORCH[dtype])
    np.testing.assert_array_equal(_np(x), _np(jref.dequantize_int8(qe, se, dtype=_JNP[dtype])))


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
# decode attention
# ---------------------------------------------------------------------------
DECODE_CASES = [
    # b, s, hq, hkv, hd, length: tests/test_kernels.py's cases
    (2, 1024, 8, 2, 64, 700),
    (1, 512, 4, 4, 128, 512),
    (2, 768, 16, 8, 64, 100),    # GQA 2:1, short fill
    (1, 300, 8, 8, 64, 300),     # 300 is not a multiple of the 256 block
]


def _decode_inputs(b, s, hq, hkv, hd, seed=20):
    return (_normal((b, hq, hd), seed), _normal((b, s, hkv, hd), seed + 1),
            _normal((b, s, hkv, hd), seed + 2))


@pytest.mark.parametrize("b,s,hq,hkv,hd,length", DECODE_CASES)
def test_decode_plain_matches_jax_ref_and_pallas(b, s, hq, hkv, hd, length):
    qn, kn, vn = _decode_inputs(b, s, hq, hkv, hd)
    out = tops.decode_attention(*(torch.from_numpy(a) for a in (qn, kn, vn)), length)
    assert out.shape == (b, hq, hd) and out.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(a) for a in (qn, kn, vn))
    exp = jref.decode_attention(jq, jk, jv, jnp.int32(length))
    pal = decode_attention_pallas(jq, jk, jv, length, s_block=256, interpret=True)
    np.testing.assert_allclose(_np(out), np.asarray(exp), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(out), np.asarray(pal), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("length,cap", [(1, None), (77, 50.0), (160, None)])
def test_decode_plain_bf16_and_softcap_match_jax_ref(length, cap):
    """bf16 caches, lengths of 1 and off the tile, softcap: P is cast to the
    cache's type before P.V, as in the oracle."""
    qn, kn, vn = _decode_inputs(2, 160, 8, 2, 64, seed=30)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "bfloat16") for a in (qn, kn, vn))
    out = tops.decode_attention(tq, tk, tv, length, softcap=cap)
    exp = jref.decode_attention(jq, jk, jv, jnp.int32(length), softcap=cap)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(exp), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("length,window", [(100, 0), (100, 16), (17, 16), (5, 16)])
def test_decode_window_is_attention_decodes_mask(length, window):
    """window admits kpos >= length - 1 - window: the mask of the JAX
    attention_decode's local layers, which is the full decode over the
    window's keys alone."""
    qn, kn, vn = _decode_inputs(1, 128, 4, 2, 32, seed=40)
    out = tops.decode_attention(*(torch.from_numpy(a) for a in (qn, kn, vn)), length,
                                window=window, softcap=30.0)
    lo = max(0, length - 1 - window)
    exp = jref.decode_attention(jnp.asarray(qn), jnp.asarray(kn[:, lo:]),
                                jnp.asarray(vn[:, lo:]), jnp.int32(length - lo),
                                softcap=30.0)
    np.testing.assert_allclose(_np(out), np.asarray(exp), atol=2e-5, rtol=2e-5)


def test_decode_partition_covers_live_keys():
    for n_keys in (1, 31, 32, 33, 544, 3000, 32768):
        for pairs in (1, 32, 4096):
            per, parts = tdk.partition(n_keys, pairs)
            assert (parts - 1) * per < n_keys <= parts * per
            assert parts == 1 or per % tdk.TILE == 0
    assert tdk.partition(544, 32) == (192, 3)        # a cluster of 3
    assert tdk.partition(32768, 32) == (8192, 4)     # scratch and counters
    assert tdk.live_keys(544, None) == (0, 544)
    assert tdk.live_keys(100, 16) == (83, 100)
    assert tdk.live_keys(5, 16) == (0, 5)


_LENGTHS = (1, 2, 31, 64, 65, 100, 544, 1000, 4097, 32768, 70000)


@pytest.mark.parametrize("window", [None, 0, 100, 1024])
@pytest.mark.parametrize("length", _LENGTHS)
def test_decode_split_schedule_covers_live_keys_once(length, window):
    """The splits tile [lo, hi) exactly once, each at least MIN_SPLIT_KEYS
    keys where there are more; a pair takes at most MAX_SPLITS blocks (a
    cluster), the grid at most WAVES waves of the SMs (one split once the
    pairs fill a wave), and a split is the fewest whole stages that keep to
    those limits, so the grid fills the waves as far as the keys allow."""
    lo, hi = tdk.live_keys(length, window)
    sms = tdk.H100_SMS
    for pairs in (1, 4, 8, 32, 40, 67, 100, 132, 133, 264, 300):
        per, n = tdk.partition(hi - lo, pairs)
        starts = [lo + i * per for i in range(n)]
        ends = [min(hi, st + per) for st in starts]
        covered = np.zeros(hi - lo, np.int64)
        for st, en in zip(starts, ends):
            assert lo <= st < en <= hi       # every split holds live keys
            covered[st - lo:en - lo] += 1
        assert (covered == 1).all()
        if n > 1:
            assert per % tdk.TILE == 0 and per >= tdk.MIN_SPLIT_KEYS
        cap = 1 if pairs >= sms else min(tdk.MAX_SPLITS, tdk.WAVES * sms // pairs)
        assert n <= cap and pairs * n <= max(pairs, tdk.WAVES * sms)
        fewer = per - tdk.TILE
        if n > 1 and fewer >= tdk.MIN_SPLIT_KEYS:
            assert math.ceil((hi - lo) / fewer) > cap


@pytest.mark.parametrize("hd", tfk.HEAD_DIMS)
def test_flash_tile_config_fits_the_card(hd):
    """BM 128 (two consumer warpgroups of 64 rows), BN a wgmma width, the
    ring and Q within a block's shared memory, TMA boxes of 64 bf16."""
    bm, bn, stages, smem = tfk.tile_config(hd)
    assert bm == 128 and stages >= 2
    assert bn % 8 == 0 and 8 <= bn <= 256 and bn % 16 == 0
    assert smem <= tfk.SMEM_LIMIT == 232_448
    assert smem >= 2 * hd * (bm + 2 * stages * bn)
    assert tfk.TMA_BOX * 2 == 128 and hd % tfk.TMA_BOX == 0
    assert {64: 128, 128: 128, 256: 64}[hd] == bn
    with pytest.raises(ValueError, match="head_dim"):
        tfk.tile_config(96)


_FLASH_BWD_TAKES = ([("bfloat16", hd) for hd in tfk.HEAD_DIMS]
                    + [("float32", hd) for hd in tfk.F32_HEAD_DIMS])


@pytest.mark.parametrize("dtype,hd", _FLASH_BWD_TAKES)
def test_flash_fwd_route_fits_the_card(dtype, hd):
    """The forward's route is fixed by (dtype, head dim): wgmma for bf16,
    split TF32 for f32 at 64 and 128, FMA for f32 at 16, 32 and 256; every
    route's largest block fits in a block's shared memory."""
    route, bm, bn, threads, smem = tfk.fwd_route(hd, _TORCH[dtype])
    assert route == {"bfloat16": "wgmma",
                     "float32": "3xtf32" if hd in (64, 128) else "fma"}[dtype]
    assert route in tfk.FWD_ROUTES and threads % 32 == 0 and threads <= 1024
    assert 0 < smem <= tfk.SMEM_LIMIT == 232_448
    if route == "wgmma":
        assert (bm, bn, smem) == tuple(tfk.tile_config(hd)[i] for i in (0, 1, 3))
        assert threads == 3 * 128
    elif route == "3xtf32":
        rows, consumers = 16 * tfk.TF32_STRIPS[hd], threads // 32 - 1  # and a producer
        assert bm == rows * consumers and bn * hd == tfk.TF32_TILE and bn % 16 == 0
    else:
        assert (bm, bn, threads) == (32, 32, 128)


@pytest.mark.parametrize("dtype,hd", [("bfloat16", 16), ("bfloat16", 32), ("float32", 48),
                                      ("bfloat16", 96), ("float32", 512)])
def test_flash_fwd_route_refuses_other_head_dims(dtype, hd):
    with pytest.raises(ValueError, match="head_dim"):
        tfk.fwd_route(hd, _TORCH[dtype])


@pytest.mark.parametrize("dtype,hd", _FLASH_BWD_TAKES)
def test_flash_bwd_tile_config_fits_the_card(dtype, hd):
    """The backward's route is fixed by (dtype, head dim): wgmma at bf16 64
    and 128, mma.sync at bf16 256, FMA for f32. On the wgmma route both
    kernels own 128 keys or rows (64 for each of two consumer warpgroups,
    beside a producer warpgroup) and walk tiles of 64 through a ring of at
    least 2 stages, with TMA boxes of 64 bf16; every kernel's shared memory
    fits in a block's."""
    route, dkdv, dq = tfk.bwd_tile_config(hd, _TORCH[dtype])
    assert route == {"float32": "fma", "bfloat16": "wgmma" if hd < 256 else "mma"}[dtype]
    assert route in tfk.BWD_ROUTES
    for block, tile, stages, threads, smem in (dkdv, dq):
        assert 0 < smem <= tfk.SMEM_LIMIT == 232_448
        assert block % tile == 0 and stages >= 1 and threads % 128 == 0
        if route == "wgmma":
            assert block == 128 and tile % 64 == 0 and stages >= 2 and threads == 3 * 128
            assert tfk.TMA_BOX * 2 == 128 and hd % tfk.TMA_BOX == 0
            # K and V (or Q and dO) resident, two tiles a stage, 1 KB of slack.
            assert smem >= 2 * block * hd * 2 + stages * 2 * tile * hd * 2 + 1024
        elif route == "mma":
            assert block == 64 and stages == 2
        else:
            assert block == tile == 32 and threads == 128
    if route == "wgmma":
        assert dkdv[4] > dq[4]    # the dK/dV ring also holds each tile's LSE and D
    with pytest.raises(ValueError, match="head_dim"):
        tfk.bwd_tile_config(96, _TORCH[dtype])
    with pytest.raises(ValueError, match="head_dim"):
        tfk.bwd_tile_config(hd, torch.float16)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------
_SSD_LAUNCH_SHAPES = [
    # b, h, p, n, chunk
    (4, 64, 64, 128, 256),   # mamba2-1.3b's prefill
    (2, 3, 16, 16, 16),      # the smoke model's widths
    (1, 4, 32, 64, 64),
    (2, 8, 48, 128, 128),    # P 48: slices of 16
    (1, 2, 64, 16, 4096),
]


@pytest.mark.parametrize("b,h,p,n,q", _SSD_LAUNCH_SHAPES)
def test_ssd_launch_config_fits_the_card(b, h, p, n, q):
    """One block of four warps per (column slice, head, batch row); the slices
    cover every column of every head once; the tiles fit in a block's shared
    memory, and at the path's shape two blocks fit on an SM."""
    (gx, gy, gz), threads, smem = tsk.launch_config(b, h, p, n, q)
    assert (gy, gz, threads) == (h, b, 128) and tsk.TILE == 64
    pblk = p // gx
    assert pblk * gx == p and pblk in (16, 32, 64) and pblk <= tsk.PBLK
    covered = np.zeros((b, h, p), np.int64)
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                covered[z, y, x * pblk:(x + 1) * pblk] += 1
    assert (covered == 1).all()
    assert smem <= tsk.SMEM_LIMIT == 232_448
    # C, two B and two x tiles of 64 rows, the state's hi and lo, and three
    # f32 values a step (cum, dt, the state update's factor).
    assert smem >= 2 * (3 * 64 * n + 2 * 64 * pblk + 2 * n * pblk) + 12 * q
    if (b, h, p, n, q) == (4, 64, 64, 128, 256):
        assert 2 * (smem + 1024) <= 228 * 1024    # 1 KB of each block is the system's
        assert gx * gy * gz == 256


@pytest.mark.parametrize("p,n,q", [(64, 120, 64), (40, 64, 64), (64, 64, 40), (80, 64, 64),
                                   (64, 144, 64), (64, 128, 16384), (0, 64, 64), (64, 0, 64)])
def test_ssd_launch_config_raises_on_refused_shapes(p, n, q):
    with pytest.raises(ValueError):
        tsk.launch_config(1, 1, p, n, q)


def test_ssd_bf16_wrapper_refuses_shapes_off_16():
    """The bf16 kernel's shape check comes before the device check, so it
    shows here on CPU tensors: head dims and states off 16 are refused, a
    chunk off 16 is padded (it reaches the device check); the f32 kernel
    takes multiples of 4."""
    x = torch.zeros(1, 64, 2, 24, dtype=torch.bfloat16)
    bc = torch.zeros(1, 64, 16, dtype=torch.bfloat16)
    bc24 = torch.zeros(1, 64, 24, dtype=torch.bfloat16)
    dts = torch.zeros(1, 64, 2)
    with pytest.raises(ValueError, match="multiples of 16"):
        tsk.ssd_scan_cuda(x, dts, dts, bc, bc, chunk=64)
    with pytest.raises(ValueError, match="multiples of 16"):
        tsk.ssd_scan_cuda(x[..., :16], dts, dts, bc24, bc24, chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.ssd_scan_cuda(x[..., :16], dts, dts, bc, bc, chunk=8)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.ssd_scan_cuda(x.float(), dts, dts, bc.float(), bc.float(), chunk=64)


@pytest.mark.parametrize("s,chunk", [(8, 256), (100, 256), (250, 256), (64, 8)])
def test_ssd_padded_chunks_match_jax(s, chunk):
    """What the bf16 wrapper does with a chunk off 16, in f32 on the CPU: each
    chunk padded with zero steps to a multiple of 16, the plain chunked scan at
    that chunk, y cut back to the real steps; against the JAX model's
    ``ssd_chunked`` at the unpadded chunk. A short prompt (one chunk of 8, 100
    or 250 steps) and a small chunk (8 chunks of 8)."""
    args = _ssd_inputs(2, s, 3, 16, 16, seed=80)
    q = min(chunk, s)
    padded, q16 = tsk.pad_chunks(*(torch.from_numpy(a) for a in args), q)
    assert q16 % 16 == 0 and q <= q16 < q + 16
    assert padded[0].shape == (2, s // q * q16, 3, 16)
    y, st = tref.ssd_chunked(*padded, chunk=q16)
    y = tsk.unpad_chunks(y, q, q16)
    yj, stj = jax_ssd_chunked(*(jnp.asarray(a) for a in args), None, chunk=chunk)
    assert y.shape == (2, s, 3, 16)
    np.testing.assert_allclose(_np(y), np.asarray(yj), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(_np(st), np.asarray(stj), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,q", [(100, 100), (64, 8), (40, 20)])
def test_ssd_padded_steps_leave_the_state_bit_identical(s, q):
    """A zero step multiplies the state by exp(0) = 1 and adds 0: the
    sequential recurrence over the padded steps ends in the very same f32
    state, and its real steps' y are the very same values."""
    args = [torch.from_numpy(a) for a in _ssd_inputs(1, s, 2, 16, 16, seed=90)]
    padded, q16 = tsk.pad_chunks(*args, q)
    assert q16 > q
    y, st = tref.ssd_reference(*args)
    yp, stp = tref.ssd_reference(*padded)
    assert torch.equal(st, stp)
    assert torch.equal(y, tsk.unpad_chunks(yp, q, q16))


def _ssd_rounded(x, dtA, dt, B_, C_, chunk, split):
    """The bf16 kernel's arithmetic in f32 on the CPU: the three f32 operands
    of its products (G', the state, x') rounded to bf16, as hi + lo halves
    (``split``) or as one bf16."""
    def rnd(t):
        hi = t.to(torch.bfloat16).float()
        return hi + (t - hi).to(torch.bfloat16).float() if split else hi
    b, s, h, p = x.shape
    q = chunk
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    state = torch.zeros((b, h, B_.shape[-1], p))
    ys = []
    for s0 in range(0, s, q):
        xk, dk = x[:, s0:s0 + q].float(), dt[:, s0:s0 + q].float()
        bk, ck = B_[:, s0:s0 + q].float(), C_[:, s0:s0 + q].float()
        cum = torch.cumsum(dtA[:, s0:s0 + q].float(), dim=1)                  # (B, Q, H)
        decay = torch.where(tri[None, :, :, None],
                            torch.exp(cum[:, :, None, :] - cum[:, None, :, :]), 0.0)
        g = torch.einsum("bqn,bkn->bqk", ck, bk)[..., None] * decay * dk[:, None]
        y = torch.einsum("bqkh,bkhp->bqhp", rnd(g), xk)
        y = y + torch.einsum("bqn,bhnp->bqhp", ck, rnd(state)) * torch.exp(cum)[..., None]
        xs = xk * (torch.exp(cum[:, -1:] - cum) * dk)[..., None]
        state = state * torch.exp(cum[:, -1])[:, :, None, None] \
            + torch.einsum("bqn,bqhp->bhnp", bk, rnd(xs))
        ys.append(y)
    return torch.cat(ys, dim=1), state


@pytest.mark.parametrize("split", [True, False])
def test_ssd_slow_decay_needs_split_bf16_operands(split):
    """The card tests' slow-decay case (decay rate exp(-4), two chunks of 256,
    N 128) holds the split operands to the SSD tolerance, and catches one
    bf16 in their place."""
    rng = np.random.default_rng(20)
    b, s, h, p, n = 1, 512, 2, 64, 128
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((b, s, h)).astype(np.float32)))
    a = -torch.exp(torch.full((h,), -4.0))
    B_, C_ = (torch.from_numpy((rng.standard_normal((b, s, n)) * 0.3).astype(np.float32))
              .to(torch.bfloat16).float() for _ in range(2))
    ye, ste = tref.ssd_chunked(x, dt * a, dt, B_, C_, chunk=256)
    assert float(ye.abs().max()) > 10.0
    y, st = _ssd_rounded(x, dt * a, dt, B_, C_, 256, split)
    close = all(torch.allclose(got, want, atol=2e-3, rtol=2e-3)
                for got, want in ((y, ye), (st, ste)))
    assert close == split


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 as the split-TF32 flash route rounds: to nearest,
    ties away from zero, by adding half of the 13 dropped bits' range to the
    bit pattern and clearing them."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """The f32 sum of the TF32 products the route issues for one product:
    hi.lo + lo.hi + hi.hi of hi = tf32(x), lo = tf32(x - hi) (``split``),
    or hi.hi alone (one TF32 pass)."""
    ah, bh = _tf32(a), _tf32(b)
    out = torch.einsum(eq, ah, bh)
    if split:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh) + out
    return out


def _flash_tf32_rounded(q, k, v, causal, window, softcap, split):
    """The split-TF32 route's arithmetic on the CPU: Q.K^T and P.V from
    TF32-rounded operands, the softmax exact in f32, as in ref.py."""
    s, hd = q.shape[1], q.shape[3]
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    scores = _tf32_product("bqhd,bkhd->bhqk", q, k, split) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    qpos, kpos = torch.arange(s)[:, None], torch.arange(s)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window - 1
    probs = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    return _tf32_product("bhqk,bkhd->bqhd", probs, v, split)


@pytest.mark.parametrize("split", [True, False])
def test_flash_f32_route_needs_split_tf32_operands(split):
    """At a ViT block's shape (2, 196, 6 heads of 64, non-causal), the
    split-TF32 route's rounding holds the JAX reference to the f32
    tolerance, 2e-5; one TF32 pass (10 bits of each operand) does not."""
    qn, kn, vn = (_normal((2, 196, 6, 64), i) for i in (60, 61, 62))
    out = _flash_tf32_rounded(*(torch.from_numpy(a) for a in (qn, kn, vn)), False, None, None,
                              split)
    exp = np.asarray(jref.flash_attention(*(jnp.asarray(a) for a in (qn, kn, vn)),
                                          causal=False))
    close = np.allclose(_np(out), exp, atol=2e-5, rtol=2e-5)
    assert close == split, float(np.abs(_np(out) - exp).max())


@pytest.mark.parametrize("causal,window,cap", [(True, None, None), (True, 50, 30.0),
                                               (False, 20, None)])
def test_flash_f32_split_tf32_holds_every_mask(causal, window, cap):
    """The split holds the tolerance with the masks and the soft-cap too (at
    the f32 hd 128 case's heads, S off the tiles)."""
    qn, kn, vn = (_normal((1, 200, 4, 128), i) for i in (63, 64, 65))
    out = _flash_tf32_rounded(*(torch.from_numpy(a) for a in (qn, kn, vn)), causal, window,
                              cap, True)
    exp = jref.flash_attention(*(jnp.asarray(a) for a in (qn, kn, vn)), causal=causal,
                               window=window, softcap=cap)
    np.testing.assert_allclose(_np(out), np.asarray(exp), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("split", [True, False])
def test_flash_f32_route_on_a_real_vit_block(split, monkeypatch):
    """The same on the q, k and v of a full-width ViT block (the port's
    tiny_transformer_encoder with the JAX init's weights, two numpy images):
    the split holds 2e-5 against the JAX reference, one TF32 pass does not."""
    jvm = jv.PAPER_MODELS["transformer"](n_layers=1)
    tvm = tv.tiny_transformer_encoder(n_layers=1, device="cpu")
    convert.vision_params_from_jax(tvm, jvm.init(jax.random.PRNGKey(0)))
    seen = []
    plain = tops.flash_attention

    def capture(q, k, v, **kw):
        seen.append((q.detach().clone(), k.detach().clone(), v.detach().clone(), kw))
        return plain(q, k, v, **kw)

    monkeypatch.setattr(tops, "flash_attention", capture)
    images = np.random.default_rng(66).standard_normal((2, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        tvm.apply_range(torch.from_numpy(images), 0, 2)
    ((q, k, v, kw),) = seen
    assert q.shape == (2, 196, 6, 64) and kw == {"causal": False}
    out = _flash_tf32_rounded(q, k, v, False, None, None, split)
    exp = np.asarray(jref.flash_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                          causal=False))
    close = np.allclose(_np(out), exp, atol=2e-5, rtol=2e-5)
    assert close == split, float(np.abs(_np(out) - exp).max())


def _ssd_inputs(b, s, h, p, n, seed=50):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    B_ = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    C_ = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return x, (dt * a).astype(np.float32), dt, B_, C_


@pytest.mark.parametrize("b,s,h,p,n,chunk,hb", [
    (2, 512, 8, 64, 128, 128, 4),    # tests/test_kernels.py's cases
    (1, 256, 4, 32, 64, 64, 4),
    (1, 256, 4, 32, 16, 128, 2),     # jamba-like small state
    (2, 128, 8, 64, 128, 128, 8),    # single chunk
])
def test_ssd_plain_matches_jax_ref_and_pallas(b, s, h, p, n, chunk, hb):
    args = _ssd_inputs(b, s, h, p, n)
    y, st = tops.ssd_scan(*(torch.from_numpy(a) for a in args), chunk=chunk)
    assert y.dtype == torch.float32 and st.shape == (b, h, n, p)
    ye, ste = jref.ssd_reference(*(jnp.asarray(a) for a in args))
    yp, stp = ssd_scan_pallas(*(jnp.asarray(a) for a in args), chunk=chunk, head_block=hb,
                              interpret=True)
    for got, want in ((y, ye), (st, ste), (y, yp), (st, stp)):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("s,chunk", [(64, 16), (48, 48), (32, 256)])
def test_ssd_chunked_and_recurrence_match_jax(s, chunk):
    """The port's chunked form (the kernel's plain version) and its sequential
    recurrence against the JAX package's, in f32."""
    args = _ssd_inputs(2, s, 3, 16, 16, seed=60)
    targs, jargs = [torch.from_numpy(a) for a in args], [jnp.asarray(a) for a in args]
    y, st = tssm.ssd_chunked(*targs, chunk=chunk)
    yj, stj = jax_ssd_chunked(*jargs, None, chunk=chunk)
    yr, str_ = tref.ssd_reference(*targs)
    yrj, strj = jref.ssd_reference(*jargs)
    for got, want in ((y, yj), (st, stj), (yr, yrj), (str_, strj), (y, yrj)):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-4, rtol=2e-4)


def test_ssd_chunked_has_no_nan_where_decay_overflows():
    """exp(cum_i - cum_j) above the diagonal overflows to inf for strong
    decay; the chunked form selects 0 there rather than multiplying."""
    x, dta, dt, B_, C_ = _ssd_inputs(1, 64, 2, 16, 16, seed=70)
    y, st = tref.ssd_chunked(*(torch.from_numpy(a) for a in (x, dta * 200, dt, B_, C_)),
                             chunk=64)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()


def test_ssd_raises_on_a_ragged_chunk():
    args = [torch.from_numpy(a) for a in _ssd_inputs(1, 40, 2, 16, 16)]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tops.ssd_scan(*args, chunk=16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tsk.ssd_scan_cuda(*args, chunk=16)


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


def test_serving_wrappers_refuse_cpu_tensors():
    q, kv = torch.zeros(1, 4, 64), torch.zeros(1, 32, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tdk.decode_attention_cuda(q, kv, kv, 8)
    with pytest.raises(ValueError, match="length"):
        tdk.decode_attention_cuda(q, kv, kv, 33)
    with pytest.raises(ValueError, match="head_dim"):
        tdk.decode_attention_cuda(torch.zeros(1, 4, 48), torch.zeros(1, 8, 2, 48),
                                  torch.zeros(1, 8, 2, 48), 8)
    x, bc, dts = torch.zeros(1, 32, 2, 16), torch.zeros(1, 32, 16), torch.zeros(1, 32, 2)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.ssd_scan_cuda(x, dts, dts, bc, bc, chunk=16)


def test_flash_wrapper_rejects_unsupported_head_dim():
    q = torch.zeros(1, 8, 2, 48)
    with pytest.raises(ValueError, match="head_dim"):
        tfk.flash_attention_cuda(q, q, q)


@pytest.mark.parametrize("hd", [16, 32])
def test_attention_wrappers_take_small_head_dims_in_f32(hd):
    """Head dims 16 and 32 (the smoke configs') pass the shape checks in f32,
    so CPU tensors reach the device check; bf16 flash keeps 64, 128 and 256
    (its TMA box is 64 values wide); decode takes 16 on bf16 caches too (an
    f32 model decodes against the bf16 cache), and 32 on f32 caches only."""
    q = torch.zeros(1, 8, 2, hd)
    with pytest.raises(ValueError, match="CUDA"):
        tfk.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        tfk.flash_attention_cuda(*(q.to(torch.bfloat16),) * 3)
    kv = torch.zeros(1, 8, 2, hd)
    with pytest.raises(ValueError, match="CUDA"):
        tdk.decode_attention_cuda(torch.zeros(1, 4, hd), kv, kv, 8)
    bf = kv.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA" if hd == 16 else "head_dim"):
        tdk.decode_attention_cuda(torch.zeros(1, 4, hd), bf, bf, 8)


@pytest.mark.parametrize("hq,hkv,ok", [(48, 8, True), (12, 2, True), (24, 8, False),
                                       (10, 2, False), (16, 1, False)])
def test_decode_wrapper_takes_group_6(hq, hkv, ok):
    """Groups of 1, 2, 4, 6 (grok-1: 48 query heads on 8) and 8 pass the shape
    check and reach the device check; 3, 5 and 16 are refused."""
    q, kv = torch.zeros(1, hq, 64), torch.zeros(1, 8, hkv, 64)
    with pytest.raises(ValueError, match="CUDA" if ok else "groups"):
        tdk.decode_attention_cuda(q, kv, kv, 8)


def test_quantize_route_from_shape_and_alignment():
    """The vector route takes a 16-byte aligned x whose tiles hold 16 bytes or
    more; everything else takes the scalar route, chosen before any launch."""
    bf, f32 = torch.bfloat16, torch.float32
    assert tik.quantize_route(torch.zeros(2, 4096, 5120, dtype=bf), 128) == "vector"
    assert tik.quantize_route(torch.zeros(3, 80, dtype=bf), 16) == "vector"
    assert tik.quantize_route(torch.zeros(3, 80), 16) == "vector"
    assert tik.quantize_route(torch.zeros(3, 8, dtype=bf), 8) == "vector"
    assert tik.quantize_route(torch.zeros(3, 4), 4) == "vector"
    assert tik.quantize_route(torch.zeros(3, 12, dtype=bf), 4) == "scalar"
    assert tik.quantize_route(torch.zeros(3, 2), 2) == "scalar"
    assert tik.quantize_route(torch.zeros(5, 97, dtype=f32), 1) == "scalar"
    buf = torch.zeros(4 * 5120 + 8, dtype=bf)
    view = buf[1:1 + 4 * 5120].view(4, 5120)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    assert tik.quantize_route(view, 128) == "scalar"
    assert tik.quantize_route(buf[8:8 + 4 * 5120].view(4, 5120), 128) == "vector"


def test_launch_counts_reset():
    tops.reset_launch_counts()
    assert tops.launch_counts() == {"flash_attention": 0, "flash_attention_bwd": 0,
                                    "quantize_int8": 0, "dequantize_int8": 0,
                                    "decode_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}
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
