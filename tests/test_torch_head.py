"""The LM head's tensor-core route (``repro_torch.kernels.head``) on the CPU.

The route's Python runs here with ``PLAIN`` products (``a.float() @
b.float()``) and the plain split (``ref.split3_bf16``); the split kernel
itself is held bit for bit to the plain split in ``test_torch_cuda.py``.
Checked here: the split is exact over the magnitudes a gradient takes and
where its lowest term flushes; the chunked backward against an f64 sum of the
exact products, against autograd of the present head and against
``jax.vjp`` of the JAX package's head; the chunks' shape rule; the routes;
``head_products_total`` by route.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtr
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import head as hd
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.obs import program as P


def _f32(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _bf16_valued(rng, shape, scale=1.0):
    """f32 values that bf16 holds exactly."""
    return _f32(rng, shape, scale).to(torch.bfloat16).to(torch.float32)


def _sum3(terms: torch.Tensor) -> torch.Tensor:
    return terms.double().sum(0)


# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scale", [1e-30, 1e-20, 1e-10, 1e-5, 1e-2, 1.0, 1e2, 1e4])
def test_split3_is_exact_over_a_gradients_magnitudes(scale):
    """Values of either sign from ``scale`` to about 5 ``scale``."""
    x = np.random.default_rng(0).standard_normal((64, 257))
    g = torch.from_numpy((np.sign(x) * (1 + np.abs(x)) * scale).astype(np.float32))
    terms = tref.split3_bf16(g)
    assert terms.dtype == torch.bfloat16 and terms.shape == (3, 64, 257)
    assert torch.equal(terms[0], g.to(torch.bfloat16))
    assert torch.equal(_sum3(terms), g.double())
    # Each term is the rounding of what the terms above it left.
    r = g - terms[0].float()
    assert torch.equal(terms[1], r.to(torch.bfloat16))
    assert torch.equal(terms[2], (r - terms[1].float()).to(torch.bfloat16))


def _from_bits(bits) -> torch.Tensor:
    return torch.from_numpy(np.asarray(bits, dtype=np.uint32).view(np.float32))


@pytest.mark.parametrize("low", [0x8000, 0x0080, 0x8080, 0x7FFF, 0xFFFF, 0x0001, 0x0000])
def test_split3_is_exact_at_ties_and_signed_zeros(low):
    """Ties of the first term (low 16 bits 0x8000) and of the second (0x0080,
    0x8080), round-to-nearest-even either way, and both zeros: the sum is
    the value, and g1 keeps a zero's sign."""
    high = np.arange(0x3F80, 0x3F80 + 64, dtype=np.uint32)           # 1.0 and up
    bits = np.concatenate([(high << 16) | low, ((high | 0x8000) << 16) | low,
                           np.array([0x0, 0x80000000], np.uint32)])
    g = _from_bits(bits)
    terms = tref.split3_bf16(g)
    assert torch.equal(_sum3(terms), g.double())
    assert torch.equal(torch.signbit(terms[0]), torch.signbit(g))


@pytest.mark.parametrize("exponent", [-100, -110, -111, -120, -126, -135])
def test_split3_flushes_its_lowest_term_below_two_to_the_minus_110(exponent):
    """Exact for |g| >= 2**-110; below, the third term rounds at bf16's
    subnormal step 2**-133, so the sum is off by at most half of it."""
    rng = np.random.default_rng(1)
    mant = rng.integers(1 << 23, 1 << 24, 512).astype(np.float64)
    g = torch.from_numpy((mant * 2.0 ** (exponent - 23)).astype(np.float32))
    err = (_sum3(tref.split3_bf16(g)) - g.double()).abs().max().item()
    if exponent >= -110:
        assert err == 0.0
    else:
        assert 0.0 < err <= 2.0 ** -134


# ---------------------------------------------------------------------------
# The chunked backward
# ---------------------------------------------------------------------------
def test_chunk_cols_keeps_three_terms_within_the_budget_in_even_chunks():
    for rows, total in ((8192, 131072), (8192, 50688), (4, 131072), (48, 300), (8192, 64)):
        cols = hd.chunk_cols(rows, total)
        most = max(64, hd.SPLIT_BUDGET // (6 * rows) // 64 * 64)
        assert cols == total or (cols % 64 == 0 and cols <= most)
        assert math.ceil(total / cols) == math.ceil(total / most)
    assert hd.chunk_cols(8192, 131072) == 5248            # 25 chunks, the last 5,120
    assert hd.chunk_cols(8192, 50688) == 5120             # 10 chunks, the last 4,608
    assert hd.chunk_cols(4, 131072) == 131072             # serving: one chunk
    assert hd.chunk_cols(1_000_000, 4096) == 64           # past the budget: 64 columns


def _exact(g, h, w):
    """(logits, dh, dw) as f64 sums of the exact products."""
    g, h, w = g.double(), h.double(), w.double()
    return h @ w.t(), g @ w, g.t() @ h


def _rel(a, b) -> float:
    return float((a.detach().double() - b.detach().double()).norm() / b.double().norm())


def _same_bf16(a: torch.Tensor, b: torch.Tensor) -> bool:
    """bf16 casts of two f32 sums of the same products taken in another
    order: within one bf16 step of each other, element by element, but
    where an element cancels to far below the largest (2**-20 of it), and
    to 1e-4 relative L2."""
    a, b = a.detach().float(), b.detach().float()
    step = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7 + b.abs().max() * 2.0 ** -20
    return bool(((a - b).abs() <= step).all()) and _rel(a, b) < 1e-4


# rows, d, vocab, budget in columns: chunks of 64 over 300 columns (the last
# 44), one chunk, and mamba2's head scaled down (2,048 -> 64, 50,688 -> 792).
CHUNK_CASES = [(48, 40, 300, 64), (48, 40, 300, 512), (64, 64, 792, 128)]


@pytest.mark.parametrize("rows,d,vocab,cols", CHUNK_CASES)
def test_chunked_backward_sums_the_exact_products_in_f32(monkeypatch, rows, d, vocab, cols):
    """With f32 operands that hold bf16 values, the route keeps its f32
    sums: logits, dH and dW within f32 rounding (1e-6 relative L2) of the
    f64 sum of the exact products, as the f32 path is; a split that keeps
    one or two of the three terms misses that."""
    monkeypatch.setattr(hd, "SPLIT_BUDGET", 3 * 2 * rows * cols)
    rng = np.random.default_rng(2)
    h = _bf16_valued(rng, (rows, d)).requires_grad_()
    w = _bf16_valued(rng, (vocab, d), 0.3).requires_grad_()
    g = _f32(rng, (rows, vocab), 1e-3)
    want = _exact(g, h.detach(), w.detach())

    def run(products):
        logits = hd.HeadProductFn.apply(h, w, products)
        dh, dw = torch.autograd.grad(logits, (h, w), g)
        return logits, dh, dw

    got = run(hd.PLAIN)
    assert all(t.dtype == torch.float32 for t in got)
    for a, b in zip(got, want):
        assert _rel(a, b) < 1e-6
    f32 = h @ w.t()
    for a, b in zip((f32, *torch.autograd.grad(f32, (h, w), g)), want):
        assert _rel(a, b) < 1e-6
    for keep in (1, 2):
        def fewer(x, keep=keep):
            t = tref.split3_bf16(x)
            t[keep:] = 0
            return t
        _, dh, dw = run(hd.PLAIN._replace(split=fewer))
        assert max(_rel(dh, want[1]), _rel(dw, want[2])) > 1e-6


def _cfg(vocab, d, **kw):
    return dataclasses.replace(get_smoke_config("mamba2-1.3b"), vocab_size=vocab, d_model=d,
                               **kw)


# vocabulary, padded to, d, softcap, tied: a vocabulary off the chunk, the
# padded-vocabulary mask, gemma2's softcap, mamba2's tied embedding.
HEAD_CASES = {
    "off_the_chunk": (300, 1, 40, None, False),
    "padded_vocab": (250, 64, 40, None, False),
    "softcap": (300, 1, 40, 30.0, False),
    "tied_embedding": (792, 1, 64, None, True),
}


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_route_through_the_head_matches_autograd_of_the_present_head(monkeypatch, case):
    """``_head`` on the route (PLAIN products, chunks of 64 columns) against
    the present path's autograd, on bf16 operands: the loss to 1e-6, the
    norm's scale, h's and W's gradients as ``_same_bf16``. With a tied embedding W also feeds
    the tokens' embeddings, and both of its gradients add up."""
    vocab, pad, d, softcap, tied = HEAD_CASES[case]
    cfg = _cfg(vocab, d, vocab_pad_to=pad, logit_softcap=softcap)
    rows = 48 if not tied else 64
    monkeypatch.setattr(hd, "SPLIT_BUDGET", 3 * 2 * rows * 64)
    rng = np.random.default_rng(3)
    tokens = torch.from_numpy(rng.integers(0, vocab, (2, rows // 2)))
    results = {}
    for route in ("f32", "split_bf16"):
        monkeypatch.setattr(ttr, "head_route", lambda h, w, r=route: r)
        monkeypatch.setattr(ttr, "CARD", hd.PLAIN)
        norm = tl.RMSNorm(d, 1e-5, dtype=torch.bfloat16, device="cpu")
        w = _f32(np.random.default_rng(4), (cfg.padded_vocab, d), 0.3).to(torch.bfloat16)
        w.requires_grad_()
        if tied:
            h = w[tokens] * 8.0
        else:
            h = _f32(np.random.default_rng(5), (2, rows // 2, d)).to(torch.bfloat16)
            h.requires_grad_()
        logits = ttr._head(norm, w, h, cfg)
        assert logits.dtype == torch.float32 and logits.shape == (2, rows // 2, cfg.padded_vocab)
        loss = ttr.cross_entropy(logits, tokens)
        inputs = [norm.scale, w] + ([] if tied else [h])
        results[route] = (loss, *torch.autograd.grad(loss, inputs))
    ref_, got = results["f32"], results["split_bf16"]
    assert abs(got[0].item() - ref_[0].item()) <= 1e-6 * abs(ref_[0].item())
    for a, b in zip(got[1:], ref_[1:]):
        assert a.dtype == b.dtype == torch.bfloat16
        assert _same_bf16(a, b)
    if pad > 1:
        assert got[2][vocab:].abs().max().item() == 0.0


def test_route_matches_the_jax_heads_vjp():
    """The route's forward and backward (PLAIN products) against ``jax.vjp``
    of the JAX package's ``_head`` on the same bf16 inputs: logits to 1e-6,
    dH and dW as ``_same_bf16``."""
    cfg = _cfg(300, 40, vocab_pad_to=1)
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 24, 40)).astype(np.float32)
    w = (rng.standard_normal((300, 40)) * 0.3).astype(np.float32)
    g = (rng.standard_normal((2, 24, 300)) * 1e-3).astype(np.float32)
    scale = np.ones(40, np.float32)

    def jhead(hh, ww):
        return jtr._head({"final_norm": {"scale": jnp.asarray(scale, jnp.bfloat16)},
                          "unembed": ww}, hh, cfg)
    jl, vjp = jax.vjp(jhead, jnp.asarray(h, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    jdh, jdw = vjp(jnp.asarray(g))
    th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    norm = tl.RMSNorm(40, cfg.norm_eps, dtype=torch.bfloat16, device="cpu")
    hn = norm(th).reshape(-1, 40)
    logits = hd.HeadProductFn.apply(hn, tw, hd.PLAIN).view(2, 24, 300)
    dh, dw = torch.autograd.grad(logits, (th, tw), torch.from_numpy(g))
    assert _rel(logits.detach(), torch.from_numpy(np.array(jl))) < 1e-6
    for a, b in ((dh, jdh), (dw, jdw)):
        assert _same_bf16(a, torch.from_numpy(np.array(b.astype(jnp.float32))))


# ---------------------------------------------------------------------------
# Routes and the counter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
def test_cpu_and_meta_operands_keep_the_f32_path(dtype):
    for device in ("cpu", "meta"):
        h = torch.zeros(4, 8, dtype=dtype, device=device)
        assert hd.head_route(h, torch.zeros(16, 8, dtype=dtype, device=device)) == "f32"
    assert hd.head_route(torch.zeros(4, 8, dtype=torch.bfloat16),
                         torch.zeros(16, 8, dtype=torch.float32)) == "f32"


def test_dtensors_keep_the_f32_path():
    """A DTensor operand (the sharded steps, here meta DTensors of a fake
    4-rank group) keeps the present path, whatever its dtype."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch import dryrun
    with dryrun.fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        bf = dict(dtype=torch.bfloat16, device="meta")
        h = distribute_tensor(torch.empty(8, 16, **bf), mesh, [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(64, 16, **bf), mesh, [Replicate(), Shard(0)])
        assert hd.head_route(h, w) == "f32"
        assert hd.head_route(h, torch.empty(64, 16, **bf)) == "f32"
        assert hd.head_route(torch.empty(8, 16, **bf), w) == "f32"


def test_head_products_total_counts_each_call_by_route(monkeypatch):
    cfg = _cfg(300, 40, vocab_pad_to=1)
    norm = tl.RMSNorm(40, 1e-5, dtype=torch.bfloat16, device="cpu")
    w = torch.zeros(300, 40, dtype=torch.bfloat16)
    h = torch.ones(2, 3, 40, dtype=torch.bfloat16)
    ttr._head(norm, w, h, cfg)
    assert P.METRICS.total("head_products_total") == 0      # the tracer is off
    with P.tracing():
        for _ in range(3):
            ttr._head(norm, w, h, cfg)
        monkeypatch.setattr(ttr, "head_route", lambda h, w: "split_bf16")
        monkeypatch.setattr(ttr, "CARD", hd.PLAIN)
        ttr._head(norm, w, h, cfg)
        assert P.METRICS.snapshot()["counters"] == {"head_products_total{route=f32}": 3.0,
                                                    "head_products_total{route=split_bf16}": 1.0}
    P.METRICS.clear()


def test_split_launches_stay_out_of_the_kernels_launch_counts():
    from repro_torch.kernels import ops
    assert "split3_bf16" not in ops.launch_counts()
    assert hd.split_launch_count() == hd.split_launches
