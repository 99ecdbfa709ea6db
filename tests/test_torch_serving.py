"""The port's serving path against the JAX package's, on the CPU.

Weights come from the JAX smoke models through ``convert.params_from_jax``;
prompts are made with numpy from a seed and go through both packages. The
models are f32 and the logits are held to ``TOL``, as in
``test_torch_models.py``. The caches are bf16 in both packages, so a cached
K, V or conv tap may differ by one bf16 rounding (``BF16_ULP``) where the two
f32 values straddle a rounding boundary. The decode step also rounds P and
its attention output to bf16 (``attention_decode``): the teacher-forced step
logits agree bit for bit until such a flip, which moves them by up to about
1e-3 in these models, so they are held to ``FLIP_TOL``; a wrong mask,
position or state moves them by more than 1e-1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models.api import build_model
from repro_torch.train.steps import build_decode_step, build_prefill_step

ARCHS = ["mistral-nemo-12b", "qwen3-32b", "gemma2-9b", "mamba2-1.3b", "moonshot-v1-16b-a3b",
         "grok-1-314b", "jamba-v0.1-52b"]
TOL = dict(atol=2e-4, rtol=2e-4)
BF16_ULP = dict(atol=1e-2, rtol=1e-2)
FLIP_TOL = dict(atol=5e-3, rtol=5e-3)


def _port(arch):
    cfg, jmodel, jparams = smoke_model(arch)
    lm = build_model(t_get_smoke_config(arch), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    lm.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jparams)))
    return cfg, jmodel, jparams, lm


def _tokens(cfg, batch, seq, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq), np.int32)
    return jnp.asarray(toks), torch.from_numpy(toks).long()


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _prefill_seq(arch):
    # JAX's chunked_attention drops gemma2's window where window + q_block >=
    # seq (layers.py:163); at seq 1024 both packages window.
    return 1024 if arch == "gemma2-9b" else 32


def _jax_block(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,window", [("mistral-nemo-12b", None), ("qwen3-32b", None),
                                         ("gemma2-9b", 16)])
def test_attention_decode_matches_jax(arch, window):
    """One decode step at each of several positions against a cache of
    random bf16 entries; gemma2's local layer windows and soft-caps."""
    cfg, _, jparams, lm = _port(arch)
    jattn = _jax_block(jparams["blocks"]["sub0"]["attn"], 0)
    rng = np.random.default_rng(11)
    b, smax = 2, 40
    kc = rng.standard_normal((b, smax, cfg.n_kv_heads, cfg.hdim)).astype(np.float32)
    vc = rng.standard_normal((b, smax, cfg.n_kv_heads, cfg.hdim)).astype(np.float32)
    for pos in (0, 5, 17, 39):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        jcache = JL.KVCache(jnp.asarray(kc).astype(jnp.bfloat16),
                            jnp.asarray(vc).astype(jnp.bfloat16))
        tcache = TL.KVCache(torch.from_numpy(kc).to(torch.bfloat16),
                            torch.from_numpy(vc).to(torch.bfloat16))
        exp, jnew = JL.attention_decode(jattn, jnp.asarray(x), jcache, jnp.int32(pos), cfg,
                                        window=window)
        with torch.no_grad():
            got, tnew = TL.attention_decode(lm.blocks[0].sub0.attn, torch.from_numpy(x),
                                            tcache, pos, lm.cfg, window=window)
        assert tnew is tcache and got.shape == (b, 1, cfg.d_model)
        np.testing.assert_allclose(_f32(got), _f32(exp), **TOL)
        np.testing.assert_allclose(_f32(tnew.k), _f32(jnew.k), **BF16_ULP)
        np.testing.assert_allclose(_f32(tnew.v), _f32(jnew.v), **BF16_ULP)


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(12)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    x = rng.standard_normal((2, 10, 24)).astype(np.float32)
    got = TL.causal_conv1d(torch.from_numpy(w), torch.from_numpy(x))
    exp = JL.causal_conv1d(jnp.asarray(w), jnp.asarray(x))
    np.testing.assert_allclose(_f32(got), _f32(exp), atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# The mamba2 mixer and model
# ---------------------------------------------------------------------------
def _jmamba(jparams, i=0):
    return _jax_block(jparams["blocks"]["sub0"]["mamba"], i)


def test_ssm_apply_and_prefill_cache_match_jax():
    cfg, _, jparams, lm = _port("mamba2-1.3b")
    x = np.random.default_rng(13).standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    mamba = lm.blocks[1].sub0.mamba
    with torch.no_grad():
        got = TS.ssm_apply(mamba, torch.from_numpy(x), lm.cfg)
        out, cache = TS.ssm_prefill(mamba, torch.from_numpy(x), lm.cfg)
    jout, jcache = JS.ssm_prefill(_jmamba(jparams, 1), jnp.asarray(x), cfg)
    np.testing.assert_allclose(_f32(got), _f32(jout), **TOL)
    np.testing.assert_allclose(_f32(out), _f32(jout), **TOL)
    np.testing.assert_allclose(_f32(cache.ssm), _f32(jcache.ssm), **TOL)
    for name in ("conv_x", "conv_B", "conv_C"):
        assert getattr(cache, name).dtype == torch.bfloat16
        np.testing.assert_allclose(_f32(getattr(cache, name)), _f32(getattr(jcache, name)),
                                   **BF16_ULP)


def test_ssm_decode_matches_jax():
    cfg, _, jparams, lm = _port("mamba2-1.3b")
    rng = np.random.default_rng(14)
    jcache = JS.ssm_init_cache(cfg, 2)
    tcache = TS.ssm_init_cache(lm.cfg, 2, device="cpu")
    for _ in range(5):
        u = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        exp, jcache = JS.ssm_decode(_jmamba(jparams), jnp.asarray(u), jcache, cfg)
        with torch.no_grad():
            got, tcache = TS.ssm_decode(lm.blocks[0].sub0.mamba, torch.from_numpy(u),
                                        tcache, lm.cfg)
        np.testing.assert_allclose(_f32(got), _f32(exp), **TOL)
        np.testing.assert_allclose(_f32(tcache.ssm), _f32(jcache.ssm), **TOL)


def test_mamba_init_follows_ssm_init():
    """Same shapes as ssm_init, the f32 A_log / D / dt_bias in a bf16 model,
    and the same deterministic values where ssm_init draws nothing."""
    cfg = dataclasses.replace(t_get_smoke_config("mamba2-1.3b"), param_dtype="bfloat16")
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    _, _, jparams = smoke_model("mamba2-1.3b")
    jm = _jmamba(jparams)
    m = a.blocks[0].sub0.mamba
    for name, t in m.named_parameters():
        assert tuple(t.shape) == jm[name].shape, name
        f32 = name in ("A_log", "D", "dt_bias")
        assert t.dtype == (torch.float32 if f32 else torch.bfloat16), name
    for name in ("A_log", "D", "dt_bias", "conv_x_b", "norm_scale"):
        np.testing.assert_allclose(_f32(getattr(m, name)), _f32(jm[name]), atol=1e-6)
    assert abs(float(m.conv_x.detach().float().std()) - 0.1) < 0.02


def test_mamba2_forward_and_loss_match_jax():
    cfg, jmodel, jparams, lm = _port("mamba2-1.3b")
    jt, tt = _tokens(cfg, 2, 48, seed=15)
    jb, tb = {"tokens": jt, "labels": jt}, {"tokens": tt, "labels": tt}
    with torch.no_grad():
        logits = lm(tb)
        loss = float(lm.loss(tb))
    exp = jax.jit(jmodel.forward)(jparams, jb)
    np.testing.assert_allclose(_f32(logits), _f32(exp), **TOL)
    assert loss == pytest.approx(float(jax.jit(jmodel.loss)(jparams, jb)), abs=1e-4)


def test_mamba2_split_consistency():
    cfg, _, _, lm = _port("mamba2-1.3b")
    _, tt = _tokens(cfg, 2, 32, seed=16)
    tb = {"tokens": tt, "labels": tt}
    with torch.no_grad():
        frozen, trainable = lm.split_params(1)
        assert float(trainable.loss(frozen(tb), tb)) == pytest.approx(float(lm.loss(tb)),
                                                                      abs=1e-5)


def test_mamba2_convert_round_trip():
    _, _, jparams, lm = _port("mamba2-1.3b")
    tree = jax.tree.map(np.asarray, jparams)
    back = convert.params_to_jax(lm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert "blocks.1.sub0.mamba.A_log" in lm.state_dict()


# ---------------------------------------------------------------------------
# The model's prefill and decode step
# ---------------------------------------------------------------------------
def _compare_caches(tcaches, jcaches, n_blocks):
    assert len(tcaches) == n_blocks
    for i, tc in enumerate(tcaches):
        for sub, c in tc.items():
            jc = _jax_block(jcaches[sub], i)
            for name in c._fields:
                got, want = getattr(c, name), getattr(jc, name)
                assert got.dtype == (torch.float32 if name == "ssm" else torch.bfloat16)
                tol = TOL if name == "ssm" else BF16_ULP
                np.testing.assert_allclose(_f32(got), _f32(want), err_msg=f"{i} {sub} {name}",
                                           **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    cfg, jmodel, jparams, lm = _port(arch)
    jt, tt = _tokens(cfg, 2, _prefill_seq(arch), seed=17)
    logits, caches = build_prefill_step(lm)({"tokens": tt})
    exp, jcaches = jax.jit(jmodel.prefill)(jparams, {"tokens": jt})
    assert logits.shape == (2, 1, cfg.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(_f32(logits), _f32(exp), **TOL)
    _compare_caches(caches, jcaches, cfg.n_blocks)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_steps_match_jax(arch):
    """serve()'s refill: the prompt one token at a time into a fixed-size
    cache, each step's logits against the JAX decode_step's."""
    cfg, jmodel, jparams, lm = _port(arch)
    seq, smax = 24, 28
    jt, tt = _tokens(cfg, 2, seq, seed=18)
    jstep, tstep = jax.jit(jmodel.decode_step), build_decode_step(lm)
    jcache, tcache = jmodel.init_cache(2, smax), lm.init_cache(2, smax)
    for t in range(seq):
        exp, jcache = jstep(jparams, jcache, jt[:, t:t + 1], jnp.int32(t))
        got, tcache = tstep(tcache, tt[:, t:t + 1], t)
        np.testing.assert_allclose(_f32(got), _f32(exp), err_msg=f"step {t}", **FLIP_TOL)
    _compare_caches(tcache, jcache, cfg.n_blocks)


def test_serving_steps_record_no_graph():
    """The serving steps run under no_grad: no logits carry a graph."""
    cfg, _, _, lm = _port("mistral-nemo-12b")
    _, tt = _tokens(cfg, 2, 8, seed=19)
    logits, caches = build_prefill_step(lm)({"tokens": tt})
    assert not logits.requires_grad
    assert not any(t.requires_grad for c in caches for kv in c.values() for t in kv)
    out, _ = build_decode_step(lm)(lm.init_cache(2, 9), tt[:, :1], 0)
    assert not out.requires_grad


# ---------------------------------------------------------------------------
# The serving entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "gemma2-9b", "mamba2-1.3b"])
def test_serve_on_cpu_shapes_and_determinism(arch):
    kw = dict(batch=2, prompt_len=16, new_tokens=4, seed=5, device="cpu")
    a = tserve.serve(arch, **kw)
    b = tserve.serve(arch, **kw)
    c = tserve.serve(arch, **{**kw, "seed": 6})
    cfg = t_get_smoke_config(arch)
    assert a["tokens"].shape == (2, 5) and a["tokens"].dtype == np.int32
    assert a["prompt"].shape == (2, 16) and a["prompt"].dtype == np.int32
    np.testing.assert_array_equal(a["prompt"], b["prompt"])
    assert ((0 <= a["tokens"]) & (a["tokens"] < cfg.vocab_size)).all()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tok_per_s"] > 0 and a["prefill_ms"] > 0 and a["teacher_ms"] > 0
    # The prefill and the teacher-forced refill see the same prompt.
    assert a["prefill_logits"].shape == a["teacher_logits"].shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_f32(a["teacher_logits"]), _f32(a["prefill_logits"]),
                               atol=2e-2, rtol=2e-2)


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", "mamba2-1.3b", "--device", "cpu", "--batch", "2",
                 "--prompt-len", "16", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "decoded (2, 4)" in out and "prefill" in out
