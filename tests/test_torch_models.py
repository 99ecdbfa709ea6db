"""The port's model modules against the JAX package's, on the CPU.

Weights come from the JAX smoke models through ``convert.params_from_jax``;
inputs are made with numpy from a seed and go through both packages.
Tolerances are for float32 (the smoke configs' dtype), set by the summation
order: XLA and PyTorch reduce in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model
from repro_torch.models.transformer import merge_params

ARCHS = ["mistral-nemo-12b", "qwen3-32b", "gemma2-9b", "moonshot-v1-16b-a3b", "grok-1-314b",
         "jamba-v0.1-52b"]
TOL = dict(atol=2e-4, rtol=2e-4)


def _port(arch):
    """The port's smoke model with the JAX smoke model's weights."""
    cfg, jmodel, jparams = smoke_model(arch)
    tcfg = t_get_smoke_config(arch)
    assert tcfg == type(tcfg)(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    lm = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    lm.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jparams)))
    return cfg, jmodel, jparams, lm


def _batch(cfg, batch, seq, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, seq), np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)},
            {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(toks).long()})


def _seq(arch):
    # gemma2's local layers take JAX's windowed path only where window +
    # q_block < seq (layers.py:163); at seq 1024 both packages window.
    return 1024 if arch == "gemma2-9b" else 32


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def test_configs_are_copies():
    from repro.configs import ARCH_IDS, get_config

    for arch in ARCH_IDS:
        j, t = get_config(arch), t_get_config(arch)
        assert {f: getattr(j, f) for f in j.__dataclass_fields__} == \
            {f: getattr(t, f) for f in j.__dataclass_fields__}
        # The port's own fields (latent attention and DeepSeek-V3's MoE, for
        # its Moonlight config) hold their defaults in every JAX architecture.
        extra = set(t.__dataclass_fields__) - set(j.__dataclass_fields__)
        assert extra and all(getattr(t, f) == t.__dataclass_fields__[f].default for f in extra)
        assert (j.param_count(), j.n_blocks, j.freeze_index) == \
            (t.param_count(), t.n_blocks, t.freeze_index)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    x = np.random.default_rng(0).standard_normal((2, 8, 64)).astype(np.float32)
    scale = np.random.default_rng(1).standard_normal(64).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = TL.rmsnorm(torch.from_numpy(scale), torch.from_numpy(x).to(td), 1e-6)
    exp = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x).astype(jd), 1e-6)
    assert got.dtype == td
    tol = 1e-6 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(exp, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope(theta):
    x = np.random.default_rng(2).standard_normal((2, 64, 4, 16)).astype(np.float32)
    pos = np.arange(64)[None, :]
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    exp = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch,window,seq", [("mistral-nemo-12b", None, 32),
                                             ("qwen3-32b", None, 32),
                                             ("gemma2-9b", 16, 1024)])
def test_attention_apply(arch, window, seq):
    cfg, _, jparams, lm = _port(arch)
    jattn = jax.tree.map(lambda a: a[0], jparams["blocks"]["sub0"]["attn"])
    x = np.random.default_rng(3).standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    got = TL.attention_apply(lm.blocks[0].sub0.attn, torch.from_numpy(x), lm.cfg,
                             window=window)
    exp = JL.attention_apply(jattn, jnp.asarray(x), cfg, window=window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), **TOL)


def test_mlp_apply():
    cfg, _, jparams, lm = _port("mistral-nemo-12b")
    jmlp = jax.tree.map(lambda a: a[1], jparams["blocks"]["sub0"]["mlp"])
    x = np.random.default_rng(4).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    got = TL.mlp_apply(lm.blocks[1].sub0.mlp, torch.from_numpy(x))
    exp = JL.mlp_apply(jmlp, jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(exp), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(arch):
    cfg, jmodel, jparams, lm = _port(arch)
    jb, tb = _batch(cfg, 2, _seq(arch), seed=5)
    with torch.no_grad():
        logits = lm(tb)
        loss = float(lm.loss(tb))
    exp = jax.jit(jmodel.forward)(jparams, jb)
    assert logits.dtype == torch.float32 and logits.shape == exp.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(exp), **TOL)
    assert loss == pytest.approx(float(jax.jit(jmodel.loss)(jparams, jb)), abs=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefix_every_split_matches_jax(arch):
    cfg, jmodel, jparams, lm = _port(arch)
    jb, tb = _batch(cfg, 2, _seq(arch), seed=6)
    for split in range(1, cfg.n_blocks):
        jfrozen, _ = jmodel.split_params(jparams, split)
        frozen, _ = lm.split_params(split)
        with torch.no_grad():
            acts = frozen(tb)
        exp = jmodel.forward_prefix(jfrozen, jb, split)
        np.testing.assert_allclose(acts.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_split_consistency_every_boundary(arch):
    """loss == loss_suffix(forward_prefix) at every block boundary."""
    cfg, _, _, lm = _port(arch)
    _, tb = _batch(cfg, 2, 32, seed=7)
    with torch.no_grad():
        ref = float(lm.loss(tb))
        for split in range(1, cfg.n_blocks):
            frozen, trainable = lm.split_params(split)
            got = float(trainable.loss(frozen(tb), tb))
            assert got == pytest.approx(ref, abs=1e-5), (arch, split)


def test_tied_embeddings_untie_at_split():
    """gemma2 ties its embeddings: the suffix gets a copy of the head."""
    _, _, _, lm = _port("gemma2-9b")
    assert lm.unembed is None
    frozen, trainable = lm.split_params(1)
    assert trainable.unembed is not lm.embed
    assert torch.equal(trainable.unembed, lm.embed)
    merged = merge_params(frozen, trainable)
    assert merged.unembed is trainable.unembed
    assert [id(b) for b in merged.blocks] == [id(b) for b in lm.blocks]


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch):
    _, _, jparams, lm = _port(arch)
    tree = jax.tree.map(np.asarray, jparams)
    back = convert.params_to_jax(lm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    sd = convert.params_from_jax(back)
    assert sd.keys() == lm.state_dict().keys()
    for k, v in lm.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_convert_bf16_goes_through_f32_exactly():
    vals = np.random.default_rng(8).standard_normal((3, 5)).astype(np.float32)
    jbf = jnp.asarray(vals).astype(jnp.bfloat16)
    t = convert.params_from_jax({"embed": np.asarray(jbf)})["embed"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(jbf, np.float32))
    np.testing.assert_array_equal(convert.params_to_jax({"embed": t})["embed"],
                                  np.asarray(jbf, np.float32))


def test_build_initialises_from_the_generator():
    cfg = t_get_smoke_config("mistral-nemo-12b")
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))
    assert not torch.equal(a.blocks[0].sub0.attn.wq, c.blocks[0].sub0.attn.wq)
    # Fan-in normal init and the 0.02 embedding, as in the JAX package.
    wq = a.blocks[0].sub0.attn.wq.detach()
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.1
    assert abs(float(a.embed.detach().std()) - 0.02) < 0.002
