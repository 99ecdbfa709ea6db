"""The port's MoE FFN against the JAX package's, on the CPU.

``moe_apply`` is held to ``repro.models.layers.moe_apply`` on the same
weights (``convert.params_from_jax``) and inputs (numpy, from a seed): f32
to 1e-5, bf16 to 2e-2, at capacity 8.0 (nothing drops) and 1.25 (the later
tokens of an over-full expert drop). The routing is held exactly: the top-k
experts and which slots each expert's buffer keeps, against the reference's
own steps (``layers.py:370-391``) run in JAX below.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import layers as JL
from repro.models.api import build_model as j_build_model
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import tier_split as tts
from repro_torch.core.splitter import SplitDecision
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model

MOE_ARCHS = ["moonshot-v1-16b-a3b", "grok-1-314b", "jamba-v0.1-52b"]
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _cfgs(arch, capacity, dtype):
    kw = dict(capacity_factor=capacity, param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(j_get_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _moe(arch, capacity=8.0, dtype="float32", seed=0):
    """(JAX config, JAX params, port config, port MoE with those weights)."""
    jcfg, tcfg = _cfgs(arch, capacity, dtype)
    jp = JL.moe_init(jax.random.PRNGKey(seed), jcfg)
    m = TL.MoE(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    m.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jp)))
    return jcfg, jp, tcfg, m


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _jax_routing(params, x, cfg):
    """The reference's dispatch steps (``repro/models/layers.py:370-391``):
    top-k experts, and the token and validity of each buffer slot."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = min(int(cfg.capacity_factor * s * k / e + 1), s)
    probs = jax.nn.softmax(jnp.einsum("bsd,de->bse", x.astype(jnp.float32),
                                      params["router"]), axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat_e = top_e.reshape(b, s * k)
    slot_tok = jnp.tile(jnp.arange(s)[:, None], (1, k)).reshape(s * k)
    sort_idx = jnp.argsort(flat_e, axis=-1, stable=True)
    sorted_tok = slot_tok[sort_idx]
    counts = jax.nn.one_hot(flat_e, e, dtype=jnp.int32).sum(axis=1)
    offsets = jnp.cumsum(counts, axis=-1) - counts
    grid_c = jnp.arange(cap)[None, None, :]
    valid = grid_c < counts[:, :, None]
    gather_pos = jnp.clip(offsets[:, :, None] + grid_c, 0, s * k - 1)
    buf_tok = jax.vmap(lambda st, gp: st[gp])(sorted_tok, gather_pos)
    return np.asarray(top_e), np.asarray(buf_tok), np.asarray(valid), cap


def _kept_pairs(buf_tok, valid):
    """{(row, token, expert)} the buffers hold."""
    b, e, c = np.nonzero(valid)
    return set(zip(b.tolist(), buf_tok[b, e, c].tolist(), e.tolist()))


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity", [8.0, 1.25])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_jax(arch, capacity, dtype):
    jcfg, jp, tcfg, m = _moe(arch, capacity, dtype)
    jx, tx = _x((3, 40, jcfg.d_model), dtype, seed=1)
    with torch.no_grad():
        got = TL.moe_apply(m, tx, tcfg)
        r = TL.moe_route(m, tx, tcfg)
    exp = JL.moe_apply(jp, jx, jcfg)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_f32(got), _f32(exp), **TOL[dtype])

    top_e, buf_tok, valid, cap = _jax_routing(jp, jx, jcfg)
    assert r.cap == cap
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    np.testing.assert_array_equal(r.valid.numpy(), valid)
    np.testing.assert_array_equal(np.where(valid, r.buf_tok.numpy(), -1),
                                  np.where(valid, buf_tok, -1))
    # The slots a token keeps are the pairs the buffers hold.
    bb, ss, kk = np.nonzero(r.kept.numpy())
    assert set(zip(bb.tolist(), ss.tolist(), r.top_e.numpy()[bb, ss, kk].tolist())) == \
        _kept_pairs(buf_tok, valid)
    dropped = int((~r.kept).sum())
    if capacity == 8.0:
        assert dropped == 0
    else:
        assert dropped > 0, "the published capacity must drop slots at this size"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_all_ties_pick_jax_experts(dtype):
    """A zero router gives every expert the same probability: JAX's top_k
    takes experts 0..k-1 (torch.topk would not), and the outputs agree."""
    jcfg, jp, tcfg, m = _moe("moonshot-v1-16b-a3b", 1.25, dtype)
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    with torch.no_grad():
        m.router.zero_()
    jx, tx = _x((2, 24, jcfg.d_model), dtype, seed=2)
    with torch.no_grad():
        r = TL.moe_route(m, tx, tcfg)
        got = TL.moe_apply(m, tx, tcfg)
    k = tcfg.top_k
    assert (r.top_e == torch.arange(k)).all()
    np.testing.assert_array_equal(r.top_e.numpy(), _jax_routing(jp, jx, jcfg)[0])
    # Every token picks the same experts, so the buffers fill in token order
    # and tokens from cap onwards drop.
    assert (r.kept[:, :r.cap]).all() and not (r.kept[:, r.cap:]).any()
    np.testing.assert_allclose(_f32(got), _f32(JL.moe_apply(jp, jx, jcfg)), **TOL[dtype])


def test_moe_partial_ties_take_the_lower_expert():
    """Probabilities .1 .3 .3 .2 .3 ...: JAX takes experts 1 and 2, and so
    does the port (torch.topk takes 1 and 4)."""
    jcfg, jp, tcfg, m = _moe("moonshot-v1-16b-a3b")
    probs = np.array([.1, .3, .3, .2, .3, .05, .05, .05], np.float32)
    router = np.zeros((jcfg.d_model, jcfg.n_experts), np.float32)
    router[0] = np.log(probs)
    jp = {**jp, "router": jnp.asarray(router)}
    m.router.data = torch.from_numpy(router)
    x = np.zeros((1, 3, jcfg.d_model), np.float32)
    x[..., 0] = 1.0
    with torch.no_grad():
        r = TL.moe_route(m, torch.from_numpy(x), tcfg)
    want = _jax_routing(jp, jnp.asarray(x), jcfg)[0]
    assert want[0, 0].tolist() == [1, 2]
    np.testing.assert_array_equal(r.top_e.numpy(), want)


def test_moe_dropped_token_gets_nothing():
    """A token whose every slot was dropped leaves the MoE with zeros."""
    _, _, tcfg, m = _moe("moonshot-v1-16b-a3b", 1.25)
    with torch.no_grad():
        m.router.zero_()
        _, tx = _x((1, 24, tcfg.d_model), "float32", seed=3)
        r = TL.moe_route(m, tx, tcfg)
        y = TL.moe_apply(m, tx, tcfg)
    gone = ~r.kept.any(-1)
    assert gone.any() and not bool(y[gone].any())
    assert bool(y[~gone].abs().sum(-1).gt(0).all())


def test_moe_is_deterministic_and_rows_are_independent():
    """Two calls give the same bits; each batch row routes on its own, so a
    row's output does not depend on the rows beside it."""
    _, _, tcfg, m = _moe("moonshot-v1-16b-a3b", 1.25)
    _, tx = _x((4, 32, tcfg.d_model), "float32", seed=4)
    with torch.no_grad():
        a, b = TL.moe_apply(m, tx, tcfg), TL.moe_apply(m, tx, tcfg)
        rows = torch.cat([TL.moe_apply(m, tx[i:i + 1], tcfg) for i in range(4)])
    assert torch.equal(a, b)
    torch.testing.assert_close(rows, a, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_aux_loss_matches_jax(arch):
    jcfg, jp, tcfg, m = _moe(arch, seed=5)
    jx, tx = _x((2, 33, jcfg.d_model), "float32", seed=5)
    with torch.no_grad():
        got = float(TL.moe_aux_loss(m, tx, tcfg))
    assert got == pytest.approx(float(JL.moe_aux_loss(jp, jx, jcfg)), abs=1e-6)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_follow_moe_init(arch):
    """Names and shapes of moe_init; the router f32 in a bf16 model, the
    experts bf16; fan-in scaled init."""
    jcfg, tcfg = _cfgs(arch, 1.25, "bfloat16")
    jp = JL.moe_init(jax.random.PRNGKey(0), jcfg)
    m = TL.MoE(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for name, t in m.named_parameters():
        t = t.detach()
        assert tuple(t.shape) == jp[name].shape, name
        assert t.dtype == (torch.float32 if name == "router" else torch.bfloat16), name
    assert abs(float(m.w_gate.detach().float().std()) * tcfg.d_model ** 0.5 - 1.0) < 0.1
    assert abs(float(m.w_down.detach().float().std()) * tcfg.d_ff ** 0.5 - 1.0) < 0.1


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_bf16_model_converts_both_ways_exactly(arch):
    """The JAX model in bf16: experts stacked (n_blocks, E, d, f) in bf16 and
    the router in f32 load into the port with their dtypes and bits, and
    come back equal (``params_to_jax`` gives bf16 as f32, the router f32)."""
    jcfg = dataclasses.replace(j_get_smoke_config(arch), param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    jparams = j_build_model(jcfg).init(jax.random.PRNGKey(6))
    moe_subs = [s for s, p in jparams["blocks"].items() if "moe" in p]
    assert moe_subs
    for sub in moe_subs:
        moe = jparams["blocks"][sub]["moe"]
        assert moe["router"].dtype == jnp.float32 and moe["w_gate"].dtype == jnp.bfloat16
        assert moe["w_gate"].shape == (jcfg.n_blocks, jcfg.n_experts, jcfg.d_model, jcfg.d_ff)
        assert moe["w_down"].shape == (jcfg.n_blocks, jcfg.n_experts, jcfg.d_ff, jcfg.d_model)
    cfg = dataclasses.replace(get_smoke_config(arch), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    lm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(6))
    sd = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    for k, v in lm.state_dict().items():
        assert sd[k].dtype == v.dtype, k
    assert lm.state_dict()[f"blocks.0.{moe_subs[0]}.moe.router"].dtype == torch.float32
    lm.load_state_dict(sd)
    back = convert.params_to_jax(lm.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))
    for sub in moe_subs:
        assert back["blocks"][sub]["moe"]["router"].dtype == np.float32


# ---------------------------------------------------------------------------
# The tier split at COS-batch granularity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_cos_batch_does_not_change_moe_boundaries(arch):
    """Paper §5.1: the feature-extraction batch size does not change the
    boundary, for MoE too (groups are batch rows)."""
    _, _, jparams = smoke_model(arch)
    lm = build_model(get_smoke_config(arch), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    lm.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jparams)))
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 512, (8, 32))).long()
    frozen, _ = lm.split_params(1)
    outs = []
    for cb in (1, 2, 4, 8):
        plan = tts.TierPlan(1, cb, False, SplitDecision(1, 0, 0, [], "t"))
        outs.append(tts.make_extract_fn(plan)(frozen, {"tokens": toks, "labels": toks}))
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=1e-5, rtol=1e-5)
