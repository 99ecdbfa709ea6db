"""Moonlight-16B-A3B (DeepSeek-V3's block) in the port against its plain
reference (``models/plain_moonlight.py``) on the CPU, at the smoke config's
small widths in float32 with seeded random weights: latent attention, the
dropless MoE and the dense first block, the whole model's loss and
gradients through ``build_hapi_train_step``, the plain flash at (192, 128),
routing (no token dropped, ties), and each planted departure seen.

The JAX package has no such model: nothing here compares with it.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.config import HapiConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs import ARCH_IDS, PORT_ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.tier_split import plan_tiers
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import plain_moonlight as P
from repro_torch.models.api import build_model
from repro_torch.obs import program
from repro_torch.train.steps import build_hapi_train_step, init_train_state

ARCH = "moonlight-16b-a3b"
TOL = 1e-5          # relative L2, f32 against f32
SEED = 2**31 + 7


def rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def bias_pattern(n: int) -> torch.Tensor:
    """A correction bias the size of the scores' spread, so that a program
    ignoring it routes otherwise."""
    return 0.1 * torch.sin(2.0 * torch.arange(n, dtype=torch.float32) + 0.5)


def model(cfg=None, seed: int = SEED):
    cfg = cfg or get_smoke_config(ARCH)
    lm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, buf in lm.named_buffers():
            if name.endswith("e_score_correction_bias"):
                buf.copy_(bias_pattern(buf.numel()))
    return lm


def weights(lm):
    return {k: v.detach() for k, v in lm.state_dict().items()}


def tokens(cfg, b=2, s=24, seed=1):
    return torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator().manual_seed(seed))


def hidden(cfg, b=2, s=24, seed=3):
    return torch.randn(b, s, cfg.d_model, generator=torch.Generator().manual_seed(seed))


def test_registry_keeps_the_ten_jax_architectures_apart():
    assert len(ARCH_IDS) == 10 and ARCH not in ARCH_IDS and PORT_ARCH_IDS == [ARCH]
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.qk_head_dim,
            cfg.v_head_dim, cfg.n_experts, cfg.top_k, cfg.n_shared_experts, cfg.d_ff_dense) == \
        (27, 2048, 16, 512, 192, 128, 64, 6, 2, 11264)
    assert 15.9e9 < cfg.param_count() < 16.0e9
    small = get_smoke_config(ARCH)
    assert small.is_mla and small.first_k_dense == 1 and small.router == "sigmoid_bias"
    # Every other config keeps the defaults' behaviour.
    for arch in ARCH_IDS:
        c = get_config(arch)
        assert not c.is_mla and c.router == "softmax"
        assert c.qk_head_dim == c.hdim


@pytest.mark.parametrize("part", ["mla", "moe", "dense_block"])
def test_part_matches_the_plain_reference(part):
    lm = model()
    cfg, w = lm.cfg, weights(lm)
    x = hidden(cfg)
    with torch.no_grad():
        if part == "mla":
            sub = lm.blocks[1].sub0
            got, want = L.mla_apply(sub.attn, x, cfg), P.mla(w, "blocks.1.sub0.", x, cfg)
        elif part == "moe":
            sub = lm.blocks[2].sub0
            got = L.deepseek_moe_apply(sub.moe, x, cfg)
            want = P.moe(w, "blocks.2.sub0.", x, cfg)
        else:
            positions = torch.arange(x.shape[1])[None, :]
            got, want = lm.blocks[0](x, positions), P.block(w, 0, x, cfg)
    assert got.shape == want.shape
    assert rel(got, want) < TOL


def test_loss_and_gradients_through_the_hapi_step():
    lm = model()
    cfg = lm.cfg
    w = {k: v.clone() for k, v in weights(lm).items()}
    toks = tokens(cfg, b=4, s=16)
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 16, 4),
                   hapi=HapiConfig(cos_batch=2, cos_batch_min=1),
                   train=TrainConfig(microbatch=2, warmup_steps=1, grad_clip=0.0))
    plan = plan_tiers(cfg, rc.shape, rc.hapi)
    assert plan.split == 2 and plan.cos_batch == 2 and not plan.compress
    state = init_train_state(lm, rc, plan)
    step = build_hapi_train_step(lm, rc, plan)
    state, metrics = step(state, {"tokens": toks, "labels": toks})
    got = {f"blocks.{int(k.split('.')[1]) + plan.split}.{k.split('.', 2)[2]}"
           if k.startswith("blocks.") else k: m / (1 - rc.train.beta1)
           for k, m in state.opt.m.items()}
    live = {k: w[k].clone().requires_grad_() for k in got}
    # The step's loss is the mean over its two chunks of each chunk's mean.
    total = sum(P.loss({**w, **live}, toks[i:i + 2], cfg) for i in (0, 2)) / 2
    grads = dict(zip(live, torch.autograd.grad(total, list(live.values()))))
    total = float(total.detach())
    assert abs(float(metrics["loss"]) - total) < TOL * total
    assert any(k.endswith("moe.router") for k in got) and "unembed" in got
    for k, g in grads.items():
        assert rel(got[k], g) < 1e-4, k


def test_flash_plain_version_at_192_128():
    g = torch.Generator().manual_seed(5)
    q, k = (torch.randn(2, 40, 3, 192, generator=g) for _ in range(2))
    v = torch.randn(2, 40, 3, 128, generator=g)
    dout = torch.randn(2, 40, 3, 128, generator=g)
    got_in = [t.clone().requires_grad_() for t in (q, k, v)]
    want_in = [t.clone().requires_grad_() for t in (q, k, v)]
    got = ops.flash_attention(*got_in, causal=True)
    want = P.attention(*want_in, 1.0 / math.sqrt(192))
    assert got.shape == (2, 40, 3, 128) and rel(got, want) < TOL
    got_g = torch.autograd.grad(got, got_in, dout)
    want_g = torch.autograd.grad(want, want_in, dout)
    for a, b in zip(got_g, want_g):
        assert a.shape == b.shape and rel(a, b) < TOL


def test_no_token_is_dropped_when_every_token_picks_one_expert():
    lm = model()
    cfg = lm.cfg
    moe = lm.blocks[1].sub0.moe
    with torch.no_grad():
        moe.e_score_correction_bias.zero_()
        moe.e_score_correction_bias[3] = 10.0
    x = hidden(cfg, b=2, s=32)
    r = L.deepseek_route(moe, x.reshape(-1, cfg.d_model), cfg)
    assert int(r.counts[3]) == 64 and int(r.counts.sum()) == 64 * cfg.top_k
    assert (r.top_e[:, 0] == 3).all()
    with torch.no_grad():
        got = L.deepseek_moe_apply(moe, x, cfg)
    assert rel(got, P.moe(weights(lm), "blocks.1.sub0.", x, cfg)) < TOL


def test_ties_go_to_the_lower_expert():
    lm = model()
    cfg = lm.cfg
    moe = lm.blocks[1].sub0.moe
    with torch.no_grad():
        moe.router.zero_()
        moe.e_score_correction_bias.zero_()
        moe.e_score_correction_bias[5] = 0.5      # one clear winner, the rest tied
    r = L.deepseek_route(moe, hidden(cfg).reshape(-1, cfg.d_model), cfg)
    assert (r.top_e == torch.tensor([5, 0])).all()
    # Every weight is s = sigmoid(0) = 0.5, renormalised and scaled.
    assert torch.allclose(r.weight, torch.full_like(r.weight, cfg.routed_scaling_factor / 2))


@pytest.mark.parametrize("variant", P.VARIANTS)
def test_each_planted_departure_fails_the_tolerance(variant):
    lm = model()
    cfg, w = lm.cfg, weights(lm)
    toks = tokens(cfg)
    with torch.no_grad():
        got = lm.blocks[2](lm.blocks[1](lm.blocks[0](
            P.embed(w, toks, cfg), torch.arange(24)[None]), torch.arange(24)[None]),
            torch.arange(24)[None])
        assert rel(got, P.forward(w, toks, cfg)) < TOL
        assert rel(got, P.forward(w, toks, cfg, variant=variant)) > 100 * TOL


def test_two_calls_give_the_same_bits():
    lm = model()
    cfg = lm.cfg
    x = hidden(cfg).requires_grad_()
    outs = []
    for _ in range(2):
        y = L.deepseek_moe_apply(lm.blocks[1].sub0.moe, x, cfg)
        (gx,) = torch.autograd.grad(y.square().sum(), x)
        outs.append((y.detach(), gx))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_spans_and_counters_of_the_new_layers():
    lm = model()
    cfg = lm.cfg
    toks = tokens(cfg)
    with program.tracing() as tr, torch.no_grad():
        lm({"tokens": toks})
        names = {s.name for s in tr.spans}
        s = program.summary()
    assert {"attn.mla", "moe.route", "moe.experts", "moe.combine"} <= names
    assert s["counters"]["moe_routed_rows_total"] == 2 * toks.numel() * cfg.top_k
    assert s["moe_imbalance"] >= 1.0
    # Off, nothing is recorded.
    program.EXPERT_LOADS.clear()
    with torch.no_grad():
        lm({"tokens": toks})
    assert not program.EXPERT_LOADS


def test_the_cut_plans_as_the_cell_states():
    cfg = dataclasses.replace(get_config(ARCH), n_layers=8)
    plan = plan_tiers(cfg, ShapeConfig("t", "train", 4096, 4),
                      HapiConfig(compress_transfer=True, cos_batch=2, cos_batch_min=1))
    assert (plan.split, plan.cos_batch, plan.compress) == (6, 2, True)
    assert cfg.param_count() == pytest.approx(4.85e9, rel=0.01)


def test_serving_and_sharding_refuse_the_model():
    lm = model()
    with pytest.raises(NotImplementedError, match="decode cache"):
        lm.init_cache(1, 8)
    with pytest.raises(NotImplementedError, match="decode cache"):
        lm.prefill({"tokens": tokens(lm.cfg)})


@pytest.mark.parametrize("which", ["dryrun", "tierdry"])
def test_the_dry_runs_refuse_the_model(which):
    from repro_torch.launch import dryrun, tierdry
    with pytest.raises(NotImplementedError, match="not sharded"):
        if which == "dryrun":
            dryrun.lower_cell(ARCH, "train_4k")
        else:
            tierdry.lower_tier_cell(ARCH)
