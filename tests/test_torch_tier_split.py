"""The port's planner and tier split against the JAX package's, on the CPU.

The planner (profile, Alg. 1, Eq. 4, plan) is pure arithmetic: the port must
take the same decisions as the reference, exactly. The executable halves
(extract, tune_loss) must give the reference's loss and put the same number
of bytes on the wire.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.config import HapiConfig as JHapi
from repro.config import ShapeConfig as JShape
from repro.configs import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.core import batch_adapt as jba
from repro.core import profiler as jprof
from repro.core import splitter as jspl
from repro.core import tier_split as jts
from repro_torch import convert
from repro_torch.config import HW, HapiConfig, ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import batch_adapt as tba
from repro_torch.core import profiler as tprof
from repro_torch.core import splitter as tspl
from repro_torch.core import tier_split as tts
from repro_torch.models.api import build_model


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _synth(mod, out_bytes, input_bytes, freeze):
    n = len(out_bytes)
    return mod.LayerProfile(
        name="synth", n_boundaries=n + 1, input_bytes=input_bytes,
        out_bytes=[input_bytes] + list(out_bytes),
        cum_flops=[0.0] + [1e9 * (i + 1) for i in range(n)],
        act_peak_bytes=[input_bytes] * (n + 1),
        prefix_param_bytes=[1e6 * i for i in range(n + 1)],
        model_param_bytes=1e6 * n,
        freeze_index=freeze,
    )


OUT = [9e6, 8e6, 5e6, 3e6, 2e6, 1e6, 9e5, 5e5]   # test_splitter.py's profile


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------
def test_hardware_is_the_h100():
    assert (HW.peak_flops_bf16, HW.hbm_bandwidth, HW.hbm_capacity) == (989e12, 3.35e12, 80e9)
    assert HapiConfig().cos_hbm_budget == 80e9
    assert HapiConfig().cos_batch_min == JHapi().cos_batch_min == 32


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_profile_lm_matches_jax(arch):
    assert _fields(tprof.profile_lm(get_config(arch), 4096)) == \
        _fields(jprof.profile_lm(j_get_config(arch), 4096))


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("batch", [10, 100, 200, 1000])
@pytest.mark.parametrize("gbps", [0.05, 0.5, 1, 3, 10])
def test_choose_split_matches_jax(gbps, batch, compress):
    kw = dict(network_bandwidth=gbps * 1e9 / 8, compress_transfer=compress)
    got = tspl.choose_split(_synth(tprof, OUT, 1e7, 8), HapiConfig(**kw), batch)
    exp = jspl.choose_split(_synth(jprof, OUT, 1e7, 8), JHapi(**kw), batch)
    assert _fields(got) == _fields(exp)


def test_choose_split_random_profiles_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(2, 30))
        out = list(10 ** rng.uniform(3, 8, n))
        inp = float(10 ** rng.uniform(3, 8))
        freeze = max(1, n * 3 // 4)
        kw = dict(network_bandwidth=float(10 ** rng.uniform(6, 10)),
                  compress_transfer=bool(rng.integers(2)))
        batch = int(rng.integers(1, 8192))
        got = tspl.choose_split(_synth(tprof, out, inp, freeze), HapiConfig(**kw), batch)
        exp = jspl.choose_split(_synth(jprof, out, inp, freeze), JHapi(**kw), batch)
        assert _fields(got) == _fields(exp)
        assert tspl.candidate_boundaries(_synth(tprof, out, inp, freeze)) == \
            jspl.candidate_boundaries(_synth(jprof, out, inp, freeze))


def test_adapt_batches_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(200):
        n = int(rng.integers(0, 12))
        reqs = [(i, float(10 ** rng.uniform(3, 9)), float(rng.uniform(0, 8e9)),
                 int(rng.integers(1, 8192)), 0, float(rng.choice([1.0, 2.0, 4.0])))
                for i in range(n)]
        budget, b_min = float(10 ** rng.uniform(6, 10.8)), int(rng.integers(1, 256))
        got = tba.adapt_batches([tba.AdaptRequest(*r) for r in reqs], budget, b_min=b_min)
        exp = jba.adapt_batches([jba.AdaptRequest(*r) for r in reqs], budget, b_min=b_min)
        assert [tuple(a) for a in got.assignments] == [tuple(a) for a in exp.assignments]
        assert (got.dropped, got.mem_used, got.budget) == (exp.dropped, exp.mem_used, exp.budget)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen3-32b", "gemma2-9b", "mamba2-1.3b",
                                  "moonshot-v1-16b-a3b", "jamba-v0.1-52b",
                                  "llava-next-mistral-7b", "whisper-small"])
@pytest.mark.parametrize("budget", [1e6, 1e9, 16e9, 80e9, 1e12])
@pytest.mark.parametrize("smoke", [True, False])
def test_plan_tiers_matches_jax(arch, budget, smoke):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    jcfg = j_get_smoke_config(arch) if smoke else j_get_config(arch)
    seq, gb = (64, 32) if smoke else (4096, 256)
    kw = dict(cos_hbm_budget=budget, cos_batch_min=1, compress_transfer=True)
    got = tts.plan_tiers(cfg, ShapeConfig("t", "train", seq, gb), HapiConfig(**kw),
                         local_batch=gb)
    exp = jts.plan_tiers(jcfg, JShape("t", "train", seq, gb), JHapi(**kw), local_batch=gb)
    assert (got.split, got.cos_batch, got.compress) == (exp.split, exp.cos_batch, exp.compress)
    assert _fields(got.decision) == _fields(exp.decision)
    assert gb % got.cos_batch == 0


def test_mistral_slice_plan_and_wire_bytes():
    """The full-width request of the card's smoke run: split 30, COS batch 2,
    86,507,520 bytes on the wire, as Alg. 1 predicts."""
    cfg = get_config("mistral-nemo-12b")
    hapi = HapiConfig(compress_transfer=True, cos_batch=2, cos_batch_min=1)
    plan = tts.plan_tiers(cfg, ShapeConfig("slice", "train", 4096, 4), hapi)
    assert (plan.split, plan.cos_batch, plan.compress) == (30, 2, True)
    exp = jts.plan_tiers(j_get_config("mistral-nemo-12b"), JShape("slice", "train", 4096, 4),
                         JHapi(compress_transfer=True, cos_batch=2, cos_batch_min=1,
                               cos_hbm_budget=80e9))
    assert (plan.split, plan.cos_batch) == (exp.split, exp.cos_batch)
    acts = (torch.empty(4, 4096, 5120, dtype=torch.int8, device="meta"),
            torch.empty(4, 4096, 40, dtype=torch.float32, device="meta"))
    assert tts.wire_bytes(acts) == 83_886_080 + 2_621_440 == 86_507_520
    assert plan.decision.wire_bytes_per_iter == 86_507_520


def test_moonshot_slice_plan_and_wire_bytes():
    """The MoE pushdown of the card's smoke run: moonshot-v1-16b-a3b at
    2 x 4,096 splits at its freeze index 36 with COS batch 1, as the JAX
    package plans it, and puts 16,777,216 + 524,288 bytes on the wire."""
    hapi = HapiConfig(compress_transfer=True, cos_batch=1, cos_batch_min=1)
    plan = tts.plan_tiers(get_config("moonshot-v1-16b-a3b"), ShapeConfig("slice", "train", 4096, 2),
                          hapi)
    exp = jts.plan_tiers(j_get_config("moonshot-v1-16b-a3b"), JShape("slice", "train", 4096, 2),
                         JHapi(compress_transfer=True, cos_batch=1, cos_batch_min=1,
                               cos_hbm_budget=80e9))
    assert (plan.split, plan.cos_batch, plan.compress) == (36, 1, True)
    assert (exp.split, exp.cos_batch) == (36, 1)
    acts = (torch.empty(2, 4096, 2048, dtype=torch.int8, device="meta"),
            torch.empty(2, 4096, 16, dtype=torch.float32, device="meta"))
    assert tts.wire_bytes(acts) == 16_777_216 + 524_288 == 17_301_504
    assert plan.decision.wire_bytes_per_iter == exp.decision.wire_bytes_per_iter == 17_301_504


@pytest.mark.parametrize("n,cap", [(16, 12), (16, 16), (7, 3), (12, 5), (8, 1), (4, 9)])
def test_largest_divisor_matches_jax(n, cap):
    assert tts.largest_divisor_leq(n, cap) == jts.largest_divisor_leq(n, cap)


# ---------------------------------------------------------------------------
# Executable halves
# ---------------------------------------------------------------------------
def _plans(split, cos_batch, compress):
    dec = tspl.SplitDecision(split, 0, 0, [], "t")
    jdec = jspl.SplitDecision(split, 0, 0, [], "t")
    return (tts.TierPlan(split, cos_batch, compress, dec),
            jts.TierPlan(split, cos_batch, compress, jdec))


def _port(arch):
    cfg, jmodel, jparams = smoke_model(arch)
    lm = build_model(get_smoke_config(arch), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    lm.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jparams)))
    return cfg, jmodel, jparams, lm


def _batch(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s), np.int32)
    return ({"tokens": jax.numpy.asarray(toks), "labels": jax.numpy.asarray(toks)},
            {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(toks).long()})


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("cos_batch", [2, 4, 8])
@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen3-32b", "gemma2-9b",
                                  "moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_extract_tune_matches_jax(arch, cos_batch, compress):
    cfg, jmodel, jparams, lm = _port(arch)
    # gemma2 at seq 1024, where JAX's local layers take their windowed path.
    seq = 1024 if arch == "gemma2-9b" else 32
    jb, tb = _batch(cfg, 8, seq, seed=cos_batch)
    split = 1
    plan, jplan = _plans(split, cos_batch, compress)
    frozen, trainable = lm.split_params(split)
    acts = tts.make_extract_fn(plan)(frozen, tb)
    with torch.no_grad():
        loss = float(tts.make_tune_loss_fn(plan)(trainable, acts, tb))
    jfrozen, jtrain = jmodel.split_params(jparams, split)
    jacts = jts.make_extract_fn(jmodel, jplan)(jfrozen, jb)
    jloss = float(jts.make_tune_loss_fn(jmodel, jplan)(jtrain, jacts, jb))
    assert loss == pytest.approx(jloss, abs=1e-4)
    assert tts.wire_bytes(acts) == jts.wire_bytes(jplan, jacts)
    if compress:
        q, s = acts
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert q.shape == (8, seq, cfg.d_model) and s.shape == (8, seq, 1)
        # The compressed loss stays near the uncompressed one.
        with torch.no_grad():
            assert loss == pytest.approx(float(lm.loss(tb)), abs=0.05)
    else:
        assert not acts.requires_grad


def test_cos_batch_invariance():
    """Paper §5.1: the feature-extraction batch size does not change results."""
    cfg, _, _, lm = _port("mistral-nemo-12b")
    _, tb = _batch(cfg, 8, 32, seed=9)
    frozen, _ = lm.split_params(1)
    outs = [tts.make_extract_fn(_plans(1, cb, False)[0])(frozen, tb) for cb in (1, 2, 4, 8)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=1e-5, rtol=1e-5)


def test_extract_rejects_ragged_microbatches():
    cfg, _, _, lm = _port("mistral-nemo-12b")
    _, tb = _batch(cfg, 6, 16, seed=10)
    with pytest.raises(ValueError, match="microbatches"):
        tts.make_extract_fn(_plans(1, 4, False)[0])(lm.split_params(1)[0], tb)
