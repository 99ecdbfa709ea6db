"""The port's training slice against the JAX package's, on the CPU.

AdamW, the train steps, the data pipeline, the object store, checkpoints,
the training entry point and flash attention under autograd, each on the same
inputs as the JAX function it replaces (weights and optimizer state carried
across by ``convert.train_state_from_jax``). The smoke models are f32, so
the port and the reference differ only in summation order: losses agree to
1e-5 relative and gradients (read from AdamW's first moment) to 1e-4
relative, except where a test says why it is looser.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.checkpoint import ckpt as jckpt
from repro.config import RunConfig as JRun
from repro.config import ShapeConfig as JShape
from repro.config import TrainConfig as JTrain
from repro.core.splitter import SplitDecision as JDecision
from repro.core.tier_split import TierPlan as JPlan
from repro.cos import objectstore as jos
from repro.data import pipeline as jpipe
from repro.kernels import ref as jref
from repro.launch.train import run_training as j_run_training
from repro.models.api import build_model as j_build_model
from repro.optim import adamw as jadamw
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.splitter import SplitDecision
from repro_torch.core.tier_split import TierPlan
from repro_torch.cos import clock as tclock
from repro_torch.cos import objectstore as tos
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.launch.train import run_training, to_device
from repro_torch.models.api import build_model
from repro_torch.optim import adamw as tadamw
from repro_torch.train import steps as tsteps

# Every arch: the LM families, the vlm and the encoder-decoder.
ARCHS = ["mistral-nemo-12b", "gemma2-9b", "qwen3-32b", "qwen1.5-110b", "mamba2-1.3b",
         "moonshot-v1-16b-a3b", "grok-1-314b", "jamba-v0.1-52b", "llava-next-mistral-7b",
         "whisper-small"]


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _tree_close(jtree, ttree, rtol, atol, what="", of_max=0.0):
    """Leaf by leaf; ``of_max`` adds that fraction of the leaf's largest
    magnitude to ``atol``."""
    jl = jax.tree_util.tree_leaves_with_path(jtree)
    tl = dict(jax.tree_util.tree_leaves_with_path(ttree))
    assert len(jl) == len(tl)
    for path, a in jl:
        a = _np(a)
        np.testing.assert_allclose(_np(tl[path]), a, rtol=rtol,
                                   atol=atol + of_max * float(np.abs(a).max(initial=0.0)),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _adam_tree(seed, dtype=np.float32):
    """A parameter tree with every kind of leaf the decay mask tells apart:
    stacked block matrices and per-block vectors, norms, biases, a scalar."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(dtype)
    return {"blocks": {"sub0": {"attn": {"wq": n(2, 8, 2, 4), "bq": n(2, 2, 4),
                                         "q_norm": {"scale": n(2, 4)}},
                                "mamba": {"A_log": n(2, 3), "dt_bias": n(2, 3)},
                                "ln_mixer": {"scale": n(2, 8)}}},
            "final_norm": {"scale": n(8)}, "unembed": n(16, 8), "temp": n()}


@pytest.mark.parametrize("state_dtype,clip", [("float32", 1.0), ("float32", 0.0),
                                              ("float32", 1e3), ("bfloat16", 1.0)])
def test_adamw_update_matches_jax(state_dtype, clip):
    """Three updates: global-norm clipping active (1.0), off (0) and inert
    (1e3), f32 and bf16 moments."""
    tc = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip,
              opt_state_dtype=state_dtype, weight_decay=0.1)
    jtc, ttc = JTrain(**tc), TrainConfig(**tc)
    jp = jax.tree.map(jnp.asarray, _adam_tree(0))
    tp = convert.params_from_jax(_adam_tree(0))
    jopt, topt = jadamw.init_opt_state(jp, jtc), tadamw.init_opt_state(tp, ttc)
    for i in range(3):
        g = _adam_tree(10 + i)
        jp, jopt, jm = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, g), jopt, jtc)
        tp, topt, tm = tadamw.adamw_update(tp, convert.params_from_jax(g), topt, ttc)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(topt.step) == int(jopt.step) == 3
    # bf16 moments round at the same places; one ulp of bf16 is 2^-8.
    rtol = 1e-5 if state_dtype == "float32" else 1e-2
    _tree_close(jp, convert.params_to_jax(tp), rtol, 1e-6, "params")
    _tree_close(jopt.m, convert.params_to_jax(topt.m), rtol, 1e-6, "m")
    _tree_close(jopt.v, convert.params_to_jax(topt.v), rtol, 1e-6, "v")
    assert all(m.dtype == getattr(torch, state_dtype) for m in topt.m.values())


def test_lr_schedule_matches_jax():
    for warm, total in ((100, 1000), (2, 12), (0, 5), (10, 10)):
        kw = dict(learning_rate=3e-4, warmup_steps=warm, total_steps=total)
        for step in range(total + 5):
            got = float(tadamw.lr_schedule(torch.tensor(step), TrainConfig(**kw)))
            want = float(jadamw.lr_schedule(jnp.asarray(step), JTrain(**kw)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    # The cosine floor: 0.1 of the peak after total_steps.
    assert math.isclose(float(tadamw.lr_schedule(torch.tensor(50), TrainConfig(
        learning_rate=1.0, warmup_steps=2, total_steps=20))), 0.1, rel_tol=1e-6)


def test_global_norm_matches_jax():
    t = _adam_tree(3)
    np.testing.assert_allclose(float(tadamw.global_norm(convert.params_from_jax(t))),
                               float(jadamw.global_norm(jax.tree.map(jnp.asarray, t))),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_matches_jax_for_every_arch(arch):
    """By name and by the rank in the stacked JAX tree, over every parameter
    of the model: mamba2's A_log and D (per-block vectors) are decayed there
    and here."""
    cfg, _, jparams = smoke_model(arch)
    jmask = {jax.tree_util.keystr(p): float(m) for p, m in
             jax.tree_util.tree_leaves_with_path(jadamw._decay_mask(jparams))}
    lm = build_model(get_smoke_config(arch), device="cpu",
                     generator=torch.Generator().manual_seed(0))
    tmask = tadamw._decay_mask(dict(lm.named_parameters()))
    got = {"".join(f"['{k}']" for k in tadamw.jax_path(n)[0].split("/")): m
           for n, m in tmask.items()}
    assert got == jmask
    if arch == "mamba2-1.3b":
        assert tmask["blocks.0.sub0.mamba.A_log"] == 1.0
        assert tmask["blocks.0.sub0.mamba.dt_bias"] == 0.0
    if arch == "whisper-small":
        assert tmask["enc_blocks.0.ln1.bias"] == 0.0 and tmask["dec_pos"] == 1.0
        assert tmask["dec_blocks.1.cross_attn.wk"] == 1.0


# ---------------------------------------------------------------------------
# Train steps against the JAX steps
# ---------------------------------------------------------------------------
def _setup(arch, micro=4, cos=4, split=1, seq=32, batch=8, compress=False, opt_dtype="float32"):
    """The JAX state and its port copy, the two models, configs and plans,
    and one numpy batch."""
    cfg, jmodel, _ = smoke_model(arch)
    tcfg = get_smoke_config(arch)
    tkw = dict(microbatch=micro, total_steps=20, warmup_steps=2, opt_state_dtype=opt_dtype)
    jrc = JRun(model=cfg, shape=JShape("t", "train", seq, batch), train=JTrain(**tkw))
    trc = RunConfig(model=tcfg, shape=ShapeConfig("t", "train", seq, batch),
                    train=TrainConfig(**tkw))
    jplan = JPlan(split, cos, compress, JDecision(split, 0, 0, [], "t"))
    tplan = TierPlan(split, cos, compress, SplitDecision(split, 0, 0, [], "t"))
    jstate = jsteps.init_train_state(jmodel, jrc, jplan, jax.random.PRNGKey(0))
    tstate = convert.train_state_from_jax(jax.tree.map(np.asarray, tuple(jstate)), tcfg)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    batch_np = {"tokens": toks, "labels": toks.copy()}
    return (jmodel, jrc, jplan, jstate), (tcfg, trc, tplan, tstate), batch_np


def _seq(arch):
    """gemma2 at sequence 1024 and batch 2: at 32 the JAX model drops the
    16-token window of its local layers (window + q_block >= s, ROADMAP
    notes), which the port keeps."""
    return dict(seq=1024, batch=2) if arch == "gemma2-9b" else {}


def _jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _compare_steps(jout, tout, loss_rtol=1e-5, grad_rtol=1e-4):
    (js, jm), (ts, tm) = jout, tout
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=loss_rtol)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=grad_rtol)
    frozen, trainable, (m, v, step) = convert.train_state_to_jax(ts)
    assert int(step) == int(js.opt.step) == 1
    # After one step m = (1 - beta1) * the clipped gradient.
    _tree_close(js.opt.m, m, grad_rtol, 1e-8, "m")
    _tree_close(js.opt.v, v, 2 * grad_rtol, 1e-12, "v")
    # The first update is lr * g / (|g| + eps), about lr * sign(g): where a
    # gradient element is at the level of rounding noise, the two updates may
    # fall anywhere in (-lr, lr), 2 lr apart; lr is 5e-5 at step 1.
    _tree_close(js.trainable, trainable, 1e-5, 2 * float(jm["lr"]), "params")
    _tree_close(js.frozen, frozen, 0, 0, "frozen")


@pytest.mark.parametrize("arch,micro,cos,compress", [
    ("mistral-nemo-12b", 4, 2, False),     # fused: extract a chunk of 2, grad, accumulate
    ("mistral-nemo-12b", 2, 4, False),     # coarse: extract at 4, grads over chunks of 2
    ("gemma2-9b", 2, 1, False),
    ("qwen3-32b", 4, 4, False),
    ("mamba2-1.3b", 4, 2, False),
])
def test_hapi_step_matches_jax(arch, micro, cos, compress):
    j, t, b = _setup(arch, micro=micro, cos=cos, compress=compress, **_seq(arch))
    jout = jax.jit(jsteps.build_hapi_train_step(j[0], j[1], j[2]))(j[3], _jbatch(b))
    tout = tsteps.build_hapi_train_step(None, t[1], t[2])(t[3], to_device(b, torch.device("cpu")))
    _compare_steps(jout, tout)


@pytest.mark.parametrize("micro,cos", [(4, 2), (2, 4)])
def test_hapi_step_compressed_boundary_matches_jax(micro, cos):
    """The int8 wire on both paths. The jitted JAX quantize multiplies by the
    rounded reciprocal of 127 (one ulp off the eager scale in a few percent
    of tiles, ROADMAP notes), so the codes of the boundary differ in a few
    places: the loss agrees to 1e-4 and the gradients to 1e-3 relative."""
    j, t, b = _setup("mistral-nemo-12b", micro=micro, cos=cos, compress=True)
    jout = jax.jit(jsteps.build_hapi_train_step(j[0], j[1], j[2]))(j[3], _jbatch(b))
    tout = tsteps.build_hapi_train_step(None, t[1], t[2])(t[3], to_device(b, torch.device("cpu")))
    (js, jm), (ts, tm) = jout, tout
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    _, _, (m, _, _) = convert.train_state_to_jax(ts)
    _tree_close(js.opt.m, m, 1e-3, 1e-8, "m", of_max=3e-3)


@pytest.mark.parametrize("arch", ["gemma2-9b", "mistral-nemo-12b"])
def test_baseline_step_matches_jax(arch):
    j, t, b = _setup(arch, micro=0, cos=2, **_seq(arch))
    jout = jax.jit(jsteps.build_baseline_train_step(j[0], j[1], j[2].split))(j[3], _jbatch(b))
    tout = tsteps.build_baseline_train_step(None, t[1], t[2].split)(
        t[3], to_device(b, torch.device("cpu")))
    _compare_steps(jout, tout)


@pytest.mark.parametrize("compress", [False, True])
def test_tier_steps_match_jax(compress):
    """extract_step on the storage tier, tune_step on the compute tier: the
    boundary (codes and scales bit for bit without the jitted quantize), the
    loss and the update."""
    j, t, b = _setup("qwen3-32b", micro=2, cos=4, compress=compress)
    jext, jtune = jsteps.build_tier_steps(j[0], j[1], j[2])
    text, ttune = tsteps.build_tier_steps(None, t[1], t[2])
    jacts = jext(j[3].frozen, _jbatch(b))
    tacts = text(t[3].frozen, to_device(b, torch.device("cpu")))
    if compress:
        # The activations agree to 1e-5 (summation order), and the JAX extract
        # quantizes inside a compiled scan, which multiplies by the rounded
        # reciprocal of 127 (ROADMAP notes): the scales agree to 1e-5, and a
        # code next to a rounding boundary may be one off.
        dq = np.abs(tacts[0].numpy().astype(np.int32) - np.asarray(jacts[0]).astype(np.int32))
        assert dq.max() <= 1 and dq.mean() < 1e-2
        np.testing.assert_allclose(tacts[1].numpy(), np.asarray(jacts[1]), rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(tacts.numpy(), np.asarray(jacts), rtol=1e-5, atol=1e-5)
    jtr, jopt, jm = jtune(j[3].trainable, j[3].opt, jacts, _jbatch(b))
    ttr, topt, tm = ttune(t[3].trainable, t[3].opt, tacts, to_device(b, torch.device("cpu")))
    # A code one off moves the boundary by a step of 1/127 of its tile's
    # range: the loss by about 1e-5, and a gradient element of the first
    # block by up to a few 1e-3 of its leaf's largest.
    tol = 1e-3 if compress else 1e-4
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=tol / 10)
    _tree_close(jopt.m, convert.params_to_jax(topt.m), tol, 1e-8, "m",
                of_max=3e-3 if compress else 0.0)
    # As in _compare_steps: first updates of gradients at noise level.
    _tree_close(jtr, convert.params_to_jax(ttr.state_dict()), 1e-5, 2 * float(jm["lr"]),
                "params")


def test_train_state_round_trip():
    j, t, _ = _setup("gemma2-9b", opt_dtype="bfloat16")
    frozen, trainable, (m, v, step) = convert.train_state_to_jax(t[3])
    _tree_close(j[3].frozen, frozen, 0, 0)
    _tree_close(j[3].trainable, trainable, 0, 0)
    _tree_close(j[3].opt.m, m, 0, 0)
    assert all(x.dtype == torch.bfloat16 for x in t[3].opt.m.values())
    assert not any(p.requires_grad for p in t[3].frozen.parameters())


# ---------------------------------------------------------------------------
# The invariances of tests/test_train_steps.py, on the port alone
# ---------------------------------------------------------------------------
def _port_setup(arch, micro=4, cos=4, split=1, seq=32, batch=8):
    cfg = get_smoke_config(arch)
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", "train", seq, batch),
                   train=TrainConfig(microbatch=micro, total_steps=20, warmup_steps=2))
    plan = TierPlan(split, cos, False, SplitDecision(split, 0, 0, [], "t"))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (batch, seq)))
    return model, rc, plan, tsteps.init_train_state(model, rc, plan), \
        {"tokens": toks, "labels": toks}


@pytest.mark.parametrize("arch", ["gemma2-9b", "qwen3-32b"])
def test_hapi_equals_baseline_first_step(arch):
    m1, rc, plan, s1, batch = _port_setup(arch)
    s1, r1 = tsteps.build_hapi_train_step(m1, rc, plan)(s1, batch)
    m2, rc, plan, s2, _ = _port_setup(arch)
    s2, r2 = tsteps.build_baseline_train_step(m2, rc, plan.split)(s2, batch)
    assert abs(float(r1["loss"]) - float(r2["loss"])) < 1e-5
    for (n, a), (_, b) in zip(s1.trainable.named_parameters(), s2.trainable.named_parameters()):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5, msg=n)


def test_accumulation_chunking_invariance():
    """Chunked grad accumulation == one-shot full-batch gradients."""
    m1, rc1, p1, s1, batch = _port_setup("mistral-nemo-12b", micro=2, cos=2)
    s1, r1 = tsteps.build_hapi_train_step(m1, rc1, p1)(s1, batch)
    m2, rc2, p2, s2, _ = _port_setup("mistral-nemo-12b", micro=8, cos=8)
    s2, r2 = tsteps.build_hapi_train_step(m2, rc2, p2)(s2, batch)
    assert abs(float(r1["loss"]) - float(r2["loss"])) < 1e-5
    for k in s1.opt.m:
        torch.testing.assert_close(s1.opt.m[k], s2.opt.m[k], atol=1e-7, rtol=1e-4, msg=k)


def test_frozen_prefix_immutable_and_loss_decreases():
    model, rc, plan, state, batch = _port_setup("qwen3-32b")
    step = tsteps.build_hapi_train_step(model, rc, plan)
    frozen0 = {k: v.clone() for k, v in state.frozen.state_dict().items()}
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    for k, v in state.frozen.state_dict().items():
        assert torch.equal(v, frozen0[k]), k


def test_opt_step_counts():
    model, rc, plan, state, batch = _port_setup("mamba2-1.3b")
    step = tsteps.build_hapi_train_step(model, rc, plan)
    state, _ = step(state, batch)
    state, _ = step(state, batch)
    assert int(state.opt.step) == 2


def test_blocks_are_rematerialised_under_grad(monkeypatch):
    """Under autograd each suffix block's forward runs again in the backward
    (the JAX model's remat "block"): the attention's forward, which keeps
    its log-sum-exp for the backward, runs twice a step, and the boundary
    needs no graph."""
    model, rc, plan, state, batch = _port_setup("mistral-nemo-12b")
    calls = []
    plain = tref.flash_attention_lse
    monkeypatch.setattr(tref, "flash_attention_lse",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    acts = state.frozen(batch)
    assert not acts.requires_grad and not calls
    loss = state.trainable.loss(acts, batch)
    assert len(calls) == 1
    torch.autograd.grad(loss, list(state.trainable.parameters()))
    assert len(calls) == 2


def test_forward_step_matches_model():
    model, *_ = _port_setup("qwen3-32b")
    toks = torch.arange(64).reshape(2, 32) % 100
    logits = tsteps.build_forward_step(model)({"tokens": toks})
    assert not logits.requires_grad and logits.shape == (2, 32, model.cfg.padded_vocab)


# ---------------------------------------------------------------------------
# Object store and data pipeline
# ---------------------------------------------------------------------------
def _stores(object_size=4, n=20):
    cfg = get_smoke_config("qwen3-32b")
    shape = ShapeConfig("d", "train", 16, 4)
    data = tpipe.synthetic_dataset(cfg, shape, n, seed=3)
    jdata = jpipe.synthetic_dataset(smoke_model("qwen3-32b")[0], JShape("d", "train", 16, 4),
                                    n, seed=3)
    for k in data:
        np.testing.assert_array_equal(data[k], jdata[k])
    ts, js = tos.ObjectStore(), jos.ObjectStore()
    assert ts.put_dataset("train", data, object_size) == \
        js.put_dataset("train", jdata, object_size)
    return ts, js


def test_object_store_matches_jax():
    ts, js = _stores(object_size=3)
    assert ts.object_names("train") == js.object_names("train")
    assert ts.total_bytes("train") == js.total_bytes("train")
    t = 0.0
    for name in ts.object_names("train") * 2:
        (tobj, tready), (jobj, jready) = ts.read(name, t), js.read(name, t)
        assert tready == jready and tobj.nbytes == jobj.nbytes
        assert ts.replicas(name) == js.replicas(name)
        t += 1e-4
    assert [n.busy_time for n in ts.nodes] == [n.busy_time for n in js.nodes]
    names = ts.object_names("train")[:2]
    assert ts.read_batch(names, 0.0) is None and js.read_batch(names, 0.0) is None
    t1, j1 = tos.ObjectStore(), jos.ObjectStore()
    assert tos.put_synthetic_dataset(t1, n_samples=50, object_size=20) == \
        jos.put_synthetic_dataset(j1, n_samples=50, object_size=20)
    assert [o.nbytes for o in t1.objects.values()] == [o.nbytes for o in j1.objects.values()]


def test_link_and_timeline_match_jax():
    from repro.cos.clock import Link as JLink
    a, b = tclock.Link("x", bandwidth=1e6, latency=1e-3), JLink("x", bandwidth=1e6, latency=1e-3)
    for start, n in ((0.0, 1000), (0.0005, 5000), (1.0, 0)):
        assert a.transfer(start, n) == b.transfer(start, n)
    a.note(2.0, 2.5)
    b.note(2.0, 2.5)
    assert (a.busy_until, a.busy_time) == (b.busy_until, b.busy_time)


@pytest.mark.parametrize("object_size,global_batch", [(4, 4), (2, 8), (4, 8)])
def test_pipeline_batches_and_resume_match_jax(object_size, global_batch):
    ts, js = _stores(object_size=object_size, n=24)
    tp = tpipe.COSDataPipeline(ts, "train", global_batch=global_batch)
    jp = jpipe.COSDataPipeline(js, "train", global_batch=global_batch)
    assert tp.batches_per_epoch() == jp.batches_per_epoch()
    tb, jb = list(tp), list(jp)
    assert len(tb) == len(jb) == jp.batches_per_epoch()
    for x, y in zip(tb, jb):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
    assert tp.state.to_dict() == jp.state.to_dict()
    # Resume mid-epoch from a checkpointed cursor.
    tp2 = tpipe.COSDataPipeline(ts, "train", global_batch=global_batch)
    it = iter(tp2)
    next(it)
    cursor = tp2.state.to_dict()
    resumed = tpipe.COSDataPipeline(ts, "train", global_batch=global_batch,
                                    state=tpipe.PipelineState.from_dict(cursor))
    jres = jpipe.COSDataPipeline(js, "train", global_batch=global_batch,
                                 state=jpipe.PipelineState.from_dict(cursor))
    for x, y in zip(resumed, jres):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert tpipe.PipelineState.from_dict(cursor).next_object == tp2.per_batch


# ---------------------------------------------------------------------------
# Checkpoints, both ways
# ---------------------------------------------------------------------------
def _bf16_setup(seed=1):
    """A bf16 model with bf16 moments, so bf16 leaves go both ways: the
    JAX state (moments made nonzero, step 7) and the port's config."""
    arch = "gemma2-9b"
    cfg = dataclasses.replace(smoke_model(arch)[0], param_dtype="bfloat16")
    tcfg = dataclasses.replace(get_smoke_config(arch), param_dtype="bfloat16")
    jrc = JRun(model=cfg, shape=JShape("t", "train", 32, 4),
               train=JTrain(total_steps=10, warmup_steps=2, opt_state_dtype="bfloat16"))
    plan = JPlan(1, 4, False, JDecision(1, 0, 0, [], "t"))
    jstate = jsteps.init_train_state(j_build_model(cfg), jrc, plan, jax.random.PRNGKey(seed))
    jstate = jstate._replace(opt=jstate.opt._replace(
        m=jax.tree.map(lambda x: (x + 0.25).astype(jnp.bfloat16), jstate.opt.m),
        step=jnp.asarray(7, jnp.int32)))
    return tcfg, jstate


def _port_state(tcfg, jstate):
    return convert.train_state_from_jax(jax.tree.map(np.asarray, tuple(jstate)), tcfg)


def _assert_state_equal(jstate, tstate):
    frozen, trainable, (m, v, step) = convert.train_state_to_jax(tstate)
    for a, b in ((jstate.frozen, frozen), (jstate.trainable, trainable),
                 (jstate.opt.m, m), (jstate.opt.v, v)):
        _tree_close(a, b, 0, 0)
    assert int(step) == int(jstate.opt.step)


def test_checkpoint_jax_to_port(tmp_path):
    tcfg, jstate = _bf16_setup()
    jckpt.save_checkpoint(str(tmp_path), 7, jstate, extra={"pipeline": {"next_object": 3}})
    like = _port_state(*_bf16_setup(seed=9))
    assert tckpt.latest_step(str(tmp_path)) == 7
    state, extra, step = tckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 7 and extra == {"pipeline": {"next_object": 3}}
    assert state.trainable.unembed.dtype == torch.bfloat16
    _assert_state_equal(jstate, state)


def test_checkpoint_port_to_jax(tmp_path):
    tcfg, jstate = _bf16_setup()
    tckpt.save_checkpoint(str(tmp_path), 7, _port_state(tcfg, jstate), extra={"arch": "gemma2-9b"})
    like = jax.tree.map(jnp.zeros_like, jstate)
    restored, extra, step = jckpt.restore_checkpoint(str(tmp_path), like)
    assert step == 7 and extra == {"arch": "gemma2-9b"}
    assert jax.tree.structure(restored) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_np(a), _np(b))


def test_checkpoint_gc_atomic_and_latest(tmp_path):
    tstate = _port_state(*_bf16_setup())
    d = str(tmp_path)
    assert tckpt.latest_step(d) is None
    assert tckpt.restore_checkpoint(d, tstate) == (None, None, None)
    for s in (1, 2, 3, 4):
        tckpt.save_checkpoint(d, s, tstate, keep=3)
    (tmp_path / "step_00000009.tmp").mkdir()     # a write that never finished
    assert sorted(p.name for p in tmp_path.iterdir() if not p.name.endswith(".tmp")) == \
        ["step_00000002", "step_00000003", "step_00000004"]
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 4
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore_checkpoint(d, tstate._replace(trainable=tstate.frozen))


# ---------------------------------------------------------------------------
# run_training: tests/test_e2e_smoke.py's scenarios
# ---------------------------------------------------------------------------
def test_train_loss_decreases():
    out = run_training("qwen3-32b", steps=12, batch=8, seq=32, smoke=True, ckpt_dir="",
                       lr=1e-3, log_every=100, device="cpu")
    assert np.isfinite(out["final_loss"])
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])


def test_crash_resume_exact_state(tmp_path):
    d = str(tmp_path / "ck")
    kw = dict(steps=10, batch=4, seq=32, smoke=True, lr=1e-3, log_every=100, device="cpu")
    ref = run_training("gemma2-9b", ckpt_dir="", **kw)
    run_training("gemma2-9b", ckpt_dir=d, ckpt_every=3, kill_at=6, **kw)
    out = run_training("gemma2-9b", ckpt_dir=d, ckpt_every=3, **kw)
    assert abs(out["final_loss"] - ref["final_loss"]) < 0.2
    # Resumed at step 6 from its checkpoint and cursor: the same trajectory.
    assert len(out["losses"]) == 4
    np.testing.assert_allclose(out["losses"], ref["losses"][6:], rtol=1e-5)


def test_compressed_boundary_trains():
    out = run_training("mistral-nemo-12b", steps=8, batch=8, seq=32, smoke=True,
                       compress=True, lr=1e-3, log_every=100, device="cpu")
    assert np.isfinite(out["final_loss"])
    assert out["losses"][-1] < out["losses"][0] + 0.05


def test_run_training_trains_like_jax_on_the_same_data():
    """The same data through both packages' run_training (the weights
    differ: each package draws its own from the seed): both losses start
    near ln(vocab) and fall."""
    kw = dict(steps=6, batch=4, seq=32, smoke=True, lr=1e-3, log_every=100)
    t = run_training("mistral-nemo-12b", device="cpu", **kw)
    j = j_run_training("mistral-nemo-12b", **kw)
    for losses in (t["losses"], j["losses"]):
        assert abs(losses[0] - math.log(512)) < 0.5 and losses[-1] < losses[0]


def test_train_cli_on_cpu(capsys):
    from repro_torch.launch import train as ttrain
    ttrain.main(["--arch", "qwen3-32b", "--device", "cpu", "--steps", "3", "--batch", "4",
                 "--seq", "16"])
    out = capsys.readouterr().out
    assert "[plan] split=1/2" in out and "'steps': 3" in out


# ---------------------------------------------------------------------------
# Flash attention under autograd on the CPU
# ---------------------------------------------------------------------------
FLASH_GRAD_CASES = [
    # b, s, h, hkv, hd, causal, window, softcap
    (2, 40, 4, 2, 16, True, None, None),
    (1, 64, 8, 2, 32, True, 16, 50.0),
    (2, 33, 4, 4, 16, False, None, None),
    (1, 50, 4, 1, 64, False, 10, 20.0),
    (1, 17, 6, 2, 16, True, 0, None),
]


@pytest.mark.parametrize("b,s,h,hkv,hd,causal,window,cap", FLASH_GRAD_CASES)
def test_flash_attention_grad_matches_plain_and_jax(b, s, h, hkv, hd, causal, window, cap):
    rng = np.random.default_rng(11)
    qn, kn, vn = (rng.standard_normal(sh).astype(np.float32)
                  for sh in ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd)))
    gn = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    tops.reset_launch_counts()
    out = tops.flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), torch.from_numpy(gn))
    assert sum(tops.launch_counts().values()) == 0   # the plain versions on the CPU
    plain = tref.flash_attention_bwd(*(torch.from_numpy(a) for a in (qn, kn, vn, gn)),
                                     causal=causal, window=window, softcap=cap)
    for got, want in zip((dq, dk, dv), plain):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)
    rep = h // hkv

    def jloss(q_, k_, v_):
        o = jref.flash_attention(q_, jnp.repeat(k_, rep, axis=2), jnp.repeat(v_, rep, axis=2),
                                 causal=causal, window=window, softcap=cap)
        return jnp.sum(o * gn)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    for got, want in zip((dq, dk, dv), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_flash_lse_is_base_2_log_sum_exp():
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 20, 2, 16)).astype(np.float32))
               for _ in range(3))
    out, lse = tref.flash_attention_lse(q, k, v, causal=True, window=5, softcap=10.0)
    scores = np.einsum("bqhd,bkhd->bhqk", q.numpy().astype(np.float64),
                       k.numpy().astype(np.float64)) / 4.0
    scores = 10.0 * np.tanh(scores / 10.0)
    qpos, kpos = np.arange(20)[:, None], np.arange(20)[None, :]
    scores = np.where((kpos <= qpos) & (kpos > qpos - 6), scores, -np.inf)
    want = np.log2(np.exp(scores).sum(-1))
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out, tref.flash_attention(q, k, v, causal=True, window=5,
                                                         softcap=10.0))
