"""Training of the encoder-decoder and VLM families against the JAX
package, on the CPU, and the helpers ``test_torch_train_moe.py`` shares.

whisper-small (encoder-decoder) and llava-next-mistral-7b (VLM) at their
smoke configs: the Hapi step on both of its paths, with and without the int8
boundary, the baseline step, the two tier steps and ``run_training``, each
on the same state and batch as the JAX function it replaces (the state
carried across by ``convert.train_state_from_jax``, the batch made with
numpy from a seed). Tolerances are ``test_torch_train.py``'s: losses to
1e-5 relative and gradients to 1e-4 (``_compare_steps``); the int8 boundary
to 1e-4 and 1e-3, since the jitted JAX quantize multiplies by the rounded
reciprocal of 127 (ROADMAP Queue 3 notes). A sample is 32 positions: frames
for whisper (its decoder reads ``dec_seq`` tokens), tokens after the
``n_patches`` patch embeddings for llava. The MoE and hybrid families
(moonshot-v1-16b-a3b, jamba-v0.1-52b) are in ``test_torch_train_moe.py``,
so that the two files' JAX compiles run on two workers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import smoke_model
from repro.config import RunConfig as JRun
from repro.config import ShapeConfig as JShape
from repro.config import TrainConfig as JTrain
from repro.core.splitter import SplitDecision as JDecision
from repro.core.tier_split import TierPlan as JPlan
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.splitter import SplitDecision
from repro_torch.core.tier_split import TierPlan
from repro_torch.launch.train import run_training, to_device
from repro_torch.models import encdec, transformer
from repro_torch.models.api import build_model, merge_params
from repro_torch.train import steps as tsteps
from test_torch_train import _compare_steps, _jbatch, _tree_close

ENCDEC_VLM = ["whisper-small", "llava-next-mistral-7b"]
FAMILIES = ["moonshot-v1-16b-a3b", "jamba-v0.1-52b", *ENCDEC_VLM]
SEQ = 32
CPU = torch.device("cpu")


def _batch(cfg, batch, seed=5):
    """One numpy batch of the arch's inputs: frames, tokens and labels for
    the encoder-decoder; patches, tokens and labels for the VLM; tokens that
    are their own labels otherwise."""
    rng = np.random.default_rng(seed)

    def ints(n):
        return rng.integers(0, cfg.vocab_size, (batch, n)).astype(np.int32)

    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((batch, SEQ, cfg.d_model)).astype(np.float32),
                "tokens": ints(cfg.dec_seq), "labels": ints(cfg.dec_seq)}
    toks = ints(SEQ)
    out = {"tokens": toks, "labels": toks.copy()}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((batch, cfg.n_patches, cfg.d_model)).astype(
            np.float32)
    return out


def _setup(arch, micro=4, cos=4, split=1, batch=8, compress=False):
    """The JAX state and its port copy, run configs, plans and one batch."""
    cfg, jmodel, _ = smoke_model(arch)
    tcfg = get_smoke_config(arch)
    seq = SEQ + cfg.n_patches if cfg.family == "vlm" else SEQ
    tkw = dict(microbatch=micro, total_steps=20, warmup_steps=2)
    jrc = JRun(model=cfg, shape=JShape("t", "train", seq, batch), train=JTrain(**tkw))
    trc = RunConfig(model=tcfg, shape=ShapeConfig("t", "train", seq, batch),
                    train=TrainConfig(**tkw))
    jplan = JPlan(split, cos, compress, JDecision(split, 0, 0, [], "t"))
    tplan = TierPlan(split, cos, compress, SplitDecision(split, 0, 0, [], "t"))
    jstate = jsteps.init_train_state(jmodel, jrc, jplan, jax.random.PRNGKey(0))
    tstate = convert.train_state_from_jax(jax.tree.map(np.asarray, tuple(jstate)), tcfg)
    return (jmodel, jrc, jplan, jstate), (tcfg, trc, tplan, tstate), _batch(cfg, batch)


def _hapi(arch, micro, cos, compress=False):
    j, t, b = _setup(arch, micro=micro, cos=cos, compress=compress)
    jout = jax.jit(jsteps.build_hapi_train_step(j[0], j[1], j[2]))(j[3], _jbatch(b))
    tout = tsteps.build_hapi_train_step(None, t[1], t[2])(t[3], to_device(b, CPU))
    return jout, tout


@pytest.mark.parametrize("arch", ENCDEC_VLM)
@pytest.mark.parametrize("micro,cos", [(4, 2), (2, 4)], ids=["fused", "coarse"])
def test_hapi_step_matches_jax(arch, micro, cos):
    """Fused (extract a chunk of 2, grad, accumulate) and coarse (extract at
    4, grads over chunks of 2)."""
    _compare_steps(*_hapi(arch, micro, cos))


@pytest.mark.parametrize("arch", ENCDEC_VLM)
@pytest.mark.parametrize("micro,cos", [(4, 2), (2, 4)], ids=["fused", "coarse"])
def test_hapi_step_compressed_boundary_matches_jax(arch, micro, cos):
    """The int8 wire at ``test_torch_train.py``'s tolerances for it: a code
    next to a rounding boundary may be one off between the jitted JAX
    quantize and the port's."""
    (js, jm), (ts, tm) = _hapi(arch, micro, cos, compress=True)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    _, _, (m, _, _) = convert.train_state_to_jax(ts)
    _tree_close(js.opt.m, m, 1e-3, 1e-8, "m", of_max=3e-3)


def _baseline(arch):
    j, t, b = _setup(arch, micro=0, cos=2)
    jout = jax.jit(jsteps.build_baseline_train_step(j[0], j[1], j[2].split))(j[3], _jbatch(b))
    tout = tsteps.build_baseline_train_step(None, t[1], t[2].split)(t[3], to_device(b, CPU))
    _compare_steps(jout, tout)


@pytest.mark.parametrize("arch", ENCDEC_VLM)
def test_baseline_step_matches_jax(arch):
    """The whole model in one pass: whisper's halves merge as an
    encoder-decoder (``transformer.merge_params`` cannot take them)."""
    _baseline(arch)


@pytest.mark.parametrize("arch", FAMILIES)
def test_merge_params_takes_the_family_merge(arch):
    """``models.api.merge_params`` gives back the model's own modules in
    its own class; the LM families' merge refuses an encoder-decoder's
    halves, which is why the baseline step goes through the dispatch."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    frozen, trainable = model.split_params(1)
    merged = merge_params(frozen, trainable)
    assert type(merged) is type(model)
    assert [id(p) for p in merged.parameters()] == [id(p) for p in model.parameters()]
    if cfg.family == "encdec":
        with pytest.raises(AttributeError, match="embed"):
            transformer.merge_params(frozen, trainable)
        assert isinstance(merged, encdec.EncDec)


@pytest.mark.parametrize("arch", ENCDEC_VLM)
@pytest.mark.parametrize("compress", [False, True])
def test_tier_steps_match_jax(arch, compress):
    """extract_step on the storage tier, tune_step on the compute tier, as
    ``test_torch_train.py`` holds qwen3's: the boundary, the loss and the
    update. Both JAX steps are jitted (eager, whisper's takes seconds)."""
    j, t, b = _setup(arch, micro=2, cos=4, compress=compress)
    jext, jtune = map(jax.jit, jsteps.build_tier_steps(j[0], j[1], j[2]))
    text, ttune = tsteps.build_tier_steps(None, t[1], t[2])
    jacts = jext(j[3].frozen, _jbatch(b))
    tacts = text(t[3].frozen, to_device(b, CPU))
    if compress:
        dq = np.abs(tacts[0].numpy().astype(np.int32) - np.asarray(jacts[0]).astype(np.int32))
        assert dq.max() <= 1 and dq.mean() < 1e-2
        np.testing.assert_allclose(tacts[1].numpy(), np.asarray(jacts[1]), rtol=1e-5, atol=0)
    else:
        np.testing.assert_allclose(tacts.numpy(), np.asarray(jacts), rtol=1e-5, atol=1e-5)
    jtr, jopt, jm = jtune(j[3].trainable, j[3].opt, jacts, _jbatch(b))
    ttr, topt, tm = ttune(t[3].trainable, t[3].opt, tacts, to_device(b, CPU))
    tol = 1e-3 if compress else 1e-4
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=tol / 10)
    _tree_close(jopt.m, convert.params_to_jax(topt.m), tol, 1e-8, "m",
                of_max=3e-3 if compress else 0.0)
    _tree_close(jtr, convert.params_to_jax(ttr.state_dict()), 1e-5, 2 * float(jm["lr"]),
                "params")


def _seq(arch):
    cfg = get_smoke_config(arch)
    return SEQ + cfg.n_patches if cfg.family == "vlm" else SEQ


def _loss_falls(arch):
    out = run_training(arch, steps=8, batch=4, seq=_seq(arch), lr=1e-3, log_every=100,
                       dataset_batches=1, device="cpu")
    assert np.all(np.isfinite(out["losses"])) and out["steps"] == 8
    assert np.mean(out["losses"][-2:]) < np.mean(out["losses"][:2])


@pytest.mark.parametrize("arch", ENCDEC_VLM)
def test_run_training_loss_falls(arch):
    _loss_falls(arch)


def test_run_training_whisper_crash_resume(tmp_path):
    """A crash at step 4, then a resume from the step-4 checkpoint (its
    ``enc_blocks`` and ``dec_blocks``) and the pipeline's cursor: the same
    trajectory as the run without the crash."""
    d = str(tmp_path / "ck")
    kw = dict(steps=6, batch=4, seq=SEQ, lr=1e-3, log_every=100, device="cpu")
    ref_run = run_training("whisper-small", ckpt_dir="", **kw)
    killed = run_training("whisper-small", ckpt_dir=d, ckpt_every=2, kill_at=4, **kw)
    assert killed["killed_at"] == 4
    out = run_training("whisper-small", ckpt_dir=d, ckpt_every=2, **kw)
    assert len(out["losses"]) == 2
    np.testing.assert_allclose(out["losses"], ref_run["losses"][4:], rtol=1e-5)


@pytest.mark.parametrize("arch", ENCDEC_VLM)
def test_train_cli_on_cpu(arch, capsys):
    from repro_torch.launch import train as ttrain
    ttrain.main(["--arch", arch, "--device", "cpu", "--steps", "2", "--batch", "4",
                 "--seq", str(_seq(arch))])
    out = capsys.readouterr().out
    assert "[plan] split=" in out and "'steps': 2" in out


def test_run_training_refuses_a_vlm_sequence_of_patches_only():
    n = get_smoke_config("llava-next-mistral-7b").n_patches
    with pytest.raises(ValueError, match="no text"):
        run_training("llava-next-mistral-7b", steps=1, batch=2, seq=n, device="cpu")
