"""Elastic re-meshing, the GPipe pipeline and the tier steps of the port.

``repro_torch.distributed.elastic`` and ``.pipeline`` against the JAX
package's on the CPU: ``plan_elastic_mesh`` on a grid; ``reshard_state`` of
a state restored from a checkpoint onto one gloo rank and onto 4 spawned
gloo ranks on a (4, 1) mesh, after which training goes on as the
uninterrupted one-device run does (f32 smoke, within 1e-5); the 4-stage
pipeline on 4 spawned gloo ranks against the JAX program of
``tests/test_distributed_extras.py`` (``PIPE_PROG``'s schedule under
``shard_map`` on 4 fake host devices, in a subprocess) on the same numpy
weights. Spawned ranks share a ``FileStore`` under ``tmp_path``, have a
process-group timeout and are joined within ``JOIN_S``. Then the port's
tier steps against its integrated step, and their int8 wire.
"""
import copy
import datetime
import multiprocessing as mp
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.config import MeshSpec, RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.splitter import SplitDecision
from repro_torch.core.tier_split import TierPlan
from repro_torch.distributed.elastic import plan_elastic_mesh, reshard_state
from repro_torch.distributed.pipeline import pipeline_bubble_fraction, pipeline_stages
from repro_torch.models.api import build_model
from repro_torch.train.steps import build_hapi_train_step, build_tier_steps, init_train_state

JOIN_S = 180
PG_TIMEOUT = datetime.timedelta(seconds=30)
ROOT = Path(__file__).resolve().parents[1]


def _rank(target, *args):
    """A spawned rank: one intra-op thread (the ranks share the host's
    cores with each other and with the other tests), then ``target``."""
    torch.set_num_threads(1)
    target(*args)


def _spawn(target, world, args, join_s=JOIN_S):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(target, r, world, *args)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(join_s)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {world} ranks did not finish within {join_s} s"
    assert [p.exitcode for p in procs] == [0] * world


# ---------------------------------------------------------------------------
# Elastic re-meshing
# ---------------------------------------------------------------------------
def test_plan_elastic_mesh_equals_the_jax_packages():
    from repro.config import MeshSpec as JMeshSpec
    from repro.distributed.elastic import plan_elastic_mesh as jplan

    refs = [((16, 16), ("data", "model")), ((4, 1), ("data", "model")),
            ((2, 16, 16), ("pod", "data", "model")), ((8, 4), ("data", "model"))]
    for shape, axes in refs:
        for n in (1, 2, 3, 4, 7, 12, 16, 64, 96, 240, 255, 256, 512):
            for param_bytes in (0.0, 1e9, 100e9, 2e12):
                for budget in (16e9, 80e9):
                    got = plan_elastic_mesh(n, MeshSpec(shape, axes), param_bytes, budget)
                    want = jplan(n, JMeshSpec(shape, axes), param_bytes, budget)
                    assert (got.shape, got.axes) == (want.shape, want.axes), (n, shape, budget)


def test_plan_elastic_shrink_and_budget():
    """tests/test_distributed_extras.py's cases, with the port's 80 GB default."""
    ref = MeshSpec((16, 16), ("data", "model"))
    ms = plan_elastic_mesh(240, ref)
    assert ms.n_devices == 240 and ms.axis_size("model") <= 16
    assert plan_elastic_mesh(512, ref).axis_size("model") <= 16
    assert plan_elastic_mesh(1, ref, param_bytes=100e9, hbm_budget=16e9).n_devices == 1
    ms = plan_elastic_mesh(64, ref, param_bytes=100e9, hbm_budget=16e9)
    assert ms.axis_size("model") * ms.axis_size("data") == 64
    # 100 GB of parameters fit on 2 cards of 80 GB, not on 1.
    assert plan_elastic_mesh(2, ref, param_bytes=100e9).shape == (1, 2)
    assert plan_elastic_mesh(1, MeshSpec((1, 1), ("data", "model")), 10e9).shape == (1, 1)


def _smoke_train(arch="qwen3-32b", seed=0, batch=8, seq=32):
    cfg = get_smoke_config(arch)
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", "train", seq, batch),
                   train=TrainConfig(microbatch=4, warmup_steps=1))
    plan = TierPlan(1, 4, False, SplitDecision(1, 0, 0, [], "t"))
    lm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size,
                                                             (batch, seq))).int()
    return lm, rc, plan, init_train_state(lm, rc, plan), {"tokens": toks, "labels": toks}


def _sharded_step(lm, rc, plan, state, batch, ms, mesh):
    """One train step on the resharded state, the batch over data."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed.autoshard import activation_sharding
    from repro_torch.distributed.sharding import Sharder, batch_pspecs, opt_state_pspecs
    from repro_torch.distributed.sharding import placements
    from repro_torch.launch.dryrun import make_constrain

    dp = Sharder(ms).dp(rc.shape.global_batch)
    bs = batch_pspecs(rc.model, rc.shape, ms)
    db = {k: distribute_tensor(v, mesh, placements(bs[k], mesh)) for k, v in batch.items()}
    constrain = make_constrain(mesh, ms, dp, opt_state_pspecs(state.trainable, ms))
    with activation_sharding(dp, model_size=ms.axis_size("model"), mesh=mesh):
        return build_hapi_train_step(lm, rc, plan, constrain=constrain)(state, db)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _resume(ckpt, ms, mesh):
    """Restore the checkpoint into host tensors of another seed's state,
    reshard onto ``mesh`` and train one more step: (loss, trainable, m)."""
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    lm, rc, plan, like, batch = _smoke_train(seed=9)
    state, _, step = restore_checkpoint(ckpt, like)
    assert step == 1
    assert plan_elastic_mesh(mesh.size(), ms) == ms
    state, _ = reshard_state(state, ms, mesh=mesh)
    state, metrics = _sharded_step(lm, rc, plan, state, batch, ms, mesh)
    return (float(_full(metrics["loss"])),
            {k: _full(v).detach() for k, v in state.trainable.state_dict().items()},
            {k: _full(v) for k, v in state.opt.m.items()}, int(_full(state.opt.step)))


def _reshard_rank(rank, world, store, ckpt, out):
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=PG_TIMEOUT)
    try:
        from repro_torch.launch.mesh import make_small_mesh, small_mesh_spec
        res = _resume(ckpt, small_mesh_spec(world, 1), make_small_mesh(world, 1))
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """Two one-device steps, with a checkpoint after the first."""
    from repro_torch.checkpoint.ckpt import save_checkpoint
    d = tmp_path_factory.mktemp("ckpt")
    lm, rc, plan, state, batch = _smoke_train()
    step = build_hapi_train_step(lm, rc, plan)
    state, _ = step(state, batch)
    save_checkpoint(str(d), 1, state)
    state, metrics = step(state, batch)
    return str(d), float(metrics["loss"]), \
        {k: v.detach().clone() for k, v in state.trainable.state_dict().items()}, \
        {k: v.clone() for k, v in state.opt.m.items()}


def _assert_resumed(res, uninterrupted):
    loss, trainable, m, step = res
    _, want_loss, want_t, want_m = uninterrupted
    assert step == 2
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    for k, v in want_t.items():
        torch.testing.assert_close(trainable[k], v, atol=1e-5, rtol=0)
        scale = float(want_m[k].abs().max())
        torch.testing.assert_close(m[k], want_m[k], atol=1e-5 * scale + 1e-12, rtol=0)


def test_reshard_restored_checkpoint_onto_one_gloo_rank(tmp_path, uninterrupted):
    from repro_torch.launch.mesh import make_small_mesh, small_mesh_spec
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=PG_TIMEOUT)
    try:
        res = _resume(uninterrupted[0], small_mesh_spec(1, 1), make_small_mesh(1, 1))
    finally:
        dist.destroy_process_group()
    _assert_resumed(res, uninterrupted)


def test_reshard_restored_checkpoint_onto_four_gloo_ranks(tmp_path, uninterrupted):
    out = tmp_path / "out.pt"
    _spawn(_reshard_rank, 4, (str(tmp_path / "store"), uninterrupted[0], str(out)))
    _assert_resumed(torch.load(out), uninterrupted)


# ---------------------------------------------------------------------------
# Pipeline parallelism
# ---------------------------------------------------------------------------
def test_pipeline_bubble_math():
    assert pipeline_bubble_fraction(2, 8) == pytest.approx(1 / 9)
    assert pipeline_bubble_fraction(4, 16) == pytest.approx(3 / 19)
    assert pipeline_bubble_fraction(1, 4) == 0.0


S, M, D = 4, 8, 16
JAX_PIPE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    sys.path.insert(0, "src")
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.distributed.pipeline import pipeline_stages

    S, M = 4, 8
    w, x = np.load(sys.argv[1]), np.load(sys.argv[2])
    mesh = jax.make_mesh((S,), ("stage",))
    fn = lambda sp, v: jnp.tanh(v @ sp["w"])
    body = pipeline_stages(fn, S, M, axis="stage")
    piped = jax.jit(shard_map(
        body, mesh=mesh, in_specs=({"w": P("stage")}, P("stage")),
        out_specs=P(), check_vma=False,
    ))({"w": jnp.asarray(w)}, jnp.asarray(x))
    np.save(sys.argv[3], np.asarray(piped))
""")


def _pipe_inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((S, D, D)) * 0.3).astype(np.float32)   # one matrix a stage
    x = rng.standard_normal((M, 2, D)).astype(np.float32)
    return w, x


def _pipe_rank(rank, world, store, out):
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=PG_TIMEOUT)
    try:
        w, x = _pipe_inputs()
        per = M // S
        body = pipeline_stages(lambda sp, v: torch.tanh(v @ sp), S, M)
        y = body(torch.from_numpy(w[rank]), torch.from_numpy(x[rank * per:(rank + 1) * per]))
        torch.save(y, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def test_pipeline_four_gloo_ranks_equal_the_jax_program(tmp_path):
    w, x = _pipe_inputs()
    _spawn(_pipe_rank, S, (str(tmp_path / "store"), str(tmp_path / "y")))
    ys = [torch.load(tmp_path / f"y.{r}") for r in range(S)]
    for y in ys[1:]:
        assert torch.equal(y, ys[0])                   # every rank holds the output
    ref = torch.from_numpy(x)
    for s in range(S):
        ref = torch.tanh(ref @ torch.from_numpy(w[s]))
    torch.testing.assert_close(ys[0], ref, atol=1e-6, rtol=0)
    np.save(tmp_path / "w.npy", w)
    np.save(tmp_path / "x.npy", x)
    r = subprocess.run([sys.executable, "-c", JAX_PIPE, str(tmp_path / "w.npy"),
                        str(tmp_path / "x.npy"), str(tmp_path / "jax.npy")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    np.testing.assert_allclose(ys[0].numpy(), np.load(tmp_path / "jax.npy"), atol=1e-5, rtol=0)


def test_pipeline_one_rank_is_the_blocks_in_turn(tmp_path):
    """One stage: each microbatch through fn, bit for bit."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=PG_TIMEOUT)
    try:
        w, x = _pipe_inputs()
        fn = lambda sp, v: torch.tanh(torch.tanh(v @ sp[0]) @ sp[1])  # noqa: E731
        y = pipeline_stages(fn, 1, M)(torch.from_numpy(w), torch.from_numpy(x))
    finally:
        dist.destroy_process_group()
    for i in range(M):
        assert torch.equal(y[i], fn(torch.from_numpy(w), torch.from_numpy(x[i])))


# ---------------------------------------------------------------------------
# Tier steps (the two-program split tierdry counts)
# ---------------------------------------------------------------------------
def test_tier_steps_match_integrated():
    lm, rc, plan, state, batch = _smoke_train("gemma2-9b")
    extract_step, tune_step = build_tier_steps(lm, rc, plan)
    s0 = copy.deepcopy(state)
    acts = extract_step(state.frozen, batch)
    new_t, _, m2 = tune_step(state.trainable, state.opt, acts, batch)
    s1, m1 = build_hapi_train_step(lm, rc, plan)(s0, batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for (k, a), b in zip(s1.trainable.state_dict().items(), new_t.state_dict().values()):
        torch.testing.assert_close(a, b, atol=5e-3, rtol=0)


def test_tier_steps_int8_wire():
    lm, rc, _, state, batch = _smoke_train("mistral-nemo-12b")
    plan = TierPlan(1, 4, True, SplitDecision(1, 0, 0, [], "t"))
    extract_step, tune_step = build_tier_steps(lm, rc, plan)
    q, scales = extract_step(state.frozen, batch)
    assert q.dtype == torch.int8 and scales.dtype == torch.float32
    wire = q.numel() + scales.numel() * 4
    assert wire < 0.6 * q.numel() * 4          # against the f32 smoke activations
    _, _, m = tune_step(state.trainable, state.opt, (q, scales), batch)
    assert np.isfinite(float(m["loss"]))
