"""The sharded train step of the port on 4 gloo ranks, on the CPU.

Smoke dense (mistral-nemo-12b) and MoE (moonshot-v1-16b-a3b) models here,
SSM (mamba2-1.3b) and encoder-decoder (whisper-small) ones in
``tests/test_torch_sharded_step_ssm.py``, on a (2, 2) ("data", "model")
mesh of 4 spawned gloo ranks: the state placed by ``reshard_state``
(``param_pspecs(fsdp=True)``, ``opt_state_pspecs``), the batch over data,
``activation_sharding`` and the step's ``constrain`` hook, the int8
boundary. One step equals the one-device port step from the same state
within 1e-5, with the attention heads, moonshot's experts and mamba2's SSM
heads sharded over the model axis. The ranks share a ``FileStore`` under the
test's temporary directory and are joined within ``JOIN_S``.
"""
import copy
import datetime

import pytest
import torch
import torch.distributed as dist

from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.splitter import SplitDecision
from repro_torch.core.tier_split import TierPlan
from repro_torch.models.api import build_model

PG_TIMEOUT = datetime.timedelta(seconds=30)


SHARDED_ARCHS = ("mistral-nemo-12b", "moonshot-v1-16b-a3b")
# DTensor's first dispatch of each op signature is slow on the CPU (its
# sharding propagation weighs every strategy): a rank takes about 20 s an
# arch, longer on a loaded host.
JOIN_S = 240


def _smoke(arch, batch=8, seq=32):
    cfg = get_smoke_config(arch)
    rc = RunConfig(model=cfg, shape=ShapeConfig("t", "train", seq, batch),
                   train=TrainConfig(microbatch=4, warmup_steps=1))
    plan = TierPlan(1, 4, True, SplitDecision(1, 0, 0, [], "t"))
    lm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (batch, cfg.dec_seq if cfg.family == "encdec"
                                             else seq), generator=g)
    b = {"tokens": toks, "labels": toks}
    if cfg.family == "encdec":
        b["frames"] = torch.randn(batch, seq, cfg.d_model, generator=g)
    return lm, rc, plan, b


def _sharded_rank(rank, world, store, out, archs=SHARDED_ARCHS):
    from repro_torch.distributed.elastic import reshard_state
    from repro_torch.launch.mesh import make_small_mesh, small_mesh_spec
    from repro_torch.train.steps import build_hapi_train_step, init_train_state
    from test_torch_distributed_extras import _full, _sharded_step
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=PG_TIMEOUT)
    try:
        res = {}
        ms, mesh = small_mesh_spec(2, 2), make_small_mesh(2, 2)
        for arch in archs:
            lm, rc, plan, batch = _smoke(arch)
            state = init_train_state(lm, rc, plan)
            ref, ref_m = build_hapi_train_step(lm, rc, plan)(copy.deepcopy(state), batch)
            state, _ = reshard_state(state, ms, mesh=mesh)
            places = {k: tuple(repr(p) for p in v.placements)
                      for k, v in state.trainable.named_parameters()}
            state, m = _sharded_step(lm, rc, plan, state, batch, ms, mesh)
            res[arch] = dict(
                loss=(float(_full(m["loss"])), float(ref_m["loss"])), placements=places,
                trainable=[(k, _full(v).detach(), ref.trainable.state_dict()[k])
                           for k, v in state.trainable.state_dict().items()],
                m=[(k, _full(v), ref.opt.m[k]) for k, v in state.opt.m.items()])
        if rank == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    from test_torch_distributed_extras import _spawn
    d = tmp_path_factory.mktemp("sharded")
    _spawn(_sharded_rank, 4, (str(d / "store"), str(d / "out.pt")), join_s=JOIN_S)
    return torch.load(d / "out.pt")


@pytest.mark.parametrize("arch", SHARDED_ARCHS)
def test_sharded_step_on_four_gloo_ranks_equals_the_one_device_step(sharded, arch):
    """(2, 2): batch over data, heads (and moonshot's experts) over model,
    weights and moments ZeRO-sharded over data; the int8 boundary. Loss,
    trainable parameters and first moments within 1e-5."""
    check_sharded(sharded[arch], arch)


def check_sharded(r, arch):
    """The loss within 1e-5 relative, the parameters within 1e-5 and each
    first moment within 1e-5 of the largest first moment of the state (the
    gradient's scale): mamba2's D, whose gradient nearly cancels (its m is
    about 1e-3 of the state's largest), is otherwise held to the rounding of
    the sums it cancels from."""
    assert abs(r["loss"][0] - r["loss"][1]) <= 1e-5 * abs(r["loss"][1])
    for name, got, want in r["trainable"]:
        torch.testing.assert_close(got, want, atol=1e-5, rtol=0, msg=name)
    scale = max(float(want.abs().max()) for _, _, want in r["m"])
    for name, got, want in r["m"]:
        torch.testing.assert_close(got, want, atol=1e-5 * scale, rtol=0, msg=name)
    p = r["placements"]
    attn = "blocks.0.sub0.attn.wq" if arch != "whisper-small" else "enc_blocks.0.attn.wq"
    if arch != "mamba2-1.3b":
        assert p[attn][1] == "Shard(dim=1)"                 # heads over model
    if arch == "moonshot-v1-16b-a3b":
        assert p["blocks.0.sub0.moe.w_gate"][1] == "Shard(dim=0)"   # experts over model
    if arch == "mamba2-1.3b":
        assert p["blocks.0.sub0.mamba.w_x"][1] == "Shard(dim=1)"    # SSM heads
