"""The port's dry-run against the JAX package's, on the CPU.

The (arch x shape) matrix, the meta stand-ins (``param_specs`` in
``tests/test_torch_sharding.py``), ``plan_for_mesh`` and the
model FLOP formulas against ``repro.launch``'s; ``launch.cost_analysis`` on
``tests/test_hlo_analysis.py``'s cases and on each kernel entry point's meta
path; whisper-small's decode_32k cell at 256 fake ranks through the CLI; and
one tier cell. The sharded train step on 4 gloo ranks is
``tests/test_torch_sharded_step.py``.
"""
import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.config import MULTI_POD, SHAPES, SINGLE_POD, HapiConfig, cell_is_runnable
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import ops, work
from repro_torch.launch import dryrun, tierdry
from repro_torch.launch.cost_analysis import count_cost
from repro_torch.launch.specs import decode_specs, input_specs, meta_model

META = torch.device("meta")


@contextlib.contextmanager
def _jax_dryrun():
    """``repro.launch.dryrun`` (which sets XLA_FLAGS when imported), with the
    environment put back."""
    before = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
        yield jdry
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


# ---------------------------------------------------------------------------
# The cell matrix and the stand-ins
# ---------------------------------------------------------------------------
def test_cell_matrix_equals_the_jax_packages():
    from repro.config import SHAPES as JSHAPES, cell_is_runnable as jrunnable
    from repro.configs import get_config as jget
    assert list(SHAPES) == list(JSHAPES)
    skipped = []
    for arch in ARCH_IDS:
        for s in SHAPES:
            assert SHAPES[s] == dataclasses.replace(SHAPES[s], **vars(JSHAPES[s]))
            ok = cell_is_runnable(get_config(arch), SHAPES[s])
            assert ok == jrunnable(jget(arch), JSHAPES[s])
            if not ok:
                skipped.append((arch, s))
    assert len(skipped) == 8 and all(s == "long_500k" for _, s in skipped)


def test_input_and_decode_specs_equal_the_jax_packages():
    import jax
    from repro.configs import get_config as jget
    from repro.launch.specs import decode_specs as jdecode, input_specs as jinput
    from repro.models.api import build_model as jbuild
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for name, shape in SHAPES.items():
            if not cell_is_runnable(cfg, shape):
                continue
            got, want = input_specs(cfg, shape), jinput(jget(arch), shape)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].device == META
                assert tuple(got[k].shape) == want[k].shape
                assert str(got[k].dtype)[6:] == str(want[k].dtype), (arch, k)
    for arch, shape in (("mamba2-1.3b", "long_500k"), ("whisper-small", "decode_32k"),
                        ("jamba-v0.1-52b", "long_500k"), ("gemma2-9b", "decode_32k")):
        cfg = get_config(arch)
        cache, token, pos = decode_specs(meta_model(cfg), cfg, SHAPES[shape])
        jcache, jtoken, _ = jdecode(jbuild(jget(arch)), jget(arch), SHAPES[shape])
        leaves = []
        dryrun._tree_map(leaves.append, cache)
        assert all(t.device == META for t in leaves)
        n = {t.shape[0] for t in jax.tree.leaves(jcache)}
        assert len(leaves) == sum(int(np.prod(t.shape[:1])) for t in jax.tree.leaves(jcache))
        assert {tuple(t.shape) for t in leaves} == {t.shape[1:] for t in jax.tree.leaves(jcache)}
        assert tuple(token.shape) == jtoken.shape and pos == SHAPES[shape].seq_len - 1
        assert n == {get_config(arch).n_dec_layers if arch == "whisper-small"
                     else get_config(arch).n_blocks}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_plan_for_mesh_equals_the_jax_packages(mesh):
    """Every cell's plan, the train cells' way (the COS batch capped at the
    accumulation chunk over the data shards), at the v5e's 16 GB budget on
    both sides."""
    from repro.config import HapiConfig as JHapi, MULTI_POD as JM, SINGLE_POD as JS
    from repro.config import SHAPES as JSHAPES
    from repro.configs import get_config as jget
    ms, jms = (SINGLE_POD, JS) if mesh == "single" else (MULTI_POD, JM)
    with _jax_dryrun() as jdry:
        for arch in ARCH_IDS:
            for name, shape in SHAPES.items():
                data = ms.n_devices // ms.axis_size("model")
                cos = max(1, max(1, shape.global_batch // 8) // data)
                for compress in (False, True):
                    got = dryrun.plan_for_mesh(get_config(arch), shape, HapiConfig(
                        cos_batch=cos, cos_hbm_budget=16e9, compress_transfer=compress), ms)
                    want = jdry.plan_for_mesh(jget(arch), JSHAPES[name], JHapi(
                        cos_batch=cos, cos_hbm_budget=16e9, compress_transfer=compress), jms)
                    assert (got.split, got.cos_batch, got.compress) == \
                        (want.split, want.cos_batch, want.compress), (arch, name)


def test_model_flops_equal_the_jax_formulas():
    from repro.configs import get_config as jget
    for arch in ARCH_IDS:
        jcfg, cfg = jget(arch), get_config(arch)
        n_act = jcfg.param_count(active_only=True)
        assert cfg.param_count(active_only=True) == n_act
        for name, shape in SHAPES.items():
            extra = {"split": cfg.freeze_index}
            got = dryrun._model_flops(cfg, shape, extra)
            if shape.kind == "train":
                tokens = shape.global_batch * (shape.seq_len if cfg.family != "encdec"
                                               else shape.seq_len + cfg.dec_seq)
                fz = cfg.freeze_index / cfg.n_blocks
                want = (6.0 * n_act * tokens, (2.0 + 4.0 * (1 - fz)) * n_act * tokens)
            else:
                tokens = shape.global_batch * (shape.seq_len if shape.kind == "prefill" else 1)
                want = (2.0 * n_act * tokens,) * 2
            assert got == want, (arch, name)


# ---------------------------------------------------------------------------
# The counter (tests/test_hlo_analysis.py's cases) and the kernels' meta work
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_loop_counted_on_every_trip(device):
    x, w = torch.randn(128, 256, device=device), torch.randn(256, 256, device=device)
    with count_cost() as once:
        torch.tanh(x @ w)
    with count_cost() as c:
        h = x
        for _ in range(10):
            h = torch.tanh(h @ w)
    assert c.flops == 10 * 2 * 128 * 256 * 256 == 10 * once.flops


def test_nested_loops_multiply():
    x, w = torch.randn(64, 64, device=META), torch.randn(64, 64, device=META)
    with count_cost() as c:
        h = x
        for _ in range(3):
            g = h
            for _ in range(4):
                g = g @ w
            h = g
    assert c.flops == 12 * 2 * 64 * 64 * 64


def test_einsum_contraction_counted():
    a, b = torch.randn(4, 32, 64, device=META), torch.randn(4, 64, 16, device=META)
    with count_cost() as c:
        torch.einsum("bij,bjk->bik", a, b)
    assert c.flops == 2 * 4 * 32 * 16 * 64


def test_bytes_accounting_positive():
    a = torch.randn(256, 256, device=META)
    with count_cost() as c:
        (a @ a).sum()
    assert c.bytes >= 3 * 256 * 256 * 4
    assert c.peak_bytes >= 256 * 256 * 4


def test_train_step_runs_under_its_remat_policy():
    """``TrainConfig.remat`` alone sets the policy: "block" runs each
    trainable block's forward again in the backward, so its count exceeds
    "none"'s by the suffix blocks' forward; the port has no "full"."""
    from repro_torch.config import RunConfig, ShapeConfig, TrainConfig
    from repro_torch.core.tier_split import plan_tiers
    from repro_torch.train.steps import build_hapi_train_step, init_train_state
    cfg = dataclasses.replace(get_smoke_config("qwen3-32b"), n_layers=4)
    shape = ShapeConfig("train", "train", seq_len=32, global_batch=4)
    hapi = HapiConfig(cos_batch=4, cos_batch_min=1)
    plan = plan_tiers(cfg, shape, hapi)
    flops = {}
    for policy in ("none", "block"):
        rc = RunConfig(model=cfg, shape=shape, hapi=hapi, train=TrainConfig(remat=policy))
        model = meta_model(cfg)
        state = init_train_state(model, rc, plan)
        batch = input_specs(cfg, shape)
        with count_cost() as c:
            build_hapi_train_step(model, rc, plan)(state, batch)
        flops[policy] = c.flops
    assert 0 < plan.split < cfg.n_blocks
    assert flops["block"] > flops["none"] > 0
    with pytest.raises(ValueError, match="remat policy"):
        build_hapi_train_step(None, RunConfig(model=cfg, shape=shape, hapi=hapi,
                                              train=TrainConfig(remat="full")), plan)


def test_pad_unsharded_matches_dtensors_own_pad_at_256_fake_ranks():
    """The sequence pad of whisper's self cache and mamba's conv on the
    local shards: F.pad's global shape, placements, local shape and count
    (the input made inside the count, as a step's activations are)."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.layers import pad_unsharded
    with dryrun.fake_world(256):
        mesh = make_mesh(SINGLE_POD, "cpu")
        for shape, pl, pad in (((32, 32768, 4096), [Shard(0), Shard(2)], (0, 0, 3, 0)),
                               ((32, 1500, 12, 64), [Shard(0), Replicate()], (0, 0, 0, 0, 0, 36))):
            x = distribute_tensor(torch.empty(shape, dtype=torch.bfloat16, device=META), mesh, pl)
            got, want = [], []
            for fn, out in ((pad_unsharded, got), (F.pad, want)):
                with count_cost() as c:
                    y = fn(x.clone(), pad)
                out += [y.shape, y.stride(), y.placements, y.to_local().shape, c.bytes,
                        c.peak_bytes]
            assert got == want


def test_kernel_entry_points_on_meta_record_their_formulas():
    """Outputs of the right shape, nothing computed, and each kernel's work
    (work.py) once; the backward kernels' under autograd."""
    bf = dict(dtype=torch.bfloat16, device=META)
    q, k = torch.empty(2, 512, 8, 64, **bf), torch.empty(2, 512, 2, 64, **bf)
    with count_cost() as c:
        assert ops.flash_attention(q, k, k, window=100).shape == q.shape
    assert c.kernel_flops == {"flash_attention": work.flash_work(2, 512, 8, 2, 64, True, 100,
                                                                 2)[1]}
    assert c.kernel_bytes["flash_attention"] == work.flash_work(2, 512, 8, 2, 64, True, 100, 2)[0]
    qg = q.clone().requires_grad_()
    with count_cost() as c:
        ops.flash_attention(qg, k, k, causal=False).sum().backward()
    assert c.kernel_flops == {
        "flash_attention": work.flash_work(2, 512, 8, 2, 64, False, None, 2)[1],
        "flash_attention_bwd": work.flash_bwd_work(2, 512, 8, 2, 64, False, None, 2)[1]}
    x = torch.empty(4, 300, 5120, **bf)
    with count_cost() as c:
        qx, s = ops.quantize_int8(x)
        y = ops.dequantize_int8(qx, s, torch.bfloat16)
    assert (qx.dtype, s.shape, y.shape) == (torch.int8, (4, 300, 40), x.shape)
    assert c.kernel_flops == {"quantize_int8": 5 * x.numel(), "dequantize_int8": x.numel()}
    cache = torch.empty(4, 1000, 2, 64, **bf)
    with count_cost() as c:
        out = ops.decode_attention(torch.empty(4, 8, 64, **bf), cache, cache, 700, window=99)
    assert out.shape == (4, 8, 64)
    assert c.kernel_flops == {"decode_attention": work.decode_work(4, 8, 2, 64, 100, 2)[1]}
    xs = torch.empty(2, 512, 8, 64, **bf, requires_grad=True)
    f32 = dict(dtype=torch.float32, device=META)
    dta, bc = torch.empty(2, 512, 8, **f32), torch.empty(2, 512, 16, **bf)
    with count_cost() as c:
        y, state = ops.ssd_scan(xs, dta, dta, bc, bc, chunk=128)
        y.sum().backward()
    assert (y.shape, state.shape) == ((2, 512, 8, 64), (2, 8, 16, 64))
    assert c.kernel_flops == {"ssd_scan": work.ssd_work(2, 512, 8, 64, 16, 128, 2)[1],
                              "ssd_scan_bwd": work.ssd_bwd_work(2, 512, 8, 64, 16, 128, 2)[1]}


# ---------------------------------------------------------------------------
# Production cells
# ---------------------------------------------------------------------------
def test_whisper_decode_32k_cell_at_256_fake_ranks(capsys, tmp_path):
    """The JAX package's own slow-test cell, through the CLI."""
    out = tmp_path / "cell.json"
    assert dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k",
                        "--json", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "[ok] whisper-small" in printed and "dom=" in printed
    import json
    r = json.loads(out.read_text())[0]
    assert r["n_devices"] == 256 and r["flops_per_device"] > 0
    assert r["kernel_flops"]["decode_attention"] > 0
    assert set(r["roofline"]) == {"compute_s", "memory_s", "collective_s"}
    assert 0 < r["peak_bytes_per_device"] < 80e9


def test_one_tier_cell():
    """whisper-small cut to 4 + 2 layers, int8 boundary, on the two 16 x 16
    meshes: each tier counted on a rank of its own mesh, the boundary's
    codes and scales on the wire."""
    cfg = dataclasses.replace(get_config("whisper-small"), n_enc_layers=4, n_dec_layers=2)
    r = tierdry.lower_tier_cell("whisper-small", compress=True, cfg_override=cfg)
    assert r["status"] == "ok" and r["compress"] and 0 < r["split"] < 4
    b, s, d = 256, 4096, cfg.d_model
    assert r["wire_bytes_per_step"] == b * s * d + b * s * (d // 128) * 4
    assert r["storage"]["flops_per_device"] > 0 and r["compute"]["flops_per_device"] > 0
    assert r["bottleneck"] in ("storage_s", "wire_s", "compute_s_total")


def test_every_port_module_imports_without_jax():
    """Every module of the port in a clean interpreter with JAX blocked:
    none imports jax or anything of repro."""
    import subprocess
    import sys
    code = ("import sys, pkgutil, importlib; sys.modules['jax'] = None; "
            "import repro_torch; "
            "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]; "
            "[importlib.import_module(n) for n in names]; "
            "assert 'repro_torch.launch.dryrun' in names and 'repro_torch.distributed.sharding' "
            "in names, names; "
            "assert not [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
