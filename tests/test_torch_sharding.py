"""The port's sharding rules against the JAX package's.

``repro_torch.distributed.sharding`` over the port's state dicts and caches
against ``repro.distributed.sharding`` over the JAX trees, for every arch on
both production meshes: a port tensor's spec is the JAX leaf's with the
block axis dropped, and the only JAX leaves that put an axis on the block
axis are mamba2-1.3b's ``A_log``, ``D`` and ``dt_bias`` on ``SINGLE_POD``
(which the port keeps replicated over the data axes). Then the ports of
``tests/test_sharding.py``'s nine cases, and ``placements`` on a fake
(16, 16) mesh.
"""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.config import MULTI_POD as J_MULTI, SINGLE_POD as J_SINGLE
from repro.config import MeshSpec as JMeshSpec, SHAPES as J_SHAPES
from repro.configs import get_config as jget_config, get_smoke_config as jget_smoke
from repro.distributed import sharding as jsh
from repro.launch.specs import param_specs as jparam_specs
from repro.models.api import build_model as jbuild_model
from repro_torch.config import MULTI_POD, SINGLE_POD, SHAPES, MeshSpec, ShapeConfig
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.sharding import Spec, placements
from repro_torch.launch.specs import meta_model, param_specs
from repro_torch.models.api import build_model
from repro_torch.optim.adamw import jax_path

MESHES = {"single": (SINGLE_POD, J_SINGLE), "multi": (MULTI_POD, J_MULTI)}
BLOCK_AXIS_LEAVES = {("mamba2-1.3b", "single", "blocks/sub0/mamba/" + n)
                     for n in ("A_log", "D", "dt_bias")}


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return param_specs(meta_model(get_config(arch)))


def _port_shapes(arch):
    return {k: tuple(p.shape) for k, p in _port_params(arch).items()}


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    return jparam_specs(jbuild_model(jget_config(arch)))


def _flat(specs, shapes):
    """{path: (spec tuple padded to the leaf's rank, shape)} of a JAX tree."""
    flat_sp = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda x: isinstance(x, P))[0]
    flat_sh = jax.tree_util.tree_flatten_with_path(shapes)[0]
    out = {}
    for (path, sp), (_, sh) in zip(flat_sp, flat_sh):
        out[jsh._path_str(path)] = (tuple(sp) + (None,) * (len(sh.shape) - len(sp)),
                                    tuple(sh.shape))
    return out


def _compare(arch, mesh, port_specs, jax_flat):
    """Each port tensor's spec is its JAX leaf's with the block axis dropped;
    returns the JAX leaves that put an axis on the block axis."""
    on_block_axis = set()
    seen = set()
    for name, shape in _port_shapes(arch).items():
        path, stacked = jax_path(name)
        jspec, jshape = jax_flat[path]
        seen.add(path)
        if stacked:
            assert jshape[1:] == shape, (name, jshape, shape)
            if jspec[0] is not None:
                on_block_axis.add((arch, mesh, path))
            jspec = jspec[1:]
        assert port_specs[name].padded(len(shape)) == jspec, (arch, mesh, name,
                                                               port_specs[name], jspec)
    assert seen == set(jax_flat), set(jax_flat) ^ seen
    return on_block_axis


def test_param_specs_are_the_jax_eval_shape_on_meta():
    """``launch.specs.param_specs``: every leaf of the JAX package's
    ``eval_shape`` (a block's slice of a stacked one) as a meta tensor of
    its dtype, no other tensor, and the same parameter count."""
    for arch in ARCH_IDS:
        shapes = _jax_shapes(arch)
        flat = {jsh._path_str(p): leaf
                for p, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        n = 0
        for name, t in _port_params(arch).items():
            path, stacked = jax_path(name)
            want = flat[path]
            assert t.device.type == "meta" and str(t.dtype)[6:] == str(want.dtype), name
            assert tuple(t.shape) == (want.shape[1:] if stacked else want.shape), name
            n += t.numel()
        assert n == sum(x.size for x in flat.values()), arch


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("fsdp", [True, False])
def test_param_specs_equal_the_jax_packages(mesh, fsdp):
    ms, jms = MESHES[mesh]
    on_block_axis = set()
    for arch in ARCH_IDS:
        shapes = _jax_shapes(arch)
        jflat = _flat(jsh.param_pspecs(shapes, jms, fsdp=fsdp), shapes)
        port = tsh.param_pspecs(_port_shapes(arch), ms, fsdp=fsdp)
        on_block_axis |= _compare(arch, mesh, port, jflat)
    assert on_block_axis == (BLOCK_AXIS_LEAVES if fsdp and mesh == "single" else set())


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_opt_state_specs_equal_the_jax_packages(mesh):
    ms, jms = MESHES[mesh]
    on_block_axis = set()
    for arch in ARCH_IDS:
        shapes = _jax_shapes(arch)
        jflat = _flat(jsh.opt_state_pspecs(shapes, jms), shapes)
        on_block_axis |= _compare(arch, mesh, tsh.opt_state_pspecs(_port_shapes(arch), ms),
                                  jflat)
    assert on_block_axis == (BLOCK_AXIS_LEAVES if mesh == "single" else set())


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_act_and_logits_specs_equal_the_jax_packages(mesh):
    ms, jms = MESHES[mesh]
    for arch in ARCH_IDS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        for name in SHAPES:
            shape, jshape = SHAPES[name], J_SHAPES[name]
            port = tsh.batch_pspecs(cfg, shape, ms)
            want = jsh.batch_pspecs(jcfg, jshape, jms)
            assert port.keys() == want.keys()
            for k in port:
                assert tuple(port[k]) == tuple(want[k]), (arch, name, k)
            b = shape.global_batch
            assert tuple(tsh.act_pspec(cfg, b, ms)) == tuple(jsh.act_pspec(jcfg, b, jms))
            assert tuple(tsh.logits_pspec(cfg, b, ms)) == tuple(jsh.logits_pspec(jcfg, b, jms))


def _port_cache(arch, batch, smax):
    cfg = get_smoke_config(arch)
    lm = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    return cfg, lm.init_cache(batch, smax)


def _jax_cache(arch, batch, smax):
    return jax.eval_shape(lambda: jbuild_model(jget_smoke(arch)).init_cache(batch, smax))


def _cache_pairs(port, jax_cache):
    """(port leaf, JAX leaf, block index) for every leaf of both caches."""
    if isinstance(port, dict):                       # the encoder-decoder's
        for key in port:
            for i, c in enumerate(port[key]):
                for f in c._fields:
                    yield getattr(c, f), getattr(jax_cache[key], f), i
        return
    for i, block in enumerate(port):
        for sub, c in block.items():
            for f in c._fields:
                yield getattr(c, f), getattr(jax_cache[sub], f), i


@pytest.mark.parametrize("mesh_shape", [(4, 2), (4, 4)])
@pytest.mark.parametrize("arch,batch", [("mistral-nemo-12b", 8), ("mamba2-1.3b", 8),
                                        ("jamba-v0.1-52b", 1), ("jamba-v0.1-52b", 8),
                                        ("gemma2-9b", 8), ("gemma2-9b", 1),
                                        ("whisper-small", 4), ("moonshot-v1-16b-a3b", 2)])
def test_cache_specs_equal_the_jax_packages(mesh_shape, arch, batch):
    """Smoke caches of 64 positions (the JAX rule tells a conv window from a
    KV cache by a sequence of at most 8); jamba at batch 1 takes the
    sequence layout over data, gemma2's 2 KV heads on a model axis of 2 or 4
    the flash-decode layout (on 4, the sequence over the model axis)."""
    ms, jms = MeshSpec(mesh_shape, ("data", "model")), JMeshSpec(mesh_shape, ("data", "model"))
    cfg, port = _port_cache(arch, batch, 64)
    jcache = _jax_cache(arch, batch, 64)
    pspecs = tsh.cache_pspecs(port, cfg, batch, ms)
    jspecs = jsh.cache_pspecs(jcache, jget_smoke(arch), batch, jms)
    pairs = list(_cache_pairs(pspecs, jspecs))
    leaves = list(_cache_pairs(port, jcache))
    assert len(pairs) == len(leaves) > 0
    for (spec, jspec, _), (t, jt, _) in zip(pairs, leaves):
        assert tuple(jt.shape[1:]) == tuple(t.shape)
        jpad = tuple(jspec) + (None,) * (jt.ndim - len(jspec))
        assert jpad[0] is None
        assert spec.padded(t.dim()) == jpad[1:], (arch, batch, mesh_shape, spec, jspec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_no_spec_assigns_an_axis_to_a_dim_it_does_not_divide(arch):
    shapes = _port_shapes(arch)
    for ms in (SINGLE_POD, MULTI_POD):
        for specs in (tsh.param_pspecs(shapes, ms, fsdp=True),
                      tsh.param_pspecs(shapes, ms, fsdp=False), tsh.opt_state_pspecs(shapes, ms)):
            for name, spec in specs.items():
                for d in range(len(spec)):
                    assert shapes[name][d] % tsh.spec_size(spec, d, ms) == 0, (arch, name, spec)
                axes = [a for d in range(len(spec)) for a in spec.axes(d)]
                assert len(set(axes)) == len(axes), (name, spec)


# ---------------------------------------------------------------------------
# tests/test_sharding.py's cases on the port
# ---------------------------------------------------------------------------
def test_attention_heads_tp_sharded():
    specs = tsh.param_pspecs(_port_shapes("qwen3-32b"), SINGLE_POD, fsdp=False)
    assert specs["blocks.0.sub0.attn.wq"][1] == "model"      # (D, H, hd): heads


def test_whisper_heads_fall_back_to_replicated():
    specs = tsh.param_pspecs(_port_shapes("whisper-small"), SINGLE_POD, fsdp=False)
    assert "model" not in tuple(specs["enc_blocks.0.attn.wq"])
    assert specs["enc_blocks.0.mlp.w_gate"][-1] == "model"   # d_ff 3072 shards


def test_grok_experts_fall_back_to_dff():
    specs = tsh.param_pspecs(_port_shapes("grok-1-314b"), SINGLE_POD, fsdp=False)
    wg = specs["blocks.0.sub0.moe.w_gate"].padded(3)          # (E, D, F)
    assert wg[0] is None and wg[2] == "model"


def test_moonshot_experts_ep_sharded():
    specs = tsh.param_pspecs(_port_shapes("moonshot-v1-16b-a3b"), SINGLE_POD, fsdp=False)
    assert specs["blocks.0.sub0.moe.w_gate"][0] == "model"


def test_fsdp_adds_data_axis():
    flat = tuple(tsh.param_pspecs(_port_shapes("qwen1.5-110b"), SINGLE_POD,
                                  fsdp=True)["blocks.0.sub0.attn.wq"])
    assert "model" in flat and "data" in flat


def test_zero_specs_disjoint_axes():
    for spec in tsh.opt_state_pspecs(_port_shapes("mistral-nemo-12b"), MULTI_POD).values():
        axes = [a for d in range(len(spec)) for a in spec.axes(d)]
        assert len(set(axes)) == len(axes), spec


def test_batch_specs():
    cfg = get_config("qwen3-32b")
    assert tsh.batch_pspecs(cfg, ShapeConfig("t", "train", 4096, 256), SINGLE_POD)["tokens"] \
        == Spec("data")
    assert tsh.batch_pspecs(cfg, ShapeConfig("l", "decode", 524288, 1), SINGLE_POD)["tokens"] \
        == Spec()
    assert tsh.batch_pspecs(cfg, ShapeConfig("t", "train", 4096, 256), MULTI_POD)["tokens"] \
        == Spec(("pod", "data"))


def test_cache_specs_long_context_shards_sequence():
    cfg, cache = _port_cache("jamba-v0.1-52b", 1, 512)
    specs = tsh.cache_pspecs(cache, cfg, 1, MeshSpec((4, 2), ("data", "model")))
    kv = [c.k for block in specs for c in block.values() if hasattr(c, "k")]
    assert kv and all(s[1] in ("data", ("data",)) for s in kv)


def test_divisibility_never_violated():
    for arch in ("qwen3-32b", "whisper-small", "grok-1-314b", "mamba2-1.3b"):
        shapes = _port_shapes(arch)
        for ms in (SINGLE_POD, MULTI_POD):
            for name, spec in tsh.param_pspecs(shapes, ms, fsdp=True).items():
                for d in range(len(spec)):
                    assert shapes[name][d] % tsh.spec_size(spec, d, ms) == 0


# ---------------------------------------------------------------------------
def test_placements_on_a_fake_production_mesh_give_the_local_shapes():
    """A (5120, 64, 128) meta tensor over (16, 16): heads over data and head
    dim over model, a tuple over both data axes of the multi-pod mesh."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh

    with fake_world(256, rank=3):
        mesh = make_mesh(SINGLE_POD, "cpu")
        assert list(mesh.get_coordinate()) == [0, 3]
        spec = Spec(None, "data", "model")
        assert placements(spec, mesh) == (Shard(1), Shard(2))
        t = torch.empty((5120, 64, 128), dtype=torch.bfloat16, device="meta")
        assert tuple(distribute_tensor(t, mesh, placements(spec, mesh)).to_local().shape) \
            == (5120, 4, 8)
        assert placements(Spec(), mesh) == (Replicate(), Replicate())
        with pytest.raises(ValueError, match="pod"):
            placements(Spec("pod"), mesh)
    with fake_world(512):
        mesh = make_mesh(MULTI_POD, "cpu")
        spec = Spec(("pod", "data"), None, "model")
        assert placements(spec, mesh) == (Shard(0), Shard(0), Shard(2))
        t = torch.empty((256, 4096, 5120), dtype=torch.bfloat16, device="meta")
        assert tuple(distribute_tensor(t, mesh, placements(spec, mesh)).to_local().shape) \
            == (8, 4096, 320)


def test_activation_constraints_pin_dtensors_inside_the_context_only():
    """constrain_act, constrain_dims and constrain_logits return their input
    outside activation_sharding (and on plain tensors); inside it they
    redistribute a DTensor to the pinned placements, as the JAX package's
    with_sharding_constraint: the batch over data, the MoE buffer's experts
    over model (else its d_ff), the vocabulary over model where it divides."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.distributed import autoshard as A
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_mesh

    ms = MeshSpec((4, 4), ("data", "model"))
    with fake_world(16):
        mesh = make_mesh(ms, "cpu")

        def rep(*shape):
            return distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                     [Replicate(), Replicate()])

        h, logits = rep(8, 16, 32), rep(8, 16, 512)
        assert A.constrain_act(h) is h and A.constrain_logits(logits) is logits
        assert not A.active()
        with A.activation_sharding("data", model_size=4, mesh=mesh):
            assert A.active()
            assert A.constrain_act(h).placements == (Shard(0), Replicate())
            assert A.constrain_logits(logits).placements == (Shard(0), Shard(2))
            assert A.constrain_logits(rep(8, 16, 510)).placements == (Shard(0), Replicate())
            dims, alt = ("batch", "model", None, None), ("batch", None, None, "model")
            assert A.constrain_dims(rep(8, 8, 3, 12), dims, alt).placements == (Shard(0), Shard(1))
            assert A.constrain_dims(rep(8, 6, 3, 12), dims, alt).placements == (Shard(0), Shard(3))
            plain = torch.empty(8, 16, 32)
            assert A.constrain_act(plain) is plain
        assert not A.active()
