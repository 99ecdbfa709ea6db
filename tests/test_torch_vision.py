"""The port's paper vision models and COS executor against the JAX package's.

AlexNet, ResNet18 and VGG11 at 224 x 224 and the ViT encoder go through
``repro.models.vision`` and ``repro_torch.models.vision`` on the same numpy
images, with the same weights: numpy draws in the reference's parameter
tree (biases, BatchNorm statistics and LayerNorm parameters away from the
init's zeros and ones), carried across by ``convert.vision_params_from_jax``.
Tolerance: ``atol=1e-4`` on every boundary activation (the reference's own
live-executor test uses it); both sides compute in float32, so only
summation order differs (about 2e-5 at worst). The port's executor, registered
with the reference's ``HapiCluster``, must return the JAX executor's acts.
"""
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import HapiCluster, LeastLoadedRouting
from repro.config import HapiConfig as JHapi
from repro.kernels import ref as jref
from repro.models import vision as jv
from repro_torch import convert
from repro_torch.core import tier_split as tts
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import vision as tv

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4


def _draw(path, spec, rng):
    """A leaf of the reference's parameter tree, drawn with numpy: weights
    at the init's scale, and biases, BatchNorm statistics and LayerNorm
    parameters away from the init's zeros and ones, so that a misplaced one
    shows."""
    name = path[-1].key
    shape = spec.shape
    if name in ("var",):
        a = rng.uniform(0.5, 1.5, shape)
    elif name in ("scale", "ln1s", "ln2s"):
        a = 1.0 + 0.1 * rng.standard_normal(shape)
    elif name in ("b", "bias", "mean", "ln1b", "ln2b"):
        a = 0.1 * rng.standard_normal(shape)
    else:
        fan_in = shape[0] if name in ("wq", "wk", "wv") else int(np.prod(shape[:-1]))
        a = rng.standard_normal(shape) / np.sqrt(fan_in)
    return a.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(name, **kw):
    """(JAX model, numpy params in its tree, the port's model on the CPU
    with them carried across)."""
    jvm = jv.PAPER_MODELS[name](**kw)
    rng = np.random.default_rng(len(name))
    params = jax.tree_util.tree_map_with_path(
        lambda path, spec: _draw(path, spec, rng),
        jax.eval_shape(jvm.init, jax.random.PRNGKey(0)))
    tvm = tv.PAPER_MODELS[name](**kw, device="cpu")
    convert.vision_params_from_jax(tvm, params)
    return jvm, params, tvm


def _images(n, seed=0, hw=224):
    return np.random.default_rng(seed).standard_normal((n, hw, hw, 3)).astype(np.float32)


def _every_boundary(jvm, params, tvm, x, hi=None):
    hi = len(jvm.layer_names) if hi is None else hi
    ja, ta = jnp.asarray(x), torch.from_numpy(x)
    with torch.no_grad():
        for i in range(hi):
            ja = jvm.apply_range(params, ja, i, i + 1)
            ta = tvm.apply_range(ta, i, i + 1)
            assert tuple(ta.shape) == ja.shape, (jvm.layer_names[i], ta.shape, ja.shape)
            np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL, rtol=0,
                                       err_msg=f"{jvm.name} boundary {i + 1}")
    return ta


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["alexnet", "resnet18", "vgg11"])
def test_apply_range_every_boundary_matches_jax(name):
    jvm, params, tvm = _pair(name)
    assert tvm.layer_names == jvm.layer_names
    assert (tvm.freeze_index, tvm.input_shape, tvm.num_classes) == \
        (jvm.freeze_index, jvm.input_shape, jvm.num_classes)
    out = _every_boundary(jvm, params, tvm, _images(2))
    assert out.shape == (2, 1000)
    # One call over the whole range is the same as the chain.
    with torch.no_grad():
        whole = tvm.apply_range(torch.from_numpy(_images(2)))
    np.testing.assert_array_equal(whole.numpy(), out.numpy())


def test_vit_narrow_every_boundary_matches_jax():
    jvm, params, tvm = _pair("transformer", d=64, n_layers=2, heads=2)
    assert tvm.layer_names == ["patch_embed", "block0", "block1", "head"]
    _every_boundary(jvm, params, tvm, _images(2, seed=1))


def test_vit_full_width_first_block_matches_jax():
    jvm, params, tvm = _pair("transformer")
    out = _every_boundary(jvm, params, tvm, _images(2, seed=2), hi=2)
    assert out.shape == (2, 196, 384)


@pytest.mark.parametrize("n,k,stride,pads", [
    (224, 11, 4, (3, 4)),    # AlexNet conv1
    (224, 7, 2, (2, 3)),     # ResNet conv1
    (28, 3, 2, (0, 1)),      # ResNet block3a's first conv
    (55, 3, 2, (1, 1)),      # ResNet block2a's first conv
    (55, 1, 2, (0, 0)),      # ResNet block2a's downsample
    (14, 1, 2, (0, 0)),      # ResNet block4a's downsample
    (27, 5, 1, (2, 2)),      # AlexNet conv2
])
def test_same_padding_matches_xla(n, k, stride, pads):
    """XLA's "SAME" (asymmetric under a stride) on its own: the pads, and a
    conv at that shape against ``jax.lax.conv_general_dilated``."""
    assert tv.same_padding(n, k, stride) == pads
    rng = np.random.default_rng(n * k + stride)
    x = rng.standard_normal((2, n, n, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride),
                                        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")) + b
    conv = tv.Conv(3, 5, k, stride, torch.Generator().manual_seed(0), "cpu")
    convert.vision_params_from_jax(tv.VisionModel("c", ["c"], [conv], 0, (n, n, 3), 5),
                                   [{"w": w, "b": b}])
    with torch.no_grad():
        got = conv(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (2, -(-n // stride), -(-n // stride), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("n,k,stride,out", [(56, 3, 2, 27), (112, 3, 2, 55), (224, 2, 2, 112),
                                            (13, 3, 2, 6)])
def test_maxpool_is_valid(n, k, stride, out):
    """The window's own shape, not the reference init's ``n // stride``:
    AlexNet's pool1 is 27 and ResNet's 55."""
    x = np.random.default_rng(n).standard_normal((2, n, n, 4)).astype(np.float32)
    _, apply = jv._maxpool(k, stride)
    want = np.asarray(apply({}, jnp.asarray(x)))
    got = tv.MaxPool(k, stride)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, out, out, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,size", [(7, 1), (6, 6), (7, 7), (13, 6), (14, 7)])
def test_avgpool_to_is_a_valid_window_of_n_over_size(n, size):
    x = np.random.default_rng(n).standard_normal((2, n, n, 4)).astype(np.float32)
    _, apply = jv._avgpool_to(size)
    want = np.asarray(apply({}, jnp.asarray(x)))
    got = tv.AvgPoolTo(size)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_flatten_and_patch_rows_are_nhwc_order():
    x = np.arange(2 * 32 * 32 * 3, dtype=np.float32).reshape(2, 32, 32, 3)
    assert np.array_equal(tv.Flatten()(torch.from_numpy(x)).numpy(), x.reshape(2, -1))
    jvm, params, tvm = _pair("transformer", d=8, n_layers=0, heads=2, patch=16)
    with torch.no_grad():
        got = tvm.apply_range(torch.from_numpy(_images(2, hw=224)), 0, 1).numpy()
    want = np.asarray(jvm.apply_range(params, jnp.asarray(_images(2, hw=224)), 0, 1))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_vit_block_numerics_are_the_reference_choices():
    """GELU's tanh form, population variance with eps 1e-5, 1/sqrt(hd)
    attention with no mask, the head's token mean with no bias: a block of
    inputs far from zero, where each alternative moves the output."""
    jvm, params, tvm = _pair("transformer", d=64, n_layers=1, heads=4)
    x = (np.random.default_rng(5).standard_normal((2, 196, 64)) * 3 + 1).astype(np.float32)
    want = np.asarray(jvm.apply_range(params, jnp.asarray(x), 1, 3))
    with torch.no_grad():
        got = tvm.apply_range(torch.from_numpy(x), 1, 3).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert list(dict(tvm.layers[2].named_parameters())) == ["w"]


@pytest.mark.parametrize("name", ["alexnet", "resnet18", "vgg11", "transformer"])
def test_weight_round_trip_is_exact(name):
    jvm, params, tvm = _pair(name)
    if name == "resnet18":          # and the reference's own init
        params = jvm.init(jax.random.PRNGKey(1))
        convert.vision_params_from_jax(tvm, params)
    back = convert.vision_params_to_jax(tvm)
    assert len(back) == len(params)
    for i, (p, q) in enumerate(zip(params, back)):
        assert jax.tree.structure(p) == jax.tree.structure(q), jvm.layer_names[i]
        for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(q)):
            assert a.shape == b.shape and b.dtype == np.float32
            assert np.array_equal(np.asarray(a), b)
    # BatchNorm's statistics are buffers, not parameters.
    if name == "resnet18":
        assert {k for k, _ in tvm.layers[1].named_buffers()} == {"mean", "var"}


def test_init_follows_the_reference_distributions():
    vm = tv.tiny_transformer_encoder(device="cpu", generator=torch.Generator().manual_seed(3))
    pe = vm.layers[0]
    assert abs(float(pe.w.detach().std()) - 0.02) < 1e-3
    assert abs(float(pe.pos.detach().std()) - 0.02) < 2e-3
    blk = vm.layers[1]
    assert abs(float(blk.w2.detach().std()) - 1 / np.sqrt(4 * 384)) < 1e-3
    assert torch.equal(blk.ln1s, torch.ones(384))
    a = tv.alexnet(device="cpu")
    assert abs(float(a.layers[0].w.detach().std()) - 1 / np.sqrt(11 * 11 * 3)) < 2e-3
    assert torch.equal(tv.alexnet(device="cpu").layers[0].w, a.layers[0].w)  # seed 0
    m = tv.vgg11(device="meta")
    assert m.layers[0].w.device.type == "meta"


# ---------------------------------------------------------------------------
# The COS executor, registered with the reference's cluster
# ---------------------------------------------------------------------------
def _cluster(x, executor, object_size):
    return (HapiCluster(seed=0)
            .with_servers(2, n_accelerators=1)
            .with_routing(LeastLoadedRouting())
            .with_dataset("live", {"x": x}, object_size=object_size)
            .with_executor("alexnet", executor))


def _jax_executor(jvm, params, compress):
    def run(payload, split, cos_batch):
        x = jnp.asarray(payload["x"])
        outs = [jvm.apply_range(params, x[i:i + cos_batch], 0, split)
                for i in range(0, len(x), cos_batch)]
        if compress:
            qs = [jref.quantize_int8(a) for a in outs]
            return (np.concatenate([np.asarray(q) for q, _ in qs]),
                    np.concatenate([np.asarray(s) for _, s in qs]))
        return np.concatenate([np.asarray(a) for a in outs])
    return run


@pytest.mark.parametrize("compress", [False, True])
def test_executor_in_the_reference_cluster_matches_jax(compress):
    jvm, params, tvm = _pair("alexnet", num_classes=10)
    x = _images(16, seed=3)
    split = 3                       # Alg. 1's split under compress_transfer: (27, 27, 64)
    hapi = JHapi(compress_transfer=compress)
    got, want = {}, {}
    for out, fn in ((got, tts.make_vision_executor(tvm, compress=compress, device="cpu")),
                    (want, _jax_executor(jvm, params, compress))):
        c = _cluster(x, fn, 8)
        c.submit_burst("live", "alexnet", tenant=0, split=split, jitter=0.0, n_classes=10,
                       hapi=hapi)
        for r in c.drain():
            out[r.object_name] = r
    assert sorted(got) == sorted(want) and len(got) == 2
    for name, r in got.items():
        w = want[name]
        if not compress:
            assert r.acts.dtype == np.float32 and r.acts.shape == (8, 27, 27, 64)
            np.testing.assert_allclose(r.acts, w.acts, atol=ATOL, rtol=0)
            assert r.act_bytes == w.act_bytes
            continue
        (q, s), (qj, sj) = r.acts, w.acts
        assert q.dtype == np.int8 and s.dtype == np.float32
        assert q.shape == (8, 27, 27, 64) and s.shape == (8, 27, 27, 1)   # tile gcd(64, 128)
        assert np.abs(q.astype(np.int32) - qj.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(s, sj, rtol=1e-4, atol=0)
        deq = tref.dequantize_int8(torch.from_numpy(q), torch.from_numpy(s), torch.float32)
        deqj = tref.dequantize_int8(torch.from_numpy(qj), torch.from_numpy(sj), torch.float32)
        # One code step of the largest scale, plus the float32 acts' difference.
        np.testing.assert_allclose(deq.numpy(), deqj.numpy(), atol=float(sj.max()) + ATOL,
                                   rtol=0)
        rows = 8 * 27 * 27
        assert r.act_bytes == w.act_bytes == rows * 64 + rows * 1 * 4   # the measured wire


@pytest.mark.parametrize("compress", [False, True])
def test_executor_does_not_depend_on_the_cos_batch(compress):
    _, _, tvm = _pair("alexnet", num_classes=10)
    fn = tts.make_vision_executor(tvm, compress=compress, device="cpu")
    x = _images(6, seed=4)
    outs = [fn({"x": x}, 9, b) for b in (1, 4, 6, 200)]
    for o in outs[1:]:
        for a, b in zip(jax.tree.leaves(outs[0]), jax.tree.leaves(o)):
            if a.dtype == np.int8:
                assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)


def test_executor_quantizes_with_the_ops_kernel_and_counts_no_cpu_launch():
    _, _, tvm = _pair("transformer", d=64, n_layers=2, heads=2)
    fn = tts.make_vision_executor(tvm, compress=True, device="cpu")
    x = _images(3, seed=6)
    tops.reset_launch_counts()
    q, s = fn({"x": x}, 3, 2)
    assert q.shape == (3, 196, 64) and s.shape == (3, 196, 1)
    with torch.no_grad():
        acts = tvm.apply_range(torch.from_numpy(x), 0, 3)
    qe, se = tref.quantize_int8(acts)
    assert np.array_equal(q, qe.numpy()) and np.array_equal(s, se.numpy())
    assert sum(tops.launch_counts().values()) == 0    # the plain versions on the CPU


def test_executor_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present; tests/test_torch_cuda.py runs the executor there")
    _, _, tvm = _pair("transformer", d=64, n_layers=2, heads=2)
    fn = tts.make_vision_executor(tvm, compress=False)
    with pytest.raises((AssertionError, RuntimeError)):
        fn({"x": _images(1)}, 1, 1)


def test_vision_modules_import_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch.models.vision, repro_torch.convert, repro_torch.core.profiler\n"
        "import repro_torch.core.cost_model, repro_torch.core.splitter\n"
        "import repro_torch.core.tier_split\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(ROOT), timeout=120)
    assert res.returncode == 0, res.stderr
