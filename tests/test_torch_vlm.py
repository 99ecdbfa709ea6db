"""The port's vlm family (llava-next-mistral-7b) against the JAX package's, on the CPU.

The LLaVA stub frontend: ``n_patches`` patch embeddings are prepended to the
token embeddings. Weights are the JAX smoke model's (f32, 2 blocks, 8
patches), carried across by ``convert.params_from_jax``; tokens and patches
are made with numpy from a seed and go through both packages. Tolerances
are those of ``test_torch_models.py`` and ``test_torch_serving.py``.

The reference's serving refill writes the text alone, at positions
``n_patches + t`` of an empty cache, so the patches' cache rows stay zero
and decode attends over them (ROADMAP Queue 3): the teacher-forced logits
are held to the reference's teacher-forced logits, not to the prefill's.
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
from repro.configs import get_config as j_get_config
from repro.core import tier_split as jts
from repro.core.splitter import SplitDecision as JDecision
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.models.api import build_model as j_build_model
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.config import HapiConfig, ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import tier_split as tts
from repro_torch.core.splitter import SplitDecision
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT
from repro_torch.models.api import build_model
from repro_torch.train.steps import build_decode_step, build_prefill_step

ARCH = "llava-next-mistral-7b"
TOL = dict(atol=2e-4, rtol=2e-4)
BF16_ULP = dict(atol=1e-2, rtol=1e-2)
FLIP_TOL = dict(atol=5e-3, rtol=5e-3)


def _port():
    cfg, jmodel, jparams = smoke_model(ARCH)
    m = build_model(get_smoke_config(ARCH), device="cpu",
                    generator=torch.Generator().manual_seed(0))
    m.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jparams)))
    return cfg, jmodel, jparams, m


def _batch(cfg, b, text, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, text), np.int32)
    patches = rng.standard_normal((b, cfg.n_patches, cfg.d_model)).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks),
          "patches": jnp.asarray(patches)}
    tb = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(toks).long(),
          "patches": torch.from_numpy(patches)}
    return jb, tb


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("smoke", [True, False])
def test_build_model_gives_the_reference_shapes(smoke):
    """The published config too (on the meta device): every parameter has
    the shape of its leaf in the JAX tree, less the stacked block axis."""
    cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    m = build_model(cfg, device="cpu" if smoke else "meta", generator=torch.Generator())
    assert isinstance(m, TT.LM) and len(m.blocks) == cfg.n_blocks
    jcfg = smoke_model(ARCH)[0] if smoke else j_get_config(ARCH)
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [p.key for p in path]
        want[".".join(keys)] = tuple(leaf.shape[1:] if keys[0] == "blocks" else leaf.shape)
    got = {}
    for name, p in m.named_parameters():
        parts = name.split(".")
        got[".".join(parts[:1] + parts[2:] if parts[0] == "blocks" else parts)] = tuple(p.shape)
    assert got == want


@pytest.mark.parametrize("with_patches", [True, False])
def test_embed_prepends_patches_before_the_scale(with_patches):
    cfg, _, jparams, m = _port()
    jb, tb = _batch(cfg, 2, 12, seed=1)
    got = TT._embed_tokens(m.embed, tb["tokens"], m.cfg,
                           tb["patches"] if with_patches else None)
    exp = JT._embed_tokens(jparams, jb["tokens"], cfg, jb["patches"] if with_patches else None)
    assert got.shape == exp.shape == (2, 12 + with_patches * cfg.n_patches, cfg.d_model)
    np.testing.assert_allclose(_f32(got), _f32(exp), atol=1e-6, rtol=1e-6)
    if with_patches:
        np.testing.assert_allclose(_f32(got[:, :cfg.n_patches]),
                                   _f32(tb["patches"]) * cfg.d_model ** 0.5, rtol=1e-6)


@pytest.mark.parametrize("text", [24, 120])
def test_forward_and_loss_match_jax(text):
    cfg, jmodel, jparams, m = _port()
    jb, tb = _batch(cfg, 2, text, seed=2)
    with torch.no_grad():
        logits = m(tb)
        loss = float(m.loss(tb))
    exp = jax.jit(jmodel.forward)(jparams, jb)
    assert logits.shape == exp.shape == (2, cfg.n_patches + text, cfg.padded_vocab)
    np.testing.assert_allclose(_f32(logits), _f32(exp), **TOL)
    assert loss == pytest.approx(float(jax.jit(jmodel.loss)(jparams, jb)), abs=1e-4)
    # The loss reads the text positions only.
    want = TT.cross_entropy(logits[:, cfg.n_patches:-1], tb["labels"][:, 1:])
    assert loss == pytest.approx(float(want), abs=1e-6)


def test_forward_prefix_and_loss_suffix_every_split_match_jax():
    cfg, jmodel, jparams, m = _port()
    jb, tb = _batch(cfg, 2, 24, seed=3)
    with torch.no_grad():
        ref = float(m.loss(tb))
    for split in range(1, cfg.n_blocks):
        jfrozen, jtrain = jmodel.split_params(jparams, split)
        frozen, trainable = m.split_params(split)
        with torch.no_grad():
            acts = frozen(tb)
            loss = float(trainable.loss(acts, tb))
        jacts = jmodel.forward_prefix(jfrozen, jb, split)
        assert acts.shape == (2, cfg.n_patches + 24, cfg.d_model)
        np.testing.assert_allclose(_f32(acts), _f32(jacts), **TOL)
        assert loss == pytest.approx(float(jmodel.loss_suffix(jtrain, jacts, jb, split)),
                                     abs=1e-4)
        assert loss == pytest.approx(ref, abs=1e-5)


def test_convert_round_trip():
    _, _, jparams, m = _port()
    tree = jax.tree.map(np.asarray, jparams)
    back = convert.params_to_jax(m.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    sd = convert.params_from_jax(back)
    for k, v in m.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_train_state_from_jax():
    cfg, jmodel, _ = smoke_model(ARCH)
    jrc = JRun(model=cfg, shape=JShape("t", "train", 32, 4), train=JTrain())
    jplan = jts.TierPlan(1, 4, False, JDecision(1, 0, 0, [], "t"))
    jstate = jsteps.init_train_state(jmodel, jrc, jplan, jax.random.PRNGKey(0))
    np_state = jax.tree.map(np.asarray, tuple(jstate))
    state = convert.train_state_from_jax(np_state, get_smoke_config(ARCH))
    assert len(state.frozen.blocks) == 1 and len(state.trainable.blocks) == cfg.n_blocks - 1
    jb, tb = _batch(cfg, 2, 24, seed=4)
    with torch.no_grad():
        loss = float(state.trainable.loss(state.frozen(tb), tb))
    jacts = jmodel.forward_prefix(jstate.frozen, jb, 1)
    assert loss == pytest.approx(float(jmodel.loss_suffix(jstate.trainable, jacts, jb, 1)),
                                 abs=1e-4)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("cos_batch", [2, 4])
def test_extract_tune_matches_jax(cos_batch, compress):
    cfg, jmodel, jparams, m = _port()
    jb, tb = _batch(cfg, 4, 24, seed=cos_batch)
    plan = tts.TierPlan(1, cos_batch, compress, SplitDecision(1, 0, 0, [], "t"))
    jplan = jts.TierPlan(1, cos_batch, compress, JDecision(1, 0, 0, [], "t"))
    frozen, trainable = m.split_params(1)
    acts = tts.make_extract_fn(plan)(frozen, tb)
    with torch.no_grad():
        loss = float(tts.make_tune_loss_fn(plan)(trainable, acts, tb))
    jfrozen, jtrain = jmodel.split_params(jparams, 1)
    jacts = jts.make_extract_fn(jmodel, jplan)(jfrozen, jb)
    jloss = float(jts.make_tune_loss_fn(jmodel, jplan)(jtrain, jacts, jb))
    assert loss == pytest.approx(jloss, abs=1e-4)
    assert tts.wire_bytes(acts) == jts.wire_bytes(jplan, jacts)


def test_slice_plan_and_wire_bytes():
    """The card's llava pushdown: 4 x (576 patches + 3,520 tokens) give
    Alg. 1 no candidate (the token input is smaller than every boundary), so
    the split is the freeze index 24, at COS batch 2, as the JAX package
    plans it, with 67,108,864 + 2,097,152 wire bytes."""
    hapi = HapiConfig(compress_transfer=True, cos_batch=2, cos_batch_min=1)
    plan = tts.plan_tiers(get_config(ARCH), ShapeConfig("slice", "train", 4096, 4), hapi)
    exp = jts.plan_tiers(j_get_config(ARCH), JShape("slice", "train", 4096, 4),
                         jts.HapiConfig(compress_transfer=True, cos_batch=2, cos_batch_min=1,
                                        cos_hbm_budget=80e9))
    assert (plan.split, plan.cos_batch, plan.compress) == (exp.split, exp.cos_batch, True)
    assert (plan.split, plan.cos_batch) == (24, 2) == (get_config(ARCH).freeze_index, 2)
    acts = (torch.empty(4, 4096, 4096, dtype=torch.int8, device="meta"),
            torch.empty(4, 4096, 32, dtype=torch.float32, device="meta"))
    assert tts.wire_bytes(acts) == 67_108_864 + 2_097_152 == 69_206_016
    assert plan.decision.wire_bytes_per_iter == exp.decision.wire_bytes_per_iter == 69_206_016


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def test_prefill_logits_and_cache_match_jax():
    cfg, jmodel, jparams, m = _port()
    jb, tb = _batch(cfg, 2, 24, seed=5)
    logits, caches = build_prefill_step(m)(tb)
    exp, jcaches = jax.jit(jmodel.prefill)(jparams, jb)
    assert logits.shape == (2, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_f32(logits), _f32(exp), **TOL)
    assert len(caches) == cfg.n_blocks
    for i, c in enumerate(caches):
        for name in ("k", "v"):
            got = getattr(c["sub0"], name)
            assert got.shape == (2, cfg.n_patches + 24, cfg.n_kv_heads, cfg.hdim)
            np.testing.assert_allclose(_f32(got), _f32(getattr(jcaches["sub0"], name)[i]),
                                       **BF16_ULP)


def test_teacher_forced_decode_steps_match_jax():
    """serve()'s refill: the text one token at a time at positions
    n_patches + t of an empty cache, each step's logits and the caches
    against the JAX decode_step's."""
    cfg, jmodel, jparams, m = _port()
    text, extra = 20, 4
    smax = cfg.n_patches + text + extra
    jb, tb = _batch(cfg, 2, text, seed=6)
    jstep, tstep = jax.jit(jmodel.decode_step), build_decode_step(m)
    jcache, cache = jmodel.init_cache(2, smax), m.init_cache(2, smax)
    for t in range(text):
        pos = cfg.n_patches + t
        exp, jcache = jstep(jparams, jcache, jb["tokens"][:, t:t + 1], jnp.int32(pos))
        got, cache = tstep(cache, tb["tokens"][:, t:t + 1], pos)
        np.testing.assert_allclose(_f32(got), _f32(exp), err_msg=f"step {t}", **FLIP_TOL)
    for i, c in enumerate(cache):
        assert not c["sub0"].k[:, :cfg.n_patches].any()
        np.testing.assert_allclose(_f32(c["sub0"].k), _f32(jcache["sub0"].k[i]), **BF16_ULP)


@pytest.mark.parametrize("prompt_len,new_tokens", [(16, 8), (40, 4)])
def test_generate_tokens_equal_the_reference_serve(prompt_len, new_tokens):
    """The reference's serve() on the JAX smoke model (seed 0: the weights
    ``smoke_model`` holds) against the port's generate on the same weights,
    tokens and patches: the same greedy tokens."""
    cfg, _, _, m = _port()
    exp = jserve.serve(ARCH, batch=2, prompt_len=prompt_len, new_tokens=new_tokens, seed=0)
    key = jax.random.PRNGKey(0)
    toks = np.array(jax.random.randint(key, (2, prompt_len), 0, cfg.vocab_size))
    patches = np.array(jax.random.normal(key, (2, cfg.n_patches, cfg.d_model)), np.float32)
    out = tserve.generate(m, torch.from_numpy(toks).long(), new_tokens,
                          patches=torch.from_numpy(patches))
    assert out["tokens"].shape == (2, new_tokens + 1)
    np.testing.assert_array_equal(out["tokens"], np.asarray(exp["tokens"]))


def test_serve_on_cpu_shapes_and_determinism():
    kw = dict(batch=2, prompt_len=16, new_tokens=4, seed=5, device="cpu")
    a, b, c = tserve.serve(ARCH, **kw), tserve.serve(ARCH, **kw), tserve.serve(ARCH, **{
        **kw, "seed": 6})
    cfg = get_smoke_config(ARCH)
    assert a["tokens"].shape == (2, 5) and a["prompt"].shape == (2, 16)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["prefill_logits"].shape == a["teacher_logits"].shape == (2, 1, cfg.padded_vocab)
    assert a["tok_per_s"] > 0 and a["prefill_ms"] > 0 and a["teacher_ms"] > 0
