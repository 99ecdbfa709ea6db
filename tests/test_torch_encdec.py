"""The port's encoder-decoder (whisper-small) against the JAX package's, on the CPU.

Weights are the JAX smoke model's (f32, 2 + 2 layers, 4 heads of 16), carried
across by ``convert.params_from_jax``; frames and tokens are made with numpy
from a seed and go through both packages. The encoder runs at 32 frames,
where the reference's attention takes its direct path, and at 1,536, where it
takes ``chunked_attention`` (whose 512-row blocks refuse whisper's own 1,500
frames: ROADMAP Queue 3). Tolerances are those of ``test_torch_models.py``
and ``test_torch_serving.py``: f32 logits to ``TOL``; bf16 caches to one
bf16 rounding (``BF16_ULP``); decode steps to ``FLIP_TOL``, since the decode
kernel's plain version rounds P and its output to bf16 where the reference's
self-attention rounds P to the cache's dtype and its cross-attention keeps
f32 (about 1e-3 in these models; a wrong mask, position or cache moves the
logits by more than 1e-1).
"""
import dataclasses

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
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models.api import build_model as j_build_model
from repro.train import steps as jsteps
from repro_torch import convert
from repro_torch.config import HapiConfig, ShapeConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import tier_split as tts
from repro_torch.core.splitter import SplitDecision
from repro_torch.kernels import ref
from repro_torch.launch import serve as tserve
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models.api import build_model
from repro_torch.train.steps import build_decode_step, build_prefill_step

ARCH = "whisper-small"
TOL = dict(atol=2e-4, rtol=2e-4)
BF16_ULP = dict(atol=1e-2, rtol=1e-2)
FLIP_TOL = dict(atol=5e-3, rtol=5e-3)
FRAMES = [32, 1536]
# The card's relative L2 bound on attention outputs (chip_smoke.py's).
ATTN_REL_TOL = 1e-2


def _load(jmodel, jparams, cfg):
    m = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    m.load_state_dict(convert.params_from_jax(jax.tree.map(np.asarray, jparams)))
    return m


def _port():
    cfg, jmodel, jparams = smoke_model(ARCH)
    return cfg, jmodel, jparams, _load(jmodel, jparams, get_smoke_config(ARCH))


def _batch(cfg, b, frames, seed):
    rng = np.random.default_rng(seed)
    f = rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (b, cfg.dec_seq), np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, cfg.dec_seq), np.int32)
    jb = {"frames": jnp.asarray(f), "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"frames": torch.from_numpy(f), "tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    return jb, tb


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(a, np.float32)


def _rel(got, want) -> float:
    """Relative L2 of ``got`` against ``want``, in f64."""
    got, want = _f32(got).astype(np.float64), _f32(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jax_block(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 8, 64)) * 3 + 1).astype(np.float32)
    scale, bias = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(
        np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    got = TL.layernorm(torch.from_numpy(scale), torch.from_numpy(bias),
                       torch.from_numpy(x).to(td), 1e-5)
    exp = JL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                       jnp.asarray(x).astype(jd), 1e-5)
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_f32(got), _f32(exp), atol=tol, rtol=tol)
    mod = TL.LayerNorm(64, 1e-5, dtype=torch.float32, device="cpu")
    assert torch.equal(mod.scale, torch.ones(64)) and torch.equal(mod.bias, torch.zeros(64))


def test_cross_kv_and_cross_attention_match_jax():
    cfg, _, jparams, m = _port()
    jp = _jax_block(jparams["dec_blocks"]["cross_attn"], 1)
    p = m.dec_blocks[1].cross_attn
    rng = np.random.default_rng(1)
    enc = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    with torch.no_grad():
        kv = TE.cross_kv(p, torch.from_numpy(enc), m.cfg)
        got = TE.cross_attention_apply(p, torch.from_numpy(x), kv, m.cfg)
    jkv = JE.cross_kv(jp, jnp.asarray(enc), cfg)
    exp = JE.cross_attention_apply(jp, jnp.asarray(x), jkv, cfg)
    for a, b in zip(kv, jkv):
        np.testing.assert_allclose(_f32(a), _f32(b), **TOL)
    np.testing.assert_allclose(_f32(got), _f32(exp), **TOL)


@pytest.mark.parametrize("frames", [7, 1500])
def test_cross_attention_decode_matches_the_reference_einsum(frames):
    """One token over every cached bf16 frame: the decode kernel's plain
    version against the reference's einsum, to one bf16 rounding of P and
    of the output, by max abs and by relative L2 (at 1,500 frames the
    outputs are small beside the max-abs bound)."""
    cfg, _, jparams, m = _port()
    jp = _jax_block(jparams["dec_blocks"]["cross_attn"], 0)
    rng = np.random.default_rng(2)
    k = rng.standard_normal((2, frames, cfg.n_kv_heads, cfg.hdim)).astype(np.float32)
    v = rng.standard_normal((2, frames, cfg.n_kv_heads, cfg.hdim)).astype(np.float32)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    cross = TL.KVCache(torch.from_numpy(k).to(torch.bfloat16), torch.from_numpy(v).to(torch.bfloat16))
    with torch.no_grad():
        got = TE.cross_attention_decode(m.dec_blocks[0].cross_attn, torch.from_numpy(x), cross,
                                        m.cfg)
    exp = JE.cross_attention_apply(jp, jnp.asarray(x), (jnp.asarray(k).astype(jnp.bfloat16),
                                                        jnp.asarray(v).astype(jnp.bfloat16)),
                                   cfg)
    assert got.shape == (2, 1, cfg.d_model)
    np.testing.assert_allclose(_f32(got), _f32(exp), atol=2e-2, rtol=2e-2)
    assert _rel(got, exp) <= ATTN_REL_TOL


@pytest.mark.parametrize("kernel", ["flash", "decode"])
def test_relative_l2_bound_catches_a_dropped_tail_tile(kernel):
    """At whisper's 1,500 frames (12 heads of 64, bf16 inputs, scores about
    N(0, 1)) the card's checks hold flash and decode to their plain versions
    by relative L2 (ATTN_REL_TOL, as ``chip_smoke.py`` and
    ``tests/test_torch_cuda.py`` do). The plain version's own bf16 rounding,
    against its f32 result, lies well inside the bound; the output without
    the 92 keys past the last full tile of 128 lies far outside it."""
    rng = np.random.default_rng(11)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)

    kept = 1500 // 128 * 128
    k, v = bf16((1, 1500, 12, 64)), bf16((1, 1500, 12, 64))
    if kernel == "flash":
        q = bf16((1, 1500, 12, 64))
        full = ref.flash_attention(q, k, v, causal=False)
        exact = ref.flash_attention(q.float(), k.float(), v.float(), causal=False)
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k[:, :kept].float()) / 8.0
        no_tail = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1),
                               v[:, :kept].float()).to(torch.bfloat16)
    else:
        q = bf16((1, 12, 64))
        full = ref.decode_attention(q, k, v, 1500)
        exact = ref.decode_attention(q.float(), k.float(), v.float(), 1500)
        no_tail = ref.decode_attention(q, k, v, kept)
    assert _rel(full, exact) <= ATTN_REL_TOL / 2
    assert _rel(no_tail, full) >= 10 * ATTN_REL_TOL


# ---------------------------------------------------------------------------
# The model and its split
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smoke", [True, False])
def test_build_model_gives_the_reference_shapes(smoke):
    """The published config too (on the meta device): every parameter has
    the shape of its leaf in the JAX tree, less the stacked block axis."""
    cfg = get_smoke_config(ARCH) if smoke else get_config(ARCH)
    m = build_model(cfg, device="cpu" if smoke else "meta", generator=torch.Generator())
    assert isinstance(m, TE.EncDec)
    assert (len(m.enc_blocks), len(m.dec_blocks)) == (cfg.n_enc_layers, cfg.n_dec_layers)
    jcfg = smoke_model(ARCH)[0] if smoke else j_get_config(ARCH)
    shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
        keys = [p.key for p in path]
        shape = leaf.shape[1:] if keys[0] in ("enc_blocks", "dec_blocks") else leaf.shape
        want[".".join(keys)] = tuple(shape)
    got = {}
    for name, p in m.named_parameters():
        parts = name.split(".")
        if parts[0] in ("enc_blocks", "dec_blocks"):
            parts = parts[:1] + parts[2:]
        got[".".join(parts)] = tuple(p.shape)
    assert got == want
    dt = torch.float32 if smoke else torch.bfloat16
    assert all(p.dtype == dt for p in m.parameters())


@pytest.mark.parametrize("frames", FRAMES)
def test_forward_and_loss_match_jax(frames):
    cfg, jmodel, jparams, m = _port()
    jb, tb = _batch(cfg, 2, frames, seed=3)
    with torch.no_grad():
        logits = m(tb)
        loss = float(m.loss(tb))
    exp = jax.jit(jmodel.forward)(jparams, jb)
    assert logits.dtype == torch.float32 and logits.shape == exp.shape
    np.testing.assert_allclose(_f32(logits), _f32(exp), **TOL)
    assert loss == pytest.approx(float(jax.jit(jmodel.loss)(jparams, jb)), abs=1e-4)


@pytest.mark.parametrize("frames", FRAMES)
def test_forward_prefix_and_loss_suffix_every_split_match_jax(frames):
    cfg, jmodel, jparams, m = _port()
    jb, tb = _batch(cfg, 2, frames, seed=4)
    for split in range(cfg.n_blocks + 1):
        jfrozen, jtrain = jmodel.split_params(jparams, split)
        frozen, trainable = m.split_params(split)
        assert len(frozen.enc_blocks) == split
        with torch.no_grad():
            acts = frozen(tb)
            loss = float(trainable.loss(acts, tb))
        jacts = jmodel.forward_prefix(jfrozen, jb, split)
        np.testing.assert_allclose(_f32(acts), _f32(jacts), **TOL)
        jloss = float(jmodel.loss_suffix(jtrain, jacts, jb, split))
        assert loss == pytest.approx(jloss, abs=1e-4), split


def test_split_consistency_and_merge():
    """loss == loss_suffix(forward_prefix) at every boundary; the tiers share
    no parameter, and merge_params gives back the model's modules."""
    cfg, _, _, m = _port()
    _, tb = _batch(cfg, 2, 32, seed=5)
    with torch.no_grad():
        ref = float(m.loss(tb))
        for split in range(cfg.n_blocks + 1):
            frozen, trainable = m.split_params(split)
            assert not ({id(p) for p in frozen.parameters()}
                        & {id(p) for p in trainable.parameters()})
            assert float(trainable.loss(frozen(tb), tb)) == pytest.approx(ref, abs=1e-5)
            merged = TE.merge_params(frozen, trainable)
            assert [id(p) for p in merged.parameters()] == [id(p) for p in m.parameters()]


def test_convert_round_trip():
    _, _, jparams, m = _port()
    tree = jax.tree.map(np.asarray, jparams)
    back = convert.params_to_jax(m.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    sd = convert.params_from_jax(back)
    assert sd.keys() == m.state_dict().keys()
    for k, v in m.state_dict().items():
        assert torch.equal(sd[k], v), k
    assert "enc_blocks.1.ln1.bias" in sd and "dec_blocks.0.cross_attn.wk" in sd


def test_train_state_from_jax():
    """An encoder-decoder train state, whose frozen tree is ``enc_blocks``:
    the split, the weights, the moments and the suffix's loss carry over."""
    cfg, jmodel, _ = smoke_model(ARCH)
    split = 1
    jrc = JRun(model=cfg, shape=JShape("t", "train", 32, 4), train=JTrain())
    jplan = jts.TierPlan(split, 4, False, JDecision(split, 0, 0, [], "t"))
    jstate = jsteps.init_train_state(jmodel, jrc, jplan, jax.random.PRNGKey(0))
    assert list(jstate.frozen) == ["enc_blocks"]
    np_state = jax.tree.map(np.asarray, tuple(jstate))
    state = convert.train_state_from_jax(np_state, get_smoke_config(ARCH))
    assert len(state.frozen.enc_blocks) == split
    assert len(state.trainable.enc_blocks) == cfg.n_enc_layers - split
    assert not any(p.requires_grad for p in state.frozen.parameters())
    frozen_t, trainable_t, (m_t, v_t, step) = convert.train_state_to_jax(state)
    for mine, theirs in ((frozen_t, np_state[0]), (trainable_t, np_state[1]),
                         (m_t, np_state[2][0]), (v_t, np_state[2][1])):
        assert jax.tree.structure(mine) == jax.tree.structure(theirs)
        for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
            np.testing.assert_array_equal(a, b)
    assert int(step) == int(np_state[2][2])
    jb, tb = _batch(cfg, 2, 32, seed=6)
    with torch.no_grad():
        loss = float(state.trainable.loss(state.frozen(tb), tb))
    jacts = jmodel.forward_prefix(jstate.frozen, jb, split)
    assert loss == pytest.approx(float(jmodel.loss_suffix(jstate.trainable, jacts, jb, split)),
                                 abs=1e-4)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("cos_batch", [2, 4])
def test_extract_tune_matches_jax(cos_batch, compress):
    cfg, jmodel, jparams, m = _port()
    jb, tb = _batch(cfg, 4, 32, seed=cos_batch)
    split = 1
    plan = tts.TierPlan(split, cos_batch, compress, SplitDecision(split, 0, 0, [], "t"))
    jplan = jts.TierPlan(split, cos_batch, compress, JDecision(split, 0, 0, [], "t"))
    frozen, trainable = m.split_params(split)
    acts = tts.make_extract_fn(plan)(frozen, tb)
    with torch.no_grad():
        loss = float(tts.make_tune_loss_fn(plan)(trainable, acts, tb))
    jfrozen, jtrain = jmodel.split_params(jparams, split)
    jacts = jts.make_extract_fn(jmodel, jplan)(jfrozen, jb)
    jloss = float(jts.make_tune_loss_fn(jmodel, jplan)(jtrain, jacts, jb))
    assert loss == pytest.approx(jloss, abs=1e-4)
    assert tts.wire_bytes(acts) == jts.wire_bytes(jplan, jacts)


def test_slice_plan_and_wire_bytes():
    """The card's whisper pushdown: 8 clips of 1,500 frames take Alg. 1's
    split 1 (the int8 boundary is smaller than the frames) at COS batch 4,
    as the JAX package plans it, with 9,216,000 + 288,000 wire bytes."""
    hapi = HapiConfig(compress_transfer=True, cos_batch=4, cos_batch_min=1)
    plan = tts.plan_tiers(get_config(ARCH), ShapeConfig("slice", "train", 1500, 8), hapi)
    exp = jts.plan_tiers(j_get_config(ARCH), JShape("slice", "train", 1500, 8),
                         jts.HapiConfig(compress_transfer=True, cos_batch=4, cos_batch_min=1,
                                        cos_hbm_budget=80e9))
    assert (plan.split, plan.cos_batch, plan.compress) == (exp.split, exp.cos_batch, True)
    assert (plan.split, plan.cos_batch) == (1, 4)
    acts = (torch.empty(8, 1500, 768, dtype=torch.int8, device="meta"),
            torch.empty(8, 1500, 6, dtype=torch.float32, device="meta"))
    assert tts.wire_bytes(acts) == 9_216_000 + 288_000 == 9_504_000
    assert plan.decision.wire_bytes_per_iter == exp.decision.wire_bytes_per_iter == 9_504_000


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def _compare_kv(got, want, n, what):
    assert len(got) == n
    for i, c in enumerate(got):
        for name in ("k", "v"):
            a = getattr(c, name)
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(_f32(a), _f32(getattr(want, name)[i]),
                                       err_msg=f"{what} {i} {name}", **BF16_ULP)


@pytest.mark.parametrize("frames", FRAMES)
def test_prefill_logits_and_caches_match_jax(frames):
    cfg, jmodel, jparams, m = _port()
    jb, tb = _batch(cfg, 2, frames, seed=7)
    smax = cfg.dec_seq + 5
    logits, cache = build_prefill_step(m)({**tb, "smax": smax})
    exp, jcache = jmodel.prefill(jparams, {**jb, "smax": smax})
    assert logits.shape == (2, 1, cfg.padded_vocab) and logits.dtype == torch.float32
    np.testing.assert_allclose(_f32(logits), _f32(exp), **TOL)
    assert cache["self"][0].k.shape == (2, smax, cfg.n_kv_heads, cfg.hdim)
    assert cache["cross"][0].k.shape == (2, min(frames, TE.CROSS_ATTN_FRAMES), cfg.n_kv_heads,
                                         cfg.hdim)
    _compare_kv(cache["self"], jcache["self"], cfg.n_dec_layers, "self")
    _compare_kv(cache["cross"], jcache["cross"], cfg.n_dec_layers, "cross")


@pytest.mark.parametrize("frames", FRAMES)
def test_teacher_forced_decode_steps_match_jax(frames):
    """From the prefill's cache, tokens fed one at a time from ``dec_seq``
    on: each step's logits, then the self caches."""
    cfg, jmodel, jparams, m = _port()
    jb, tb = _batch(cfg, 2, frames, seed=8)
    steps = 6
    smax = cfg.dec_seq + steps
    feed = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, steps), np.int32)
    _, cache = build_prefill_step(m)({**tb, "smax": smax})
    _, jcache = jmodel.prefill(jparams, {**jb, "smax": smax})
    jstep, tstep = jax.jit(jmodel.decode_step), build_decode_step(m)
    for t in range(steps):
        pos = cfg.dec_seq + t
        exp, jcache = jstep(jparams, jcache, jnp.asarray(feed[:, t:t + 1]), jnp.int32(pos))
        got, cache = tstep(cache, torch.from_numpy(feed[:, t:t + 1]).long(), pos)
        np.testing.assert_allclose(_f32(got), _f32(exp), err_msg=f"step {t}", **FLIP_TOL)
    _compare_kv(cache["self"], jcache["self"], cfg.n_dec_layers, "self")


def test_init_cache_shapes():
    cfg, jmodel, _, m = _port()
    cache = m.init_cache(3, 20)
    jcache = jmodel.init_cache(3, 20)
    for kind in ("self", "cross"):
        assert len(cache[kind]) == cfg.n_dec_layers
        assert tuple(cache[kind][0].k.shape) == jcache[kind].k.shape[1:]
        assert cache[kind][0].k.dtype == torch.bfloat16
        assert not cache[kind][0].k.any()


def _reference_loop(jmodel, jparams, frames, new_tokens):
    """The encdec branch of the reference's serve() loop
    (``repro/launch/serve.py`` lines 80-118) with its prefill run eagerly:
    jitted, as serve() runs it, the prefill traces ``smax`` and cannot pad
    the cache (ROADMAP Queue 3)."""
    cfg = jmodel.cfg
    b = frames.shape[0]
    batch_d = {"frames": jnp.asarray(frames), "tokens": jnp.ones((b, cfg.dec_seq), jnp.int32),
               "smax": cfg.dec_seq + new_tokens}
    start_pos = cfg.dec_seq
    logits, cache = jmodel.prefill(jparams, batch_d)
    step = jax.jit(jmodel.decode_step)
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    out = [tok]
    for i in range(new_tokens):
        logits, cache = step(jparams, cache, tok, jnp.int32(start_pos + i))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        out.append(tok)
    return np.concatenate([np.asarray(t) for t in out], axis=1)


@pytest.mark.parametrize("frames,new_tokens", [(32, 8), (1536, 4)])
def test_generate_tokens_equal_the_reference_loop(frames, new_tokens):
    """The reference's serving loop on the JAX smoke model against the
    port's generate on the same weights and the same frames (serve()'s, from
    seed 0): the same greedy tokens."""
    cfg, jmodel, jparams, m = _port()
    f = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, frames, cfg.d_model)),
                   np.float32)
    exp = _reference_loop(jmodel, jparams, f, new_tokens)
    out = tserve.generate(m, torch.ones((2, cfg.dec_seq), dtype=torch.long), new_tokens,
                          frames=torch.from_numpy(f))
    assert out["tokens"].shape == (2, new_tokens + 1)
    np.testing.assert_array_equal(out["tokens"], exp)
    assert out["teacher_logits"] is None and out["teacher_ms"] >= 0


def test_the_reference_serve_cannot_jit_the_encdec_prefill():
    """Why the loop above runs the reference's prefill eagerly: serve()
    jits it with ``smax`` in the batch, a tracer where ``jnp.pad`` needs an
    int. The port takes ``smax`` as a host int."""
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jserve.serve(ARCH, batch=1, prompt_len=8, new_tokens=1)


def test_padded_vocab_is_masked():
    """A vocabulary that leaves padded rows: the forward's logits equal the
    reference's (which masks them too); the prefill and decode step, which
    the reference leaves unmasked, agree on the real rows and mask the
    padded ones."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), vocab_size=500)
    jcfg = j_get_config(ARCH)
    jcfg = dataclasses.replace(jcfg, **{
        f: getattr(cfg, f) for f in jcfg.__dataclass_fields__ if f != "name"})
    jmodel = j_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(1))
    m = _load(jmodel, jparams, cfg)
    assert cfg.padded_vocab == 512
    jb, tb = _batch(cfg, 2, 32, seed=10)
    with torch.no_grad():
        np.testing.assert_allclose(_f32(m(tb)), _f32(jmodel.forward(jparams, jb)), **TOL)
    logits, cache = build_prefill_step(m)({**tb, "smax": cfg.dec_seq + 1})
    exp, jcache = jmodel.prefill(jparams, {**jb, "smax": cfg.dec_seq + 1})
    np.testing.assert_allclose(_f32(logits)[..., :500], _f32(exp)[..., :500], **TOL)
    assert (logits[..., 500:] == -1e30).all()
    tok = torch.argmax(logits[:, -1:], dim=-1)
    got, _ = build_decode_step(m)(cache, tok, cfg.dec_seq)
    exp, _ = jmodel.decode_step(jparams, jcache, jnp.asarray(tok.numpy()), jnp.int32(cfg.dec_seq))
    np.testing.assert_allclose(_f32(got)[..., :500], _f32(exp)[..., :500], **FLIP_TOL)
    assert (got[..., 500:] == -1e30).all()


def test_serve_on_cpu_shapes_and_determinism():
    kw = dict(batch=2, prompt_len=24, new_tokens=4, seed=5, device="cpu")
    a, b, c = tserve.serve(ARCH, **kw), tserve.serve(ARCH, **kw), tserve.serve(ARCH, **{
        **kw, "seed": 6})
    cfg = get_smoke_config(ARCH)
    assert a["tokens"].shape == (2, 5) and a["tokens"].dtype == np.int32
    np.testing.assert_array_equal(a["prompt"], np.ones((2, cfg.dec_seq), np.int32))
    assert ((0 <= a["tokens"]) & (a["tokens"] < cfg.vocab_size)).all()
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["prefill_logits"].shape == (2, 1, cfg.padded_vocab)
    assert a["tok_per_s"] > 0 and a["prefill_ms"] > 0


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2", "--prompt-len", "16",
                 "--tokens", "3"])
    out = capsys.readouterr().out
    assert "decoded (2, 4)" in out and "prefill" in out
