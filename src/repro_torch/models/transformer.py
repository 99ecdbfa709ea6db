"""Decoder LM of the dense, MoE, SSM, hybrid and VLM families, split at block
boundaries.

Counterpart of ``repro/models/transformer.py``:
  * The layer stack is a ``nn.ModuleList`` of blocks whose boundaries are
    the Hapi split candidates. dense, moe and ssm: block == one layer;
    gemma2: block == (local, global) pair; hybrid (jamba): block == one
    period of ``attn_period`` sublayers, attention at ``attn_pos`` and mamba
    elsewhere, a MoE FFN on every ``moe_every``-th sublayer and a SwiGLU MLP
    on the others (``block_plan``). Moonlight (moe with latent attention):
    MLA and DeepSeek-V3's dropless MoE, the first ``first_k_dense`` blocks
    with a dense SwiGLU instead; it trains and extracts, and does not serve.
  * ``LM.split_params(split)`` gives the two halves of the paper's tier
    split as modules that share the LM's parameters: ``Prefix`` runs the
    embedding and blocks [0, split) (``forward_prefix``), ``Suffix`` runs
    blocks [split, N) and the head (``forward_suffix``, ``loss_suffix``).
    ``merge_params`` joins them back into an ``LM``.
  * Logits are f32 and the cross entropy is taken in f32, as in the JAX
    package.
  * Serving: ``LM.prefill`` runs the prompt and returns the last position's
    logits with the decode cache, ``LM.decode_step`` runs one token at a
    host-int position against it, ``LM.init_cache`` makes an empty one. The
    cache is a list with one dict per block (``{"sub0": KVCache, ...}``; a
    hybrid block holds a ``KVCache`` for its attention sublayer and a
    ``MambaCache`` for each mamba one), not a stack over a block axis; K and
    V are cached in bf16, unrepeated, and written in place by
    ``decode_step``.

  * vlm (llava): the stub frontend's patch embeddings ``batch["patches"]``
    (B, n_patches, D) are prepended to the token embeddings before the
    sqrt(d_model) scale, positions cover n_patches + S, and the loss reads
    the logits from position n_patches on. ``prefill`` and ``Prefix`` take
    the patches; ``decode_step`` embeds its token alone.

The encoder-decoder family is ``models/encdec.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.config import ModelConfig
from repro_torch.distributed.autoshard import (
    block_weights, constrain_act, constrain_logits, data_placements, gather_fsdp,
    mesh_model_size, with_model)
from repro_torch.kernels.head import CARD, HeadProductFn, head_route
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.module import current_remat, dtype_of, embed_init
from repro_torch.obs.program import METRICS, TRACER


# ---------------------------------------------------------------------------
# Block plans — static description of the sublayers inside one block
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SubLayer:
    mixer: str                 # "attn" | "attn_local" | "mla" | "mamba"
    ffn: str                   # "mlp" | "moe" | "none"
    d_ff: int = 0              # the MLP's width where it is not cfg.d_ff


def block_plan(cfg: ModelConfig, index: int = 0) -> List[SubLayer]:
    """The sublayers of block ``index``: the same for every block but a MoE
    family's first ``first_k_dense``, whose FFN is a SwiGLU of
    ``d_ff_dense``."""
    if cfg.family == "moe" and cfg.is_mla:
        if cfg.dense_block(index):
            return [SubLayer("mla", "mlp", cfg.d_ff_dense)]
        return [SubLayer("mla", "moe")]
    if cfg.family in ("dense", "vlm"):
        if cfg.local_global_period:
            # gemma2: alternate sliding-window local and global attention.
            return [SubLayer("attn_local", "mlp"), SubLayer("attn", "mlp")]
        return [SubLayer("attn", "mlp")]
    if cfg.family == "moe":
        return [SubLayer("attn", "moe")]
    if cfg.family == "ssm":
        return [SubLayer("mamba", "none")]
    if cfg.family == "hybrid":
        subs = []
        for i in range(cfg.attn_period):
            mixer = "attn" if i == cfg.attn_pos else "mamba"
            ffn = "moe" if (cfg.moe_every and i % cfg.moe_every == 1) else "mlp"
            subs.append(SubLayer(mixer, ffn))
        return subs
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Sublayers and blocks
# ---------------------------------------------------------------------------
class Sublayer(nn.Module):
    """Pre-norm mixer (global or sliding-window attention, or mamba2), then a
    pre-norm FFN where the plan has one: a SwiGLU MLP or a MoE."""

    def __init__(self, cfg: ModelConfig, sub: SubLayer, *, device,
                 generator: torch.Generator):
        super().__init__()
        if sub.mixer not in ("attn", "attn_local", "mla", "mamba") or \
                sub.ffn not in ("mlp", "moe", "none"):
            raise ValueError(f"unknown sublayer {sub}")
        init = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        self.cfg = cfg
        self.is_mamba = sub.mixer == "mamba"
        self.is_mla = sub.mixer == "mla"
        self.ffn = sub.ffn
        self.window = cfg.sliding_window if sub.mixer == "attn_local" else None
        self.ln_mixer = L.RMSNorm(cfg.d_model, cfg.norm_eps, **init)
        if self.is_mamba:
            self.mamba = S.Mamba(cfg, device=device, generator=generator)
        elif self.is_mla:
            self.attn = L.MLA(cfg, device=device, generator=generator)
        else:
            self.attn = L.Attention(cfg, device=device, generator=generator)
        if self.ffn != "none":
            self.ln_ffn = L.RMSNorm(cfg.d_model, cfg.norm_eps, **init)
        if self.ffn == "mlp":
            self.mlp = L.MLP(cfg, device=device, generator=generator, d_ff=sub.d_ff)
        elif self.ffn == "moe" and cfg.router == "sigmoid_bias":
            self.moe = L.DeepSeekMoE(cfg, device=device, generator=generator)
        elif self.ffn == "moe":
            self.moe = L.MoE(cfg, device=device, generator=generator)

    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        if self.ffn == "mlp":
            return h + L.mlp_apply(self.mlp, self.ln_ffn(h))
        if self.ffn == "moe" and self.cfg.router == "sigmoid_bias":
            return h + L.deepseek_moe_apply(self.moe, self.ln_ffn(h), self.cfg)
        if self.ffn == "moe":
            return h + L.moe_apply(self.moe, self.ln_ffn(h), self.cfg)
        return h

    def _no_mla_cache(self):
        if self.is_mla:
            raise NotImplementedError(
                f"{self.cfg.name}: latent attention has no decode cache in the port yet "
                "(training and the pushdown run it; serving does not)")

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = self.ln_mixer(h)
        if self.is_mamba:
            y = S.ssm_apply(self.mamba, x, self.cfg)
        elif self.is_mla:
            y = L.mla_apply(self.attn, x, self.cfg, positions=positions)
        else:
            y = L.attention_apply(self.attn, x, self.cfg, window=self.window,
                                  positions=positions)
        return self._ffn(h + y)

    def prefill(self, h: torch.Tensor, positions: torch.Tensor):
        """Like forward, but also returns this sublayer's decode cache."""
        self._no_mla_cache()
        x = self.ln_mixer(h)
        if self.is_mamba:
            y, cache = S.ssm_prefill(self.mamba, x, self.cfg)
        else:
            y, cache = _attention_prefill(self.attn, x, self.cfg, window=self.window,
                                          positions=positions)
        return self._ffn(h + y), cache

    def decode(self, h: torch.Tensor, cache, pos: int):
        self._no_mla_cache()
        x = self.ln_mixer(h)
        if self.is_mamba:
            y, cache = S.ssm_decode(self.mamba, x, cache, self.cfg)
        else:
            y, cache = L.attention_decode(self.attn, x, cache, pos, self.cfg,
                                          window=self.window)
        return self._ffn(h + y), cache

    def init_cache(self, batch: int, smax: int):
        self._no_mla_cache()
        device = self.ln_mixer.scale.device
        if self.is_mamba:
            return S.ssm_init_cache(self.cfg, batch, device=device)
        shape = (batch, smax, self.cfg.n_kv_heads, self.cfg.hdim)
        return L.KVCache(k=torch.zeros(shape, dtype=torch.bfloat16, device=device),
                         v=torch.zeros(shape, dtype=torch.bfloat16, device=device))


def _attention_prefill(p: L.Attention, x: torch.Tensor, cfg: ModelConfig, *,
                       window: Optional[int], positions: torch.Tensor):
    """Attention that also emits the (unrepeated) KV cache in bf16: the K
    and V it attends over, so they are projected once."""
    q, k, v = L._project_qkv(p, x, cfg, positions)
    y = L.attend(p, q, k, v, cfg, window=window)
    return y, L.KVCache(k.to(torch.bfloat16), v.to(torch.bfloat16))


BlockCache = Dict[str, object]   # {"sub{j}": KVCache | MambaCache}


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator, index: int = 0):
        super().__init__()
        for i, sub in enumerate(block_plan(cfg, index)):
            self.add_module(f"sub{i}", Sublayer(cfg, sub, device=device, generator=generator))

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        for sub in self.children():
            h = sub(h, positions)
        return h

    def prefill(self, h: torch.Tensor, positions: torch.Tensor):
        caches: BlockCache = {}
        for name, sub in self.named_children():
            h, caches[name] = sub.prefill(h, positions)
        return h, caches

    def decode(self, h: torch.Tensor, cache: BlockCache, pos: int):
        new: BlockCache = {}
        for name, sub in self.named_children():
            h, new[name] = sub.decode(h, cache[name], pos)
        return h, new

    def init_cache(self, batch: int, smax: int) -> BlockCache:
        return {name: sub.init_cache(batch, smax) for name, sub in self.named_children()}


# ---------------------------------------------------------------------------
# Embedding, head, loss
# ---------------------------------------------------------------------------
def _embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig,
                  patches: Optional[torch.Tensor] = None) -> torch.Tensor:
    h = L.embed_lookup(embed, tokens).to(dtype_of(cfg.compute_dtype))
    if cfg.family == "vlm" and patches is not None:
        # LLaVA stub frontend: prepend pre-computed patch embeddings.
        h = torch.cat([patches.to(h.dtype), h], dim=1)
    root_d = torch.sqrt(torch.full((), float(cfg.d_model), dtype=torch.float32, device=h.device))
    return constrain_act(h * root_d.to(h.dtype))


def _head(final_norm: L.RMSNorm, w: torch.Tensor, h: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """f32 logits: products of the (compute-dtype) operands summed in f32.
    Plain bf16 CUDA operands take the tensor cores (``kernels.head``); the
    rest cast both operands to f32 (``head_route``)."""
    h = final_norm(h)
    w = gather_fsdp(w)
    route, tr, mx = head_route(h, w), TRACER, METRICS
    if tr.enabled:
        mx.inc("head_products_total", route=route)
    if route == "split_bf16":
        logits = HeadProductFn.apply(h.reshape(-1, h.shape[-1]), w, CARD)
        logits = logits.view(*h.shape[:-1], w.shape[0])
    else:
        logits = torch.matmul(h.to(torch.float32), w.to(h.dtype).to(torch.float32).t())
    logits = L._softcap(logits, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad_mask, -1e30)
    return constrain_logits(logits)


def _label_logprob(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return logp.gather(-1, labels[..., None].long())[..., 0]


class _VocabParallelLogprob(torch.autograd.Function):
    """Each label's log-probability from logits whose vocabulary is split
    over ``group`` (this rank holds columns [lo, lo + V_local)): the max,
    the sum of exponentials and the label's logit are all-reduced over the
    group; the backward is local, softmax minus the label's one-hot on this
    rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group):
        from torch.distributed import _functional_collectives as fc
        x = logits.to(torch.float32)
        m = fc.all_reduce(x.amax(dim=-1), "max", group)
        e = torch.exp(x - m[..., None])
        se = fc.all_reduce(e.sum(dim=-1), "sum", group)
        mine = (labels >= lo) & (labels < lo + x.shape[-1])
        idx = (labels.long() - lo).clamp(0, x.shape[-1] - 1)
        picked = torch.where(mine, x.gather(-1, idx[..., None])[..., 0], 0.0)
        picked = fc.all_reduce(picked, "sum", group)
        ctx.save_for_backward(e, se, mine, idx)
        ctx.dtype = logits.dtype
        return picked - m - torch.log(se)

    @staticmethod
    def backward(ctx, dll):
        e, se, mine, idx = ctx.saved_tensors
        grad = -(e / se[..., None])
        grad.scatter_add_(-1, idx[..., None], mine[..., None].to(grad.dtype))
        return (grad * dll[..., None]).to(ctx.dtype), None, None, None


def _label_logprob_sharded(logits, labels) -> torch.Tensor:
    """``_label_logprob`` on DTensors through ``local_map``: the batch over the
    data axes and, where it divides the model axis, the vocabulary over it
    (``_VocabParallelLogprob``); else each rank takes whole rows."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
    m, v = mesh_model_size(mesh), logits.shape[-1]
    split = m > 1 and v % m == 0
    base = data_placements(mesh, logits.shape[0])
    lp = with_model(mesh, base, Shard(2) if split else Replicate())
    yp = with_model(mesh, base, Replicate())
    if split:
        group, lo = mesh.get_group("model"), mesh.get_local_rank("model") * (v // m)
        body = lambda x, y: _VocabParallelLogprob.apply(x, y, lo, group)  # noqa: E731
    else:
        body = _label_logprob
    return local_map(body, out_placements=(list(yp),), in_placements=(lp, yp),
                     in_grad_placements=(lp, yp), device_mesh=mesh,
                     redistribute_inputs=True)(logits, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if isinstance(logits, DTensor):
        ll = _label_logprob_sharded(logits, labels)
    else:
        ll = _label_logprob(logits, labels)
    if mask is None:
        return -ll.mean()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1)


def _lm_loss(logits: torch.Tensor, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.family == "vlm":
        logits = logits[:, cfg.n_patches:]
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:], batch.get("mask"))


def _run_blocks(blocks: Iterable[nn.Module], h: torch.Tensor, *args) -> torch.Tensor:
    """``block(h, positions, *args)`` for each block, positions 0 .. S - 1
    of h, each block's output pinned batch-sharded (``constrain_act``).
    Under autograd each block is rematerialised, as the JAX model's
    ``remat_name = "block"``: only its inputs are kept, and its forward runs
    again in the backward. The blocks draw no random numbers, so the RNG
    state is not saved."""
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for block in blocks:
        if current_remat() == "block" and torch.is_grad_enabled() and (
                h.requires_grad or any(p.requires_grad for p in block.parameters())):
            # A block that gathers its weights when it runs (FSDP,
            # distributed.elastic) recomputes in full, releasing them again.
            with set_checkpoint_early_stop(not hasattr(block, "_fsdp_params")):
                h = checkpoint(block, h, positions, *args, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            h = block(h, positions, *args)
        h = constrain_act(h)
    return h


# ---------------------------------------------------------------------------
# The model and its two tiers
# ---------------------------------------------------------------------------
class LM(nn.Module):
    """Decoder LM. ``unembed`` is None for tied embeddings (the head reads
    ``embed``) until ``merge_params`` puts the trained head copy there."""

    def __init__(self, cfg: ModelConfig, embed: nn.Parameter, blocks: Iterable[Block],
                 final_norm: L.RMSNorm, unembed: Optional[nn.Parameter]):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.unembed = unembed

    def forward(self, batch: dict) -> torch.Tensor:
        return self._logits(_run_blocks(self.blocks, _embed_tokens(
            self.embed, batch["tokens"], self.cfg, batch.get("patches"))))

    def loss(self, batch: dict) -> torch.Tensor:
        return _lm_loss(self(batch), batch, self.cfg)

    def _logits(self, h: torch.Tensor) -> torch.Tensor:
        w = self.embed if self.unembed is None else self.unembed
        return _head(self.final_norm, w, h, self.cfg)

    # ---- serving -------------------------------------------------------------
    def init_cache(self, batch: int, smax: int) -> List[BlockCache]:
        """An empty decode cache for ``smax`` positions, one dict per block."""
        return [block.init_cache(batch, smax) for block in self.blocks]

    def prefill(self, batch: dict) -> Tuple[torch.Tensor, List[BlockCache]]:
        """Logits of the last position (B, 1, padded_vocab) and the cache."""
        h = _embed_tokens(self.embed, batch["tokens"], self.cfg, batch.get("patches"))
        positions = torch.arange(h.shape[1], device=h.device)[None, :]
        caches = []
        for block in self.blocks:
            with block_weights(block):
                h, cache = block.prefill(h, positions)
            caches.append(cache)
        return self._logits(h[:, -1:]), caches

    def decode_step(self, cache: List[BlockCache], token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, List[BlockCache]]:
        """One token (B, 1) at host-int position ``pos``: logits (B, 1,
        padded_vocab) and the cache with that position filled."""
        h = _embed_tokens(self.embed, token, self.cfg)
        new = []
        for block, c in zip(self.blocks, cache):
            with block_weights(block):
                h, c = block.decode(h, c, pos)
            new.append(c)
        return self._logits(h), new

    def split_params(self, split: int) -> Tuple["Prefix", "Suffix"]:
        """The frozen prefix and the trainable suffix at block boundary
        ``split``. Tied embeddings are untied here: the input embedding stays
        frozen and the head becomes a trainable copy (the paper's "train a
        new classifier"), so no parameter is shared between the tiers."""
        blocks = list(self.blocks)
        unembed = self.unembed
        if unembed is None:
            unembed = nn.Parameter(self.embed.detach().clone())
        return (Prefix(self.cfg, self.embed, blocks[:split]),
                Suffix(self.cfg, blocks[split:], self.final_norm, unembed))


class Prefix(nn.Module):
    """Blocks [0, split): the storage tier's feature extraction."""

    def __init__(self, cfg: ModelConfig, embed: nn.Parameter, blocks: Iterable[Block]):
        super().__init__()
        self.cfg = cfg
        self.embed = embed
        self.blocks = nn.ModuleList(blocks)

    def forward(self, batch: dict) -> torch.Tensor:
        """forward_prefix: the boundary activations (B, S, D)."""
        return _run_blocks(self.blocks, _embed_tokens(self.embed, batch["tokens"], self.cfg,
                                                      batch.get("patches")))


class Suffix(nn.Module):
    """Blocks [split, N) and the head: the compute tier's trainable part."""

    def __init__(self, cfg: ModelConfig, blocks: Iterable[Block], final_norm: L.RMSNorm,
                 unembed: nn.Parameter):
        super().__init__()
        self.cfg = cfg
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = final_norm
        self.unembed = unembed

    def forward(self, acts: torch.Tensor) -> torch.Tensor:
        """forward_suffix: logits (B, S, padded_vocab) in f32."""
        return _head(self.final_norm, self.unembed, _run_blocks(self.blocks, acts), self.cfg)

    def loss(self, acts: torch.Tensor, batch: dict) -> torch.Tensor:
        """loss_suffix."""
        return _lm_loss(self(acts), batch, self.cfg)


def merge_params(frozen: Prefix, trainable: Suffix) -> LM:
    return LM(frozen.cfg, frozen.embed, [*frozen.blocks, *trainable.blocks],
              trainable.final_norm, trainable.unembed)


def build_lm(cfg: ModelConfig, *, device="cuda", generator: torch.Generator) -> LM:
    """A randomly initialised dense, MoE, SSM, hybrid or VLM LM on
    ``device``; ``generator`` must be a generator of that device."""
    if cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm"):
        raise ValueError(f"build_lm takes no {cfg.family} model")
    dt = dtype_of(cfg.param_dtype)
    embed = nn.Parameter(embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, device))
    blocks = [Block(cfg, device=device, generator=generator, index=i)
              for i in range(cfg.n_blocks)]
    final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dt, device=device)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = nn.Parameter(embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, device))
    return LM(cfg, embed, blocks, final_norm, unembed)
