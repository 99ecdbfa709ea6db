"""Decoder LM of the dense family, split at block boundaries.

Counterpart of ``repro/models/transformer.py``:
  * The layer stack is a ``nn.ModuleList`` of blocks whose boundaries are
    the Hapi split candidates. dense: block == one layer; gemma2: block ==
    (local, global) pair.
  * ``LM.split_params(split)`` gives the two halves of the paper's tier
    split as modules that share the LM's parameters: ``Prefix`` runs the
    embedding and blocks [0, split) (``forward_prefix``), ``Suffix`` runs
    blocks [split, N) and the head (``forward_suffix``, ``loss_suffix``).
    ``merge_params`` joins them back into an ``LM``.
  * Logits are f32 and the cross entropy is taken in f32, as in the JAX
    package.

The moe, ssm, hybrid, vlm and encdec families are not ported yet and raise
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.module import dtype_of, embed_init


# ---------------------------------------------------------------------------
# Block plans — static description of the sublayers inside one block
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SubLayer:
    mixer: str                 # "attn" | "attn_local" | "mamba"
    ffn: str                   # "mlp" | "moe" | "none"


def block_plan(cfg: ModelConfig) -> List[SubLayer]:
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
    """Pre-norm attention (global or sliding-window) then pre-norm SwiGLU MLP."""

    def __init__(self, cfg: ModelConfig, sub: SubLayer, *, device,
                 generator: torch.Generator):
        super().__init__()
        if sub.mixer not in ("attn", "attn_local") or sub.ffn != "mlp":
            raise NotImplementedError(f"sublayer {sub} is not ported yet")
        init = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        self.cfg = cfg
        self.window = cfg.sliding_window if sub.mixer == "attn_local" else None
        self.ln_mixer = L.RMSNorm(cfg.d_model, cfg.norm_eps, **init)
        self.attn = L.Attention(cfg, device=device, generator=generator)
        self.ln_ffn = L.RMSNorm(cfg.d_model, cfg.norm_eps, **init)
        self.mlp = L.MLP(cfg, device=device, generator=generator)

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = h + L.attention_apply(self.attn, self.ln_mixer(h), self.cfg,
                                  window=self.window, positions=positions)
        return h + L.mlp_apply(self.mlp, self.ln_ffn(h))


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator):
        super().__init__()
        for i, sub in enumerate(block_plan(cfg)):
            self.add_module(f"sub{i}", Sublayer(cfg, sub, device=device, generator=generator))

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        for sub in self.children():
            h = sub(h, positions)
        return h


# ---------------------------------------------------------------------------
# Embedding, head, loss
# ---------------------------------------------------------------------------
def _embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = embed[tokens].to(dtype_of(cfg.compute_dtype))
    root_d = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32, device=h.device))
    return h * root_d.to(h.dtype)


def _head(final_norm: L.RMSNorm, w: torch.Tensor, h: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    h = final_norm(h)
    # f32 logits: products of the (compute-dtype) operands summed in f32.
    logits = torch.matmul(h.to(torch.float32), w.to(h.dtype).to(torch.float32).t())
    logits = L._softcap(logits, cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad_mask = torch.arange(cfg.padded_vocab, device=logits.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad_mask, -1e30)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1)


def _lm_loss(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:], batch.get("mask"))


def _run_blocks(blocks: Iterable[Block], h: torch.Tensor) -> torch.Tensor:
    positions = torch.arange(h.shape[1], device=h.device)[None, :]
    for block in blocks:
        h = block(h, positions)
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
        h = _run_blocks(self.blocks, _embed_tokens(self.embed, batch["tokens"], self.cfg))
        w = self.embed if self.unembed is None else self.unembed
        return _head(self.final_norm, w, h, self.cfg)

    def loss(self, batch: dict) -> torch.Tensor:
        return _lm_loss(self(batch), batch)

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
        return _run_blocks(self.blocks, _embed_tokens(self.embed, batch["tokens"], self.cfg))


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
        return _lm_loss(self(acts), batch)


def merge_params(frozen: Prefix, trainable: Suffix) -> LM:
    return LM(frozen.cfg, frozen.embed, [*frozen.blocks, *trainable.blocks],
              trainable.final_norm, trainable.unembed)


def build_lm(cfg: ModelConfig, *, device="cuda", generator: torch.Generator) -> LM:
    """A randomly initialised dense LM on ``device``; ``generator`` must be a
    generator of that device."""
    if cfg.family != "dense":
        raise NotImplementedError(f"the {cfg.family} family is not ported yet")
    dt = dtype_of(cfg.param_dtype)
    embed = nn.Parameter(embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, device))
    blocks = [Block(cfg, device=device, generator=generator) for _ in range(cfg.n_blocks)]
    final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dt, device=device)
    unembed = None
    if not cfg.tie_embeddings:
        unembed = nn.Parameter(embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, device))
    return LM(cfg, embed, blocks, final_norm, unembed)
