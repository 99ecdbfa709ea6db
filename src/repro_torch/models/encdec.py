"""Whisper-style encoder-decoder, split in the encoder.

Counterpart of ``repro/models/encdec.py``. The conv/mel frontend is a stub,
as there: ``batch["frames"]`` holds the frame embeddings (B, S_frames,
d_model).

  * Encoder blocks: pre-LayerNorm, non-causal self-attention (rope at the
    frame positions, through ``ops.flash_attention(causal=False)``), then a
    SwiGLU MLP. Decoder blocks: causal self-attention (rope, and the learned
    ``dec_pos`` of 65,536 rows added to the token embedding), cross-attention
    over the encoder's output, the MLP. The head is tied to ``dec_embed``;
    logits are f32 and masked past ``vocab_size``.
  * Cross-attention over a full decoder sequence (forward, prefill) is the
    reference's einsum and softmax in torch: its 256 queries attend over
    S_enc keys, and the flash kernel takes ``Sq == Sk`` only. In a decode
    step it is one query over every cached frame, which is
    ``ops.decode_attention`` with ``length = S_enc``.
  * The HAPI split is in the encoder: ``EncDec.split_params(split)`` gives a
    ``Prefix`` of encoder blocks [0, split) and a ``Suffix`` holding the rest
    of the encoder, ``enc_norm`` and the whole decoder with its head. The two
    share no parameter; both share theirs with the ``EncDec``.
  * Serving: ``prefill`` encodes the frames, runs the decoder over
    ``batch["tokens"]`` and returns the last position's logits with the
    cache ``{"self": [KVCache per decoder block] of smax positions (the
    prompt's K, V, the rest zero), "cross": [KVCache per decoder block] of
    min(1500, S_enc) frames}``, both bf16. ``decode_step`` writes one token's
    K and V into ``cache["self"]`` in place. The self-attention cache's K is
    ``_project_qkv``'s: rope on the projection of ``ln1(h)``, as the
    reference computes it (whisper has no qkv bias or qk norm).

The reference's prefill and decode step leave the padded vocabulary rows
unmasked; the port masks them as its forward does, so a greedy token is
always a real one. The smoke configs have no padded rows.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.distributed.autoshard import block_weights, constrain_act, gather_fsdp
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import softmax_scale
from repro_torch.models import layers as L
from repro_torch.models.module import dtype_of, embed_init
from repro_torch.models.transformer import _head, _run_blocks, cross_entropy

CROSS_ATTN_FRAMES = 1500  # whisper's 30 s window
DEC_POSITIONS = 65536     # rows of the learned decoder position embedding

KV = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Cross attention
# ---------------------------------------------------------------------------
def cross_kv(p: L.Attention, enc_out: torch.Tensor, cfg: ModelConfig) -> KV:
    """The encoder output's K and V (B, S_enc, Hkv, hd), without rope."""
    k = torch.einsum("bsd,dhk->bshk", enc_out, p.wk)
    v = torch.einsum("bsd,dhk->bshk", enc_out, p.wv)
    return k, v


def cross_attention_apply(p: L.Attention, x: torch.Tensor, enc_kv: KV,
                          cfg: ModelConfig) -> torch.Tensor:
    """x (B, S_dec, D) attends over the encoder's K, V (B, S_enc, Hkv, hd):
    f32 scores of products in x's dtype, P cast to that dtype."""
    k, v = enc_kv
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k = ops.repeat_kv(k.to(q.dtype), n_rep)
    v = ops.repeat_kv(v.to(q.dtype), n_rep)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * softmax_scale(cfg.hdim)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return L.merge_heads("bshd,hdm->bsm", out, p.wo)


def cross_attention_decode(p: L.Attention, x: torch.Tensor, cross: L.KVCache,
                           cfg: ModelConfig) -> torch.Tensor:
    """One token x (B, 1, D) over every cached frame: the decode kernel at
    ``length`` = the cache's frames."""
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    out = ops.decode_attention(q[:, 0], cross.k, cross.v, cross.k.shape[1])
    return L.merge_heads("bhd,hdm->bm", out.to(p.wo.dtype), p.wo)[:, None]


# ---------------------------------------------------------------------------
# Encoder / decoder blocks
# ---------------------------------------------------------------------------
class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator):
        super().__init__()
        init = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        self.cfg = cfg
        self.ln1 = L.LayerNorm(cfg.d_model, cfg.norm_eps, **init)
        self.attn = L.Attention(cfg, device=device, generator=generator)
        self.ln2 = L.LayerNorm(cfg.d_model, cfg.norm_eps, **init)
        self.mlp = L.MLP(cfg, device=device, generator=generator)

    def forward(self, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = h + L.attention_apply(self.attn, self.ln1(h), self.cfg, causal=False,
                                  positions=positions)
        return h + L.mlp_apply(self.mlp, self.ln2(h))


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator):
        super().__init__()
        init = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        self.cfg = cfg
        self.ln1 = L.LayerNorm(cfg.d_model, cfg.norm_eps, **init)
        self.self_attn = L.Attention(cfg, device=device, generator=generator)
        self.ln2 = L.LayerNorm(cfg.d_model, cfg.norm_eps, **init)
        self.cross_attn = L.Attention(cfg, device=device, generator=generator)
        self.ln3 = L.LayerNorm(cfg.d_model, cfg.norm_eps, **init)
        self.mlp = L.MLP(cfg, device=device, generator=generator)

    def _cross_and_mlp(self, h: torch.Tensor, enc_kv: KV) -> torch.Tensor:
        h = h + cross_attention_apply(self.cross_attn, self.ln2(h), enc_kv, self.cfg)
        return h + L.mlp_apply(self.mlp, self.ln3(h))

    def forward(self, h: torch.Tensor, positions: torch.Tensor,
                enc: torch.Tensor) -> torch.Tensor:
        h = h + L.attention_apply(self.self_attn, self.ln1(h), self.cfg, positions=positions)
        return self._cross_and_mlp(h, cross_kv(self.cross_attn, enc, self.cfg))

    def prefill(self, h: torch.Tensor, positions: torch.Tensor, enc: torch.Tensor,
                smax: int):
        """Like forward, and this block's self cache (smax positions, the
        prompt's first) and cross cache, both bf16."""
        kv = cross_kv(self.cross_attn, enc, self.cfg)
        q, k, v = L._project_qkv(self.self_attn, self.ln1(h), self.cfg, positions)
        h = self._cross_and_mlp(h + L.attend(self.self_attn, q, k, v, self.cfg), kv)
        pad = (0, 0, 0, 0, 0, smax - k.shape[1])   # positions past the prompt: zeros
        self_c = L.KVCache(L.pad_unsharded(k.to(torch.bfloat16), pad),
                           L.pad_unsharded(v.to(torch.bfloat16), pad))
        cross_c = L.KVCache(kv[0].to(torch.bfloat16), kv[1].to(torch.bfloat16))
        return h, self_c, cross_c

    def decode(self, h: torch.Tensor, self_c: L.KVCache, cross_c: L.KVCache, pos: int):
        y, self_c = L.attention_decode(self.self_attn, self.ln1(h), self_c, pos, self.cfg)
        h = h + y
        h = h + cross_attention_decode(self.cross_attn, self.ln2(h), cross_c, self.cfg)
        return h + L.mlp_apply(self.mlp, self.ln3(h)), self_c


# ---------------------------------------------------------------------------
# The decoder, shared by the model and its suffix
# ---------------------------------------------------------------------------
def _frames(batch: dict, cfg: ModelConfig) -> torch.Tensor:
    return constrain_act(batch["frames"].to(dtype_of(cfg.compute_dtype)))


def _embed_dec(m: nn.Module, tokens: torch.Tensor, start: int) -> torch.Tensor:
    """Token embeddings plus the learned positions [start, start + S)."""
    h = L.embed_lookup(m.dec_embed, tokens).to(dtype_of(m.cfg.compute_dtype))
    pos = gather_fsdp(m.dec_pos[start:start + tokens.shape[1]])
    return constrain_act(h + pos[None].to(h.dtype))


def _decode_full(m: nn.Module, enc: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The decoder over ``tokens`` attending over ``enc`` (after
    ``enc_norm``): f32 logits (B, S_dec, padded_vocab)."""
    h = _run_blocks(m.dec_blocks, _embed_dec(m, tokens, 0), enc)
    return _head(m.dec_norm, m.dec_embed, h, m.cfg)


def _loss(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:])


# ---------------------------------------------------------------------------
# The model and its two tiers
# ---------------------------------------------------------------------------
class EncDec(nn.Module):
    def __init__(self, cfg: ModelConfig, enc_blocks: Iterable[EncBlock], enc_norm: L.LayerNorm,
                 dec_embed: nn.Parameter, dec_pos: nn.Parameter,
                 dec_blocks: Iterable[DecBlock], dec_norm: L.LayerNorm):
        super().__init__()
        self.cfg = cfg
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_norm = enc_norm
        self.dec_embed = dec_embed
        self.dec_pos = dec_pos
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.dec_norm = dec_norm

    def _encode(self, batch: dict) -> torch.Tensor:
        return self.enc_norm(_run_blocks(self.enc_blocks, _frames(batch, self.cfg)))

    def forward(self, batch: dict) -> torch.Tensor:
        return _decode_full(self, self._encode(batch), batch["tokens"])

    def loss(self, batch: dict) -> torch.Tensor:
        return _loss(self(batch), batch)

    def split_params(self, split: int) -> Tuple["Prefix", "Suffix"]:
        """The frozen prefix (encoder blocks [0, split)) and the trainable
        suffix (the rest) at encoder block boundary ``split``."""
        blocks = list(self.enc_blocks)
        return (Prefix(self.cfg, blocks[:split]),
                Suffix(self.cfg, blocks[split:], self.enc_norm, self.dec_embed, self.dec_pos,
                       self.dec_blocks, self.dec_norm))

    # ---- serving -------------------------------------------------------------
    def init_cache(self, batch: int, smax: int) -> Dict[str, List[L.KVCache]]:
        """An empty cache: ``smax`` self positions and CROSS_ATTN_FRAMES
        cross frames for each decoder block."""
        device = self.dec_embed.device

        def kv(s):
            shape = (batch, s, self.cfg.n_kv_heads, self.cfg.hdim)
            return [L.KVCache(torch.zeros(shape, dtype=torch.bfloat16, device=device),
                              torch.zeros(shape, dtype=torch.bfloat16, device=device))
                    for _ in self.dec_blocks]

        return {"self": kv(smax), "cross": kv(CROSS_ATTN_FRAMES)}

    def prefill(self, batch: dict) -> Tuple[torch.Tensor, Dict[str, List[L.KVCache]]]:
        """Logits of the last token (B, 1, padded_vocab) and the cache;
        ``batch["smax"]`` (default S_dec + 64) sizes the self cache."""
        enc = self._encode(batch)
        enc = enc[:, :min(CROSS_ATTN_FRAMES, enc.shape[1])]
        tokens = batch["tokens"]
        s = tokens.shape[1]
        smax = batch.get("smax", s + 64)
        h = _embed_dec(self, tokens, 0)
        positions = torch.arange(s, device=h.device)[None, :]
        self_c, cross_c = [], []
        for block in self.dec_blocks:
            with block_weights(block):
                h, sc, cc = block.prefill(h, positions, enc, smax)
            self_c.append(sc)
            cross_c.append(cc)
        return _head(self.dec_norm, self.dec_embed, h[:, -1:], self.cfg), \
            {"self": self_c, "cross": cross_c}

    def decode_step(self, cache: Dict[str, List[L.KVCache]], token: torch.Tensor,
                    pos: int) -> Tuple[torch.Tensor, Dict[str, List[L.KVCache]]]:
        """One token (B, 1) at host-int position ``pos``: logits (B, 1,
        padded_vocab) and the cache with that self position filled."""
        h = _embed_dec(self, token, pos)
        new_self = []
        for block, sc, cc in zip(self.dec_blocks, cache["self"], cache["cross"]):
            with block_weights(block):
                h, sc = block.decode(h, sc, cc, pos)
            new_self.append(sc)
        return _head(self.dec_norm, self.dec_embed, h, self.cfg), \
            {"self": new_self, "cross": cache["cross"]}


class Prefix(nn.Module):
    """Encoder blocks [0, split): the storage tier's feature extraction."""

    def __init__(self, cfg: ModelConfig, enc_blocks: Iterable[EncBlock]):
        super().__init__()
        self.cfg = cfg
        self.enc_blocks = nn.ModuleList(enc_blocks)

    def forward(self, batch: dict) -> torch.Tensor:
        """forward_prefix: the boundary activations (B, S_frames, D)."""
        return _run_blocks(self.enc_blocks, _frames(batch, self.cfg))


class Suffix(nn.Module):
    """Encoder blocks [split, N), ``enc_norm`` and the decoder with its tied
    head: the compute tier's trainable part."""

    def __init__(self, cfg: ModelConfig, enc_blocks: Iterable[EncBlock], enc_norm: L.LayerNorm,
                 dec_embed: nn.Parameter, dec_pos: nn.Parameter,
                 dec_blocks: Iterable[DecBlock], dec_norm: L.LayerNorm):
        super().__init__()
        self.cfg = cfg
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_norm = enc_norm
        self.dec_embed = dec_embed
        self.dec_pos = dec_pos
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.dec_norm = dec_norm

    def forward(self, acts: torch.Tensor, batch: dict) -> torch.Tensor:
        """forward_suffix: logits (B, S_dec, padded_vocab) in f32."""
        enc = self.enc_norm(_run_blocks(self.enc_blocks, acts))
        return _decode_full(self, enc, batch["tokens"])

    def loss(self, acts: torch.Tensor, batch: dict) -> torch.Tensor:
        """loss_suffix."""
        return _loss(self(acts, batch), batch)


def merge_params(frozen: Prefix, trainable: Suffix) -> EncDec:
    t = trainable
    return EncDec(frozen.cfg, [*frozen.enc_blocks, *t.enc_blocks], t.enc_norm, t.dec_embed,
                  t.dec_pos, t.dec_blocks, t.dec_norm)


def build_encdec(cfg: ModelConfig, *, device="cuda", generator: torch.Generator) -> EncDec:
    """A randomly initialised encoder-decoder on ``device``; ``generator``
    must be a generator of that device."""
    dt = dtype_of(cfg.param_dtype)
    init = dict(device=device, generator=generator)
    enc_blocks = [EncBlock(cfg, **init) for _ in range(cfg.n_enc_layers)]
    enc_norm = L.LayerNorm(cfg.d_model, cfg.norm_eps, dtype=dt, device=device)
    dec_embed = nn.Parameter(embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, device))
    dec_pos = nn.Parameter(embed_init(generator, DEC_POSITIONS, cfg.d_model, dt, device))
    dec_blocks = [DecBlock(cfg, **init) for _ in range(cfg.n_dec_layers)]
    dec_norm = L.LayerNorm(cfg.d_model, cfg.norm_eps, dtype=dt, device=device)
    return EncDec(cfg, enc_blocks, enc_norm, dec_embed, dec_pos, dec_blocks, dec_norm)
