"""Layers of the LM families and of the encoder-decoder, and the mamba
frontend's causal conv.

Counterpart of ``repro/models/layers.py``. Each layer is an ``nn.Module``
whose parameters keep the JAX package's names and shapes (``wq`` is
``(d_model, n_heads, head_dim)``, ``wo`` is ``(n_heads, head_dim, d_model)``),
so converted weights load as they are, and a plain function that applies it.
Casts sit where the JAX layers put them. Attention goes to
``ops.flash_attention`` and single-token decode to ``ops.decode_attention``:
the CUDA kernels for tensors on the card, the plain versions on the CPU; K
and V keep their ``n_kv_heads`` heads, in the cache too, and are never
repeated on the card. Projections stay ``torch.matmul``, as the JAX package
left them to XLA.

The MoE FFN (``MoE``, ``moe_apply``) follows the reference step for step:
groups are batch rows, the top k of an f32 softmax taken in JAX's order
(the lower expert first among equal probabilities), slots sorted stably by
expert into capacity buffers, the later tokens of an over-full expert
dropped, the experts' SwiGLU batched over the expert axis with ``bmm``
(einsums in the reference, outside any Pallas kernel). The combine gathers,
for each token, its kept slots and adds them in ascending expert order in
f32, where the reference scatter-adds: no atomics, so two calls on the card
give the same bits.

Moonlight's layers have no JAX counterpart: latent attention (``MLA``,
``mla_apply``), whose Q.K head dim of 192 and V head dim of 128 go to the
flash kernels as they are, and DeepSeek-V3's MoE (``DeepSeekMoE``,
``deepseek_moe_apply``): sigmoid routing with a frozen correction bias,
experts that drop no token, run as grouped products over the rows sorted by
expert (``grouped_mm``), and shared experts. Neither takes DTensors.

On DTensors (the sharded step and the dry-run) the ops DTensor has no
sharding rule for go through ``local_map`` with the placements the JAX
package's constraints name: the embedding lookup (``embed_lookup``: the
vocabulary over the model axis, each rank looking up its own rows and the
partial rows summed) and the whole MoE (``moe_apply``: the batch over the
data axes, the experts over the model axis, or their d_ff where the experts
do not divide it; each rank routes its rows over every expert, runs its own
experts' slots and adds their share of the combine, and the shares are
summed).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.config import ModelConfig
from repro_torch.distributed.autoshard import (
    data_placements, dims_spec, grad_placements, mesh_model_size, model_partial, with_model)
from repro_torch.kernels import ops
from repro_torch.models.module import dense_init, dtype_of
from repro_torch.obs.program import METRICS, TRACER, record_expert_loads


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, dtype: torch.dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x, self.eps)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """f32 mean and (biased) variance, ``rsqrt(var + eps)``, then scale and
    bias in f32, cast back to x's dtype."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(dt)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, *, dtype: torch.dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(self.scale, self.bias, x, self.eps)


# ---------------------------------------------------------------------------
# Head contractions
# ---------------------------------------------------------------------------
def merge_heads(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, x, w)`` for an output projection of heads, ``eq`` one
    of "...hd,hdm->...m" with named leading dims. On DTensors split over
    some mesh dim the two head dims are flattened heads first instead, so a
    head-sharded operand stays sharded (einsum may order them the other
    way, which DTensor cannot always flatten without a gather)."""
    if any(isinstance(t, DTensor) and any(not isinstance(p, Replicate) for p in t.placements)
           for t in (x, w)):
        h, d, m = w.shape
        return torch.matmul(x.reshape(*x.shape[:-2], h * d), w.reshape(h * d, m))
    return torch.einsum(eq, x, w)


# ---------------------------------------------------------------------------
# Embedding lookup
# ---------------------------------------------------------------------------
def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``embed[tokens]``; a DTensor table is looked up through ``local_map``,
    with the vocabulary over the model axis where it divides."""
    if not isinstance(embed, DTensor):
        return embed[tokens]
    mesh = embed.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    m, v = mesh_model_size(mesh), embed.shape[0]
    split = m > 1 and v % m == 0
    base = data_placements(mesh, tokens.shape[0])
    ep = with_model(mesh, [Replicate()] * mesh.ndim, Shard(0) if split else Replicate())
    tp = with_model(mesh, base, Replicate())
    lo = mesh.get_local_rank("model") * (v // m) if split else 0

    def local(el, tl):
        if not split:
            return el[tl]
        mine = (tl >= lo) & (tl < lo + el.shape[0])
        return torch.where(mine[..., None], el[(tl - lo).clamp(0, el.shape[0] - 1)], 0)

    out = local_map(local, out_placements=(list(with_model(
        mesh, base, Partial() if split else Replicate())),), in_placements=(ep, tp),
        in_grad_placements=(grad_placements(mesh, base, Shard(0) if split else Replicate(),
                                             False), tp),
        device_mesh=mesh, redistribute_inputs=True)(embed, tokens)
    return out.redistribute(mesh, tp) if split else out


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE. x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    f32 = dict(dtype=torch.float32, device=x.device)
    # theta made on the device by a fill: a tensor copied from the host waits
    # for the stream, which would stall the host at every attention layer.
    freqs = torch.exp(-torch.log(torch.full((), theta, **f32))
                      * torch.arange(0, half, **f32) / half)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hdim
        init = dict(dtype=dt, device=device)
        self.wq = nn.Parameter(dense_init(generator, d, (hq, hd), **init))
        self.wk = nn.Parameter(dense_init(generator, d, (hkv, hd), **init))
        self.wv = nn.Parameter(dense_init(generator, d, (hkv, hd), **init))
        self.wo = nn.Parameter(dense_init(generator, hq * hd, d, **init).reshape(hq, hd, d))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(hq, hd, **init))
            self.bk = nn.Parameter(torch.zeros(hkv, hd, **init))
            self.bv = nn.Parameter(torch.zeros(hkv, hd, **init))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.norm_eps, **init)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, **init)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    q = torch.einsum("bsd,dhk->bshk", x, p.wq)
    k = torch.einsum("bsd,dhk->bshk", x, p.wk)
    v = torch.einsum("bsd,dhk->bshk", x, p.wv)
    if cfg.qkv_bias:
        q = q + p.bq
        k = k + p.bk
        v = v + p.bv
    if cfg.qk_norm:
        q = p.q_norm(q)
        k = p.k_norm(k)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def attend(p: Attention, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ModelConfig, *, window: Optional[int] = None,
           causal: bool = True) -> torch.Tensor:
    """Attention of projected q (B, S, H, hd) over k, v (B, S, Hkv, hd), then
    the output projection."""
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.attn_softcap)
    return merge_heads("bshd,hdm->bsm", out, p.wo)


def attention_apply(
    p: Attention,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    causal: bool = True,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence attention (train / prefill)."""
    s = x.shape[1]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    return attend(p, q, k, v, cfg, window=window, causal=causal)


# ---------------------------------------------------------------------------
# Multi-head latent attention (DeepSeek-V2/V3's MLA, Moonlight's)
# ---------------------------------------------------------------------------
class MLA(nn.Module):
    """``wq`` (d, H, nope + rope); ``w_kv_a`` (d, r + rope): the latent and
    the one rope head of K; ``kv_norm`` the latent's RMSNorm; ``w_kv_b``
    (r, H, nope + v): each head's K nope part and V out of the latent; ``wo``
    (H, v, d). Q has no latent of its own (``q_lora_rank`` null)."""

    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        init = dict(dtype=dt, device=device)
        d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
        nope, rope_d, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        self.wq = nn.Parameter(dense_init(generator, d, (h, nope + rope_d), **init))
        self.w_kv_a = nn.Parameter(dense_init(generator, d, r + rope_d, **init))
        self.kv_norm = RMSNorm(r, cfg.norm_eps, **init)
        self.w_kv_b = nn.Parameter(dense_init(generator, r, (h, nope + dv), **init))
        self.wo = nn.Parameter(dense_init(generator, h * dv, d, **init).reshape(h, dv, d))


def mla_apply(p: MLA, x: torch.Tensor, cfg: ModelConfig, *,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal MLA over the normed input x (B, S, D), as the published
    ``DeepseekV3Attention`` with ``q_lora_rank`` null: Q = x wq split into
    its nope and rope parts; [c_kv | k_pe] = x w_kv_a, c_kv RMS-normed; [k_nope
    | v] = c_kv w_kv_b; rope on q_pe and on k_pe, one head shared by all; K =
    [k_nope | k_pe] and Q = [q_nope | q_pe] at Q.K dim nope + rope, scale
    1/sqrt(nope + rope); V at its own dim; then ``wo``. Rope rotates the
    halves of the rope part (``rope``), where the published code pairs
    neighbouring dims: a fixed permutation of the rope columns of ``wq`` and
    ``w_kv_a``, the same model."""
    if isinstance(x, DTensor):
        raise NotImplementedError("latent attention is not sharded: run it on plain tensors")
    tr = TRACER
    b, s, _ = x.shape
    h, r, nope = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    with tr.span("attn.mla", x):
        q = torch.einsum("bsd,dhk->bshk", x, p.wq)
        kv_a = torch.matmul(x, p.w_kv_a)
        c_kv = p.kv_norm(kv_a[..., :r])
        k_pe = rope(kv_a[..., None, r:], positions, cfg.rope_theta)       # (B, S, 1, rope)
        kv = torch.einsum("bsc,chk->bshk", c_kv, p.w_kv_b)               # (B, S, H, nope + v)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)], dim=-1)
        k = torch.cat([kv[..., :nope], k_pe.expand(b, s, h, k_pe.shape[-1])], dim=-1)
        out = ops.flash_attention(q, k, kv[..., nope:], causal=True)
        return merge_heads("bshd,hdm->bsm", out, p.wo)


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, Smax, Hkv, hd)
    v: torch.Tensor


def pad_unsharded(x: torch.Tensor, pad: tuple) -> torch.Tensor:
    """``F.pad(x, pad)`` with zeros. A DTensor whose padded dims no placement
    shards is padded on each rank's local shard, which needs no
    communication (DTensor's own rule for the pad op raises an IndexError
    on a 2-D mesh in torch 2.11)."""
    if isinstance(x, DTensor):
        padded = {x.dim() - 1 - i // 2 for i, n in enumerate(pad) if n}
        if not any(isinstance(p, Shard) and p.dim % x.dim() in padded for p in x.placements):
            shape = list(x.shape)
            for i in range(len(pad) // 2):
                shape[x.dim() - 1 - i] += pad[2 * i] + pad[2 * i + 1]
            stride = [1] * len(shape)
            for d in range(len(shape) - 2, -1, -1):
                stride[d] = stride[d + 1] * shape[d + 1]
            return DTensor.from_local(F.pad(x.to_local(), pad), x.device_mesh, x.placements,
                                      run_check=False, shape=torch.Size(shape),
                                      stride=tuple(stride))
    return F.pad(x, pad)


def write_position(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """``cache[:, pos] = new`` in place (cache (B, S, H, hd), new (B, H,
    hd)). A DTensor cache is written on the rank whose local positions hold
    ``pos`` (the sequence may be sharded: the flash-decode layout), from
    ``new`` placed as the cache's batch and heads."""
    if not isinstance(cache, DTensor):
        cache[:, pos] = new.to(cache.dtype)
        return
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh = cache.device_mesh
    to_new = {0: Shard(0), 2: Shard(1)}
    want = [to_new.get(p.dim, Replicate()) if isinstance(p, Shard) else Replicate()
            for p in cache.placements]
    if not isinstance(new, DTensor):
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim, run_check=False)
    local_new = new.redistribute(mesh, want).to_local()
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh, cache.placements)
    if offset[1] <= pos < offset[1] + shape[1]:
        cache.to_local()[:, pos - offset[1]] = local_new.to(cache.dtype)


def attention_decode(
    p: Attention,
    x: torch.Tensor,       # (B, 1, D)
    cache: KVCache,
    pos: int,              # current position, a host int
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
):
    """Single-token decode against a filled KV cache. The new K and V are
    written into ``cache`` at ``pos`` in place (the JAX layer returns an
    updated copy), and the same cache is returned. Keys ``<= pos`` are live,
    and with ``window`` only those ``>= pos - window``."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    write_position(cache.k, k_new[:, 0], pos)
    write_position(cache.v, v_new[:, 0], pos)
    out = ops.decode_attention(q[:, 0], cache.k, cache.v, pos + 1, window=window,
                               softcap=cfg.attn_softcap)
    y = merge_heads("bhd,hdm->bm", out.to(p.wo.dtype), p.wo)
    return y[:, None], cache


# ---------------------------------------------------------------------------
# Dense (SwiGLU) MLP
# ---------------------------------------------------------------------------
class MLP(nn.Module):
    """SwiGLU of width ``d_ff`` (by default ``cfg.d_ff``)."""

    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator,
                 d_ff: int = 0):
        super().__init__()
        init = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_gate = nn.Parameter(dense_init(generator, d, f, **init))
        self.w_up = nn.Parameter(dense_init(generator, d, f, **init))
        self.w_down = nn.Parameter(dense_init(generator, f, d, **init))


def mlp_apply(p: MLP, x: torch.Tensor) -> torch.Tensor:
    g = torch.matmul(x, p.w_gate)
    u = torch.matmul(x, p.w_up)
    return torch.matmul(F.silu(g) * u, p.w_down)


# ---------------------------------------------------------------------------
# Mixture of experts: sort/gather dispatch, capacity buffers, gather combine
# ---------------------------------------------------------------------------
class MoE(nn.Module):
    """``router`` (d, E) in f32 whatever ``param_dtype`` is; ``w_gate`` and
    ``w_up`` (E, d, f), ``w_down`` (E, f, d) in ``param_dtype``."""

    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator):
        super().__init__()
        init = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = nn.Parameter(dense_init(generator, d, e, torch.float32, device))

        def experts(fan_in, fan_out):
            return torch.stack([dense_init(generator, fan_in, fan_out, **init)
                                for _ in range(e)])

        self.w_gate = nn.Parameter(experts(d, f))
        self.w_up = nn.Parameter(experts(d, f))
        self.w_down = nn.Parameter(experts(f, d))


class Routing(NamedTuple):
    """Where ``moe_apply`` sends each token. Slot (t, j) is token t's j-th
    choice; the buffers are (B, E, cap)."""
    top_e: torch.Tensor    # (B, S, K) experts, in descending probability
    top_p: torch.Tensor    # (B, S, K) their renormalised probabilities, f32
    rank: torch.Tensor     # (B, S, K) the slot's place in its expert's buffer
    buf_tok: torch.Tensor  # (B, E, cap) the token feeding each buffer slot
    valid: torch.Tensor    # (B, E, cap) the buffer slot holds a token
    cap: int

    @property
    def kept(self) -> torch.Tensor:
        """(B, S, K) the slot made it into its expert's buffer."""
        return self.rank < self.cap


def _gate_probs(p: MoE, x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(torch.matmul(x.to(torch.float32), p.router), dim=-1)


def moe_route(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> Routing:
    """The dispatch of ``moe_apply`` over x (B, S, D); ``p`` needs only its
    ``router``."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = min(int(cfg.capacity_factor * s * k / e + 1), s)
    # jax.lax.top_k's order: a stable descending sort puts the lower expert
    # first among equal probabilities (torch.topk does not).
    top_p, top_e = torch.sort(_gate_probs(p, x), dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :k], top_e[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(b, s * k)                       # slot -> expert
    sort_idx = torch.sort(flat_e, dim=-1, stable=True).indices
    sorted_tok = sort_idx // k                             # slot -> its token
    counts = F.one_hot(flat_e, e).sum(dim=1)               # (B, E)
    offsets = torch.cumsum(counts, dim=-1) - counts        # exclusive
    grid_c = torch.arange(cap, device=x.device)
    gather_pos = offsets[:, :, None] + grid_c              # (B, E, C)
    valid = grid_c < counts[:, :, None]
    gather_pos = torch.clamp(gather_pos, 0, s * k - 1)
    buf_tok = sorted_tok.gather(1, gather_pos.reshape(b, e * cap)).reshape(b, e, cap)
    # A slot's place among its expert's slots, in token order.
    inv = torch.argsort(sort_idx, dim=-1)
    rank = (inv - offsets.gather(1, flat_e)).reshape(b, s, k)
    return Routing(top_e, top_p, rank, buf_tok, valid, cap)


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k MoE over tokens of one group. x: (B, S, D) -> (B, S, D)."""
    if isinstance(x, DTensor):
        return _moe_sharded(p, x, cfg)
    return _moe_local(p, p.w_gate, p.w_up, p.w_down, x, cfg, 0).to(x.dtype)


def _moe_local(p, w_gate, w_up, w_down, x: torch.Tensor, cfg: ModelConfig,
               e_lo: int) -> torch.Tensor:
    """The MoE's f32 output over x from experts [e_lo, e_lo + E_local) of
    ``w_gate``'s leading axis (all of them, or a slice of their d_ff): the
    whole output where those are all the experts, else this rank's share."""
    b, s, d = x.shape
    e = w_gate.shape[0]
    r = moe_route(p, x, cfg)
    cap = r.cap
    buf_tok, valid = r.buf_tok, r.valid
    if e != cfg.n_experts:
        buf_tok, valid = buf_tok[:, e_lo:e_lo + e], valid[:, e_lo:e_lo + e]

    # Dispatch (a gather), invalid buffer slots zero.
    idx = buf_tok.reshape(b, e * cap, 1).expand(-1, -1, d)
    xb = x.gather(1, idx).reshape(b, e, cap, d)
    xb = xb.masked_fill(~valid[..., None], 0)

    # Expert FFN, batched over E.
    xe = xb.transpose(0, 1).reshape(e, b * cap, d)
    h = F.silu(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    yb = torch.bmm(h, w_down).reshape(e, b, cap, d).transpose(0, 1)
    yb = yb.reshape(b, e * cap, d)

    # Combine: each token gathers its kept slots and adds them in f32, in
    # ascending expert order (the order of the reference's scatter-add).
    order = torch.argsort(r.top_e, dim=-1)
    e_s, p_s, c_s = (t.gather(-1, order) for t in (r.top_e, r.top_p, r.rank))
    kept = c_s < cap
    if e != cfg.n_experts:   # another rank's experts add nothing here
        kept = kept & (e_s >= e_lo) & (e_s < e_lo + e)
        e_s = torch.clamp(e_s - e_lo, 0, e - 1)
    slot = (e_s * cap + torch.clamp(c_s, max=cap - 1)).reshape(b, -1, 1)
    rows = yb.gather(1, slot.expand(-1, -1, d)).reshape(b, s, -1, d)
    contrib = torch.where(kept[..., None], rows.to(torch.float32) * p_s[..., None], 0.0)
    y = contrib[:, :, 0]
    for j in range(1, contrib.shape[2]):
        y = y + contrib[:, :, j]
    return y


def _moe_sharded(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``moe_apply`` on DTensors: the JAX package's constraint on the expert
    buffers (``autoshard.dims_spec`` of the (B, E, C, F) hidden buffer:
    experts over the model axis, else their d_ff) taken as ``local_map``
    placements; each rank's share of the output is summed over the model
    axis, then cast to x's dtype. Outside ``activation_sharding`` nothing is
    pinned and the experts stay whole on every rank."""
    mesh = x.device_mesh
    m = mesh_model_size(mesh)
    e, f = cfg.n_experts, cfg.d_ff
    hidden = dims_spec((x.shape[0], e, 1, f), ("batch", "model", None, None),
                       alt=("batch", None, None, "model"))
    mode = None if m == 1 else "experts" if hidden.axes(1) else "d_ff" if hidden.axes(3) \
        else None
    base = data_placements(mesh, x.shape[0])
    rep = [Replicate()] * mesh.ndim
    xp = with_model(mesh, base, Replicate())
    rp = tuple(rep)
    up = with_model(mesh, rep, Shard(0) if mode == "experts" else
                         Shard(2) if mode else Replicate())
    dp = with_model(mesh, rep, Shard(0) if mode == "experts" else
                         Shard(1) if mode else Replicate())
    e_lo = mesh.get_local_rank("model") * (e // m) if mode == "experts" else 0
    split = mode is not None
    out = local_map(
        lambda router, *a: _moe_local(SimpleNamespace(router=router), *a, cfg, e_lo),
        out_placements=(list(with_model(mesh, base, Partial() if split else Replicate())),),
        in_placements=(rp, up, up, dp, xp),
        in_grad_placements=(grad_placements(mesh, base, Replicate(), split),
                            grad_placements(mesh, base, up[-1] if split else Replicate(),
                                             False),
                            grad_placements(mesh, base, up[-1] if split else Replicate(),
                                             False),
                            grad_placements(mesh, base, dp[-1] if split else Replicate(),
                                             False),
                            model_partial(mesh, xp) if split else xp),
        device_mesh=mesh, redistribute_inputs=True)(p.router, p.w_gate, p.w_up, p.w_down, x)
    return out.redistribute(mesh, xp).to(x.dtype)


def moe_aux_loss(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style)."""
    probs = _gate_probs(p, x)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = F.one_hot(top1, cfg.n_experts).to(torch.float32).mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    return cfg.n_experts * torch.sum(frac_tokens * frac_probs)


# ---------------------------------------------------------------------------
# DeepSeek-V3's MoE (Moonlight): sigmoid routing with a correction bias,
# experts that drop no token, shared experts
# ---------------------------------------------------------------------------
class DeepSeekMoE(nn.Module):
    """``router`` (d, E) in ``param_dtype``, computed in f32 as the published
    gate does; ``e_score_correction_bias`` (E,) an f32 buffer, not trained
    (its update rule and the ``seq_aux`` balance loss are pretraining
    devices); the routed experts' ``w_gate`` and ``w_up`` (E, d, f),
    ``w_down`` (E, f, d); ``shared`` one SwiGLU of width
    ``n_shared_experts * d_ff``, the shared experts side by side."""

    def __init__(self, cfg: ModelConfig, *, device, generator: torch.Generator):
        super().__init__()
        init = dict(dtype=dtype_of(cfg.param_dtype), device=device)
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = nn.Parameter(dense_init(generator, d, e, **init))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(e, dtype=torch.float32, device=device))

        def experts(fan_in, fan_out):
            return torch.stack([dense_init(generator, fan_in, fan_out, **init)
                                for _ in range(e)])

        self.w_gate = nn.Parameter(experts(d, f))
        self.w_up = nn.Parameter(experts(d, f))
        self.w_down = nn.Parameter(experts(f, d))
        self.shared = MLP(cfg, device=device, generator=generator,
                          d_ff=cfg.n_shared_experts * f) if cfg.n_shared_experts else None


class DroplessRouting(NamedTuple):
    """Where ``deepseek_moe_apply`` sends each of T tokens: its K choices and
    their weights, and the (token, choice) rows sorted by expert."""
    top_e: torch.Tensor     # (T, K) experts, by descending s + b, the lower first at ties
    weight: torch.Tensor    # (T, K) f32: s of the choice, over their sum, times the scale
    order: torch.Tensor     # (T K,) row t K + j of each sorted row, by expert, then token
    counts: torch.Tensor    # (E,) rows of each expert
    ends: torch.Tensor      # (E,) int32, the end of each expert's rows among the sorted


def deepseek_route(p: DeepSeekMoE, x: torch.Tensor, cfg: ModelConfig) -> DroplessRouting:
    """DeepSeek-V3's ``noaux_tc`` gate over x (T, D): s = sigmoid(x_f32 W_r),
    the top K of s + b chosen, their s renormalised (over the sum plus
    1e-20, as published) and times ``routed_scaling_factor``. With one group
    (``n_group`` = ``topk_group`` = 1) the group-limited step keeps every
    expert: it is the identity, and is left out."""
    k = cfg.top_k
    s = torch.sigmoid(torch.matmul(x.to(torch.float32), p.router.to(torch.float32)))
    # A stable descending sort puts the lower expert first among equal
    # scores (torch.topk does not say which it keeps).
    top_e = torch.sort(s.detach() + p.e_score_correction_bias, dim=-1, descending=True,
                       stable=True).indices[:, :k]
    w = s.gather(-1, top_e)
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * cfg.routed_scaling_factor
    flat = top_e.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    # Counted by a scatter-add: bincount reads the largest index on the host.
    counts = torch.zeros(cfg.n_experts, dtype=torch.int64, device=x.device).scatter_add_(
        0, flat, torch.ones_like(flat))
    return DroplessRouting(top_e, w, order, counts,
                           torch.cumsum(counts, 0).to(torch.int32))


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Rows [ends[e - 1], ends[e]) of x (N, K) times w[e] (K, M), for every
    expert e: (N, M). bf16 on the card goes to ``torch._grouped_mm`` (no host
    sync); elsewhere (the CPU, f32) a product a group over host offsets."""
    if x.is_cuda and x.dtype == torch.bfloat16:
        return torch._grouped_mm(x, w, offs=ends)
    out, lo = [], 0
    for e, hi in enumerate(ends.tolist()):
        out.append(torch.matmul(x[lo:hi], w[e]))
        lo = hi
    return torch.cat(out)


def deepseek_moe_apply(p: DeepSeekMoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """DeepSeek-V3's MoE over x (B, S, D): every token's K routed experts,
    no capacity and no token dropped, and the shared experts. The (token,
    choice) rows, sorted by expert, go through each expert's SwiGLU as
    grouped products; each token then gathers its K rows and adds them,
    weighted, in f32 in the order of its choices, with no atomics, so two
    calls on the card give the same bits; the shared experts' output is
    added unweighted."""
    if isinstance(x, DTensor):
        raise NotImplementedError("the dropless MoE (sigmoid_bias router) is not sharded: "
                                  "run it on plain tensors")
    tr, mx = TRACER, METRICS
    b, s, d = x.shape
    k = cfg.top_k
    xt = x.reshape(b * s, d)
    with tr.span("moe.route", x):
        r = deepseek_route(p, xt, cfg)
        if tr.enabled:
            mx.inc("moe_routed_rows_total", b * s * k)
            record_expert_loads(r.counts)
    with tr.span("moe.experts", xt):
        # Each token's row K times, then sorted: the gather's backward
        # writes each row once and the sum over the K copies has a fixed
        # order (a gather by order // K would scatter-add into each token).
        xs = xt[:, None].expand(b * s, k, d).reshape(b * s * k, d)[r.order]
        hidden = F.silu(grouped_mm(xs, p.w_gate, r.ends)) * grouped_mm(xs, p.w_up, r.ends)
        ys = grouped_mm(hidden, p.w_down, r.ends)
    with tr.span("moe.combine", ys):
        # Row t K + j of the sorted rows' inverse: where slot (t, j) landed.
        where = torch.empty_like(r.order)
        where[r.order] = torch.arange(r.order.numel(), device=x.device)
        where = where.view(b * s, k)
        y = ys[where[:, 0]].to(torch.float32) * r.weight[:, :1]
        for j in range(1, k):
            y = y + ys[where[:, j]].to(torch.float32) * r.weight[:, j:j + 1]
        y = y.to(x.dtype).view(b, s, d)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x)
    return y


# ---------------------------------------------------------------------------
# Depthwise causal conv (mamba frontend)
# ---------------------------------------------------------------------------
def causal_conv1d(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. w: (W, C), x: (B, S, C); summed in f32."""
    width, s = w.shape[0], x.shape[1]
    xp = pad_unsharded(x, (0, 0, width - 1, 0))
    out = torch.zeros_like(x, dtype=torch.float32, memory_format=torch.contiguous_format)
    for i in range(width):
        out = out + xp[:, i:i + s].to(torch.float32) * w[i]
    return out.to(x.dtype)
