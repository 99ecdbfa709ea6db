"""Per-boundary profiling of the LM families (paper §5.3).

Counterpart of ``repro/core/profiler.py`` for ``LayerProfile`` and
``profile_lm``: sizes are static and FLOPs analytic, so profiling allocates
nothing. Every memory estimate is inflated by ``headroom`` (the paper's
over-estimation discipline), so batch adaptation never under-provisions.
Itemsizes come from torch dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.config import ModelConfig
from repro_torch.models.module import dtype_of
from repro_torch.models.transformer import SubLayer, block_plan


@dataclass
class LayerProfile:
    """Per split-boundary profile. Index i = state after block/layer i-1,
    i in [0, n]; i = 0 is the raw input (no pushdown)."""
    name: str
    n_boundaries: int                      # == n_blocks + 1
    input_bytes: float                     # app input, per sample
    out_bytes: List[float]                 # boundary activation bytes / sample
    cum_flops: List[float]                 # prefix FLOPs / sample up to boundary
    act_peak_bytes: List[float]            # fwd working set / sample up to boundary
    prefix_param_bytes: List[float]        # param bytes of blocks [0, i)
    model_param_bytes: float
    freeze_index: int
    headroom: float = 0.08


# ---------------------------------------------------------------------------
# Analytic FLOPs for LM sublayers (per sample of seq length S)
# ---------------------------------------------------------------------------
def _attn_flops(cfg: ModelConfig, s: int, window: Optional[int]) -> float:
    hd, hq, hkv, d = cfg.hdim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    proj = 2 * s * d * (hq + 2 * hkv) * hd + 2 * s * hq * hd * d
    kv_span = min(window + 512, s) if window else s
    scores = 2 * s * kv_span * hq * hd * 2          # QK^T and PV
    return proj + scores


def _mlp_flops(cfg: ModelConfig, s: int) -> float:
    return 2 * s * 3 * cfg.d_model * cfg.d_ff


def _moe_flops(cfg: ModelConfig, s: int) -> float:
    router = 2 * s * cfg.d_model * cfg.n_experts
    expert = 2 * s * cfg.top_k * cfg.capacity_factor * 3 * cfg.d_model * cfg.d_ff
    return router + expert


def _ssm_flops(cfg: ModelConfig, s: int) -> float:
    d, di, n, h, p = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    q = min(cfg.ssm_chunk, s)
    proj = 2 * s * d * (2 * di + 2 * n + h) + 2 * s * di * d
    conv = 2 * s * cfg.conv_width * (di + 2 * n)
    ssd = 2 * s * (q * n + q * h + q * h * p) + 4 * s * n * p * h
    return proj + conv + ssd


def sublayer_flops(cfg: ModelConfig, sub: SubLayer, s: int) -> float:
    if sub.mixer == "attn":
        f = _attn_flops(cfg, s, None)
    elif sub.mixer == "attn_local":
        f = _attn_flops(cfg, s, cfg.sliding_window)
    else:
        f = _ssm_flops(cfg, s)
    if sub.ffn == "mlp":
        f += _mlp_flops(cfg, s)
    elif sub.ffn == "moe":
        f += _moe_flops(cfg, s)
    return f


def block_flops(cfg: ModelConfig, s: int) -> float:
    if cfg.family == "encdec":
        # Encoder block: bidirectional self-attn + MLP over the frames.
        return sublayer_flops(cfg, SubLayer("attn", "mlp"), s)
    return sum(sublayer_flops(cfg, sub, s) for sub in block_plan(cfg))


def encdec_decoder_flops(cfg: ModelConfig, s_enc: int) -> float:
    """Decoder stack: causal self-attn over dec_seq + cross-attn over the
    encoder output + MLP, per sample."""
    sd = cfg.dec_seq
    hd, hq, hkv, d = cfg.hdim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    self_attn = _attn_flops(cfg, sd, None)
    cross_proj = 2 * sd * d * hq * hd + 2 * s_enc * d * 2 * hkv * hd + 2 * sd * hq * hd * d
    cross_scores = 2 * sd * min(s_enc, 1500) * hq * hd * 2
    mlp = _mlp_flops(cfg, sd)
    return cfg.n_dec_layers * (self_attn + cross_proj + cross_scores + mlp)


def head_flops(cfg: ModelConfig, s: int) -> float:
    return 2 * s * cfg.d_model * cfg.padded_vocab


# ---------------------------------------------------------------------------
# LM profile
# ---------------------------------------------------------------------------
def profile_lm(cfg: ModelConfig, seq_len: int, headroom: float = 0.08) -> LayerProfile:
    act_dt = dtype_of(cfg.compute_dtype).itemsize
    par_dt = dtype_of(cfg.param_dtype).itemsize
    s = seq_len
    d = cfg.d_model

    if cfg.family == "vlm":
        input_bytes = (s - cfg.n_patches) * 4 + cfg.n_patches * d * act_dt
    elif cfg.family == "encdec":
        input_bytes = s * d * act_dt + cfg.dec_seq * 4
    else:
        input_bytes = s * 4  # int32 tokens

    boundary_act = s * d * act_dt          # (S, D) hidden state per sample
    n = cfg.n_blocks
    bp = cfg.block_params() * par_dt
    bf = block_flops(cfg, s)

    # Working set of the prefix per sample: input + output of the live block
    # plus attention/moe workspace (~4x hidden), constant in depth.
    work = 6 * boundary_act

    out_bytes = [float(input_bytes)] + [float(boundary_act)] * n
    cum_flops = [0.0]
    act_peak = [float(input_bytes)]
    prefix_pb = [0.0]
    emb_bytes = cfg.padded_vocab * d * par_dt
    for i in range(1, n + 1):
        cum_flops.append(float(i * bf))    # the embedding is a gather: 0 FLOPs
        act_peak.append(float(work))
        prefix_pb.append(emb_bytes + i * bp)
    if cfg.family == "encdec":
        cum_flops[-1] += encdec_decoder_flops(cfg, s) + 2 * cfg.dec_seq * d * cfg.padded_vocab
    else:
        cum_flops[-1] += head_flops(cfg, s)

    return LayerProfile(
        name=cfg.name,
        n_boundaries=n + 1,
        input_bytes=float(input_bytes),
        out_bytes=out_bytes,
        cum_flops=cum_flops,
        act_peak_bytes=act_peak,
        prefix_param_bytes=prefix_pb,
        model_param_bytes=cfg.param_count() * par_dt,
        freeze_index=cfg.freeze_index,
        headroom=headroom,
    )
