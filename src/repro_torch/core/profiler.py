"""Per-boundary profiling (paper §5.3).

Counterpart of ``repro/core/profiler.py``. Two entry points:
  * ``profile_lm``      — block-boundary profile of the LM families: sizes
    are static and FLOPs analytic.
  * ``profile_layered`` — exact per-layer profile of the paper's vision
    models (``models/vision.py``): every boundary's shape from one
    synthetic sample on the ``meta`` device (the reference uses
    ``jax.eval_shape``), so profiling allocates nothing.
Every memory estimate is inflated by ``headroom`` (the paper's
over-estimation discipline), so batch adaptation never under-provisions;
``calibrate_profile`` folds one measured run into it and
``extrapolation_error`` is the paper's error of the estimate. Itemsizes come
from torch dtypes.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional

import torch
from torch import nn
from torch.func import functional_call

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

    @property
    def total_flops(self) -> float:
        return self.cum_flops[-1]

    def memory_estimate(self, boundary: int, batch: int) -> float:
        """OOM-safe estimate of running the prefix [0, boundary) with
        ``batch`` samples (paper §5.3: model + batch-proportional part,
        over-estimated by headroom)."""
        m = self.prefix_param_bytes[boundary] + batch * self.act_peak_bytes[boundary]
        return m * (1.0 + self.headroom)

    def suffix_memory_estimate(self, boundary: int, batch: int, train: bool) -> float:
        act = self.act_peak_bytes[-1] - (
            self.act_peak_bytes[boundary] - self.out_bytes[boundary]
        )
        params = self.model_param_bytes - self.prefix_param_bytes[boundary]
        mult = 3.0 if train else 1.0      # grads + optimizer residency
        return (params * mult + batch * act) * (1.0 + self.headroom)


# ---------------------------------------------------------------------------
# Analytic FLOPs for LM sublayers (per sample of seq length S)
# ---------------------------------------------------------------------------
def _mla_flops(cfg: ModelConfig, s: int) -> float:
    """Latent attention: Q, the latent and K's rope head, K's nope part and V
    out of the latent, the output projection; Q.K at the Q.K head dim and
    P.V at V's."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dqk, dv = cfg.qk_head_dim, cfg.v_head_dim
    proj = 2 * s * d * (h * dqk + r + cfg.qk_rope_head_dim) \
        + 2 * s * r * h * (cfg.qk_nope_head_dim + dv) + 2 * s * h * dv * d
    return proj + 2 * s * s * h * (dqk + dv)


def _attn_flops(cfg: ModelConfig, s: int, window: Optional[int]) -> float:
    hd, hq, hkv, d = cfg.hdim, cfg.n_heads, cfg.n_kv_heads, cfg.d_model
    proj = 2 * s * d * (hq + 2 * hkv) * hd + 2 * s * hq * hd * d
    kv_span = min(window + 512, s) if window else s
    scores = 2 * s * kv_span * hq * hd * 2          # QK^T and PV
    return proj + scores


def _mlp_flops(cfg: ModelConfig, s: int, d_ff: int = 0) -> float:
    return 2 * s * 3 * cfg.d_model * (d_ff or cfg.d_ff)


def _moe_flops(cfg: ModelConfig, s: int) -> float:
    router = 2 * s * cfg.d_model * cfg.n_experts
    if cfg.router == "sigmoid_bias":
        # DeepSeek-V3's experts drop no token: every token's top_k experts,
        # no capacity slack, and the shared ones.
        experts = cfg.top_k + cfg.n_shared_experts
        return router + 2 * s * experts * 3 * cfg.d_model * cfg.d_ff
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
    elif sub.mixer == "mla":
        f = _mla_flops(cfg, s)
    else:
        f = _ssm_flops(cfg, s)
    if sub.ffn == "mlp":
        f += _mlp_flops(cfg, s, sub.d_ff)
    elif sub.ffn == "moe":
        f += _moe_flops(cfg, s)
    return f


def block_flops(cfg: ModelConfig, s: int, index: int = 0) -> float:
    """FLOPs of block ``index`` a sample (the blocks differ only where a MoE
    family's leading blocks are dense)."""
    if cfg.family == "encdec":
        # Encoder block: bidirectional self-attn + MLP over the frames.
        return sublayer_flops(cfg, SubLayer("attn", "mlp"), s)
    return sum(sublayer_flops(cfg, sub, s) for sub in block_plan(cfg, index))


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

    # Working set of the prefix per sample: input + output of the live block
    # plus attention/moe workspace (~4x hidden), constant in depth.
    work = 6 * boundary_act

    out_bytes = [float(input_bytes)] + [float(boundary_act)] * n
    cum_flops = [0.0]
    act_peak = [float(input_bytes)]
    prefix_pb = [0.0]
    emb_bytes = cfg.padded_vocab * d * par_dt
    pb = emb_bytes
    for i in range(n):
        # Each block's own FLOPs and weights (a MoE family's dense leading
        # blocks differ from the rest); the embedding is a gather: 0 FLOPs.
        cum_flops.append(cum_flops[-1] + float(block_flops(cfg, s, i)))
        pb += cfg.block_params(index=i) * par_dt
        prefix_pb.append(pb)
        act_peak.append(float(work))
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


# ---------------------------------------------------------------------------
# Vision-model profile (exact, from meta tensors: the paper's profiling run)
# ---------------------------------------------------------------------------
def _state(module: nn.Module):
    """Parameters and buffers: what the reference's per-layer dict holds."""
    return [*module.parameters(), *module.buffers()]


def tree_bytes(module: nn.Module) -> int:
    return sum(t.numel() * t.element_size() for t in _state(module))


def profile_layered(vm, headroom: float = 0.08) -> LayerProfile:
    """Exact per-layer profile of a ``VisionModel`` with a single synthetic
    sample (paper §5.3: 'a single data sample is sufficient'). Each layer
    runs on ``meta`` copies of its weights, wherever they live."""
    x = torch.empty((1,) + tuple(vm.input_shape), device="meta")
    out_bytes = [float(math.prod(vm.input_shape)) * 4]
    act_peak = [out_bytes[0]]
    cum_flops = [0.0]
    prefix_pb = [0.0]
    running_pb = 0.0
    running_flops = 0.0
    with torch.no_grad():
        for layer in vm.layers:
            meta = {k: torch.empty_like(t, device="meta")
                    for k, t in (*layer.named_parameters(), *layer.named_buffers())}
            nxt = functional_call(layer, meta, (x,))
            layer_bytes = float(nxt.numel() * nxt.element_size())
            running_pb += tree_bytes(layer)
            running_flops += _layer_flops_estimate(layer, x, nxt)
            out_bytes.append(layer_bytes)
            cur = float(x.numel() * 4 + layer_bytes)
            act_peak.append(max(act_peak[-1], cur))  # prefix working-set peak
            cum_flops.append(running_flops)
            prefix_pb.append(running_pb)
            x = nxt

    return LayerProfile(
        name=vm.name,
        n_boundaries=len(vm.layer_names) + 1,
        input_bytes=out_bytes[0],
        out_bytes=out_bytes,
        cum_flops=cum_flops,
        act_peak_bytes=act_peak,
        prefix_param_bytes=prefix_pb,
        model_param_bytes=tree_bytes(vm),
        freeze_index=vm.freeze_index,
        headroom=headroom,
    )


def calibrate_profile(profile: LayerProfile, boundary: int,
                      measured_bytes: float, batch: int) -> LayerProfile:
    """The paper's hybrid calibration (§5.3): compare the static estimate
    against one measured run; any residual 'is assumed to grow
    proportionally with the batch size' and is folded into the per-sample
    activation figures. Always rounds UP (the over-estimation discipline).
    """
    est = profile.memory_estimate(boundary, batch)
    if measured_bytes <= est:
        return profile  # already safely over-estimating
    residual_per_sample = (measured_bytes - profile.prefix_param_bytes[boundary]) / batch
    scale = residual_per_sample / max(profile.act_peak_bytes[boundary], 1.0)
    return dataclasses.replace(
        profile,
        act_peak_bytes=[a * max(scale, 1.0) for a in profile.act_peak_bytes],
    )


def extrapolation_error(profile: LayerProfile, boundary: int,
                        measured_bytes: float, batch: int) -> float:
    """Paper §5.3's reported metric: % error of the batch-extrapolated
    estimate vs a measured run (they report 0.0005%–11.7%)."""
    est = profile.memory_estimate(boundary, batch) / (1 + profile.headroom)
    return 100.0 * abs(est - measured_bytes) / max(measured_bytes, 1.0)


def _layer_flops_estimate(layer: nn.Module, x: torch.Tensor, out: torch.Tensor) -> float:
    """The reference's estimate, quirks included: a layer without weights
    counts its output's elements; one whose own ``w`` is 4-D (a conv) counts
    2 x the output's spatial positions x ``w``'s size; any other counts
    2 x the size of every weight and buffer (BatchNorm's statistics too) x
    the input's positions (its dims between the batch and the last: the
    patch embedding's 224 x 224, the ViT head's 196 tokens)."""
    state = _state(layer)
    if not state:
        return float(out.numel())  # elementwise
    w = getattr(layer, "w", None)
    if w is not None and w.dim() == 4:  # conv
        spatial = out.shape[1] * out.shape[2]
        return float(2 * spatial * w.numel())
    total = sum(2 * t.numel() for t in state)
    seq = math.prod(x.shape[1:-1]) if x.dim() > 2 else 1
    return float(total * seq)
