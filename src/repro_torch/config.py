"""Configuration of the PyTorch port.

A copy of the parts of ``repro/config.py`` that the pushdown, serving and
training paths read (the port imports nothing of ``repro``):
  * ``ModelConfig``   — one per architecture (see ``repro_torch.configs``).
  * ``ShapeConfig``   — the input shape of a job.
  * ``SHAPES``        — the dry-run's four input shapes, and
    ``cell_is_runnable`` for the (arch x shape) matrix.
  * ``MeshSpec``      — a device mesh as plain data (``launch/mesh.py`` builds
    the ``DeviceMesh``); ``SINGLE_POD`` and ``MULTI_POD`` are the production
    meshes.
  * ``HapiConfig``    — knobs of the paper's technique (split/batch-adapt).
  * ``TrainConfig``   — optimizer and step settings; ``RunConfig`` joins them.
  * ``HW``            — NVIDIA H100 SXM roofline constants.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


# ---------------------------------------------------------------------------
# Hardware constants (NVIDIA H100 SXM, one card) — the roofline denominators.
# NVIDIA's data sheet, dense rates at the full 700 W power limit.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HardwareSpec:
    name: str = "h100-sxm"
    peak_flops_bf16: float = 989e12          # FLOP/s, tensor cores, dense
    peak_flops_f32: float = 67e12            # FLOP/s, outside the tensor cores
    peak_flops_tf32: float = 495e12          # FLOP/s, tensor cores, dense
    hbm_bandwidth: float = 3.35e12           # bytes/s
    hbm_capacity: float = 80e9               # bytes
    # The collective and cross-tier terms' rates, one direction of a card's
    # links. NVLink 4 inside an 8-card node: 900 GB/s bidirectional per SXM
    # card (NVIDIA's H100 data sheet). Between nodes: one 400 Gb/s NDR
    # InfiniBand port per card, as in a DGX H100 (NVIDIA's DGX H100 data sheet).
    nvlink_bandwidth: float = 450e9          # bytes/s
    ib_bandwidth: float = 50e9               # bytes/s
    cards_per_node: int = 8


HW = HardwareSpec()


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # --- attention options -------------------------------------------------
    head_dim: Optional[int] = None           # default: d_model // n_heads
    qk_norm: bool = False                    # qwen3
    qkv_bias: bool = False                   # qwen1.5
    attn_softcap: Optional[float] = None     # gemma2 (50.0)
    logit_softcap: Optional[float] = None    # gemma2 (30.0)
    sliding_window: Optional[int] = None     # gemma2 local layers (4096)
    local_global_period: int = 0             # gemma2: 2 -> alternate local/global
    rope_theta: float = 1e4

    # --- mixture of experts -------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # DeepSeek-V3's MoE (Moonlight): the router ("softmax": top-k of a
    # softmax; "sigmoid_bias": top-k of sigmoid scores plus a frozen f32
    # correction bias, the chosen scores renormalised and scaled by
    # ``routed_scaling_factor``, over experts that drop no token), shared experts
    # of ``d_ff`` each beside the routed ones, and ``first_k_dense`` leading
    # blocks whose FFN is a SwiGLU MLP of width ``d_ff_dense``.
    router: str = "softmax"
    routed_scaling_factor: float = 1.0
    n_shared_experts: int = 0
    first_k_dense: int = 0
    d_ff_dense: int = 0

    # --- multi-head latent attention (DeepSeek-V2/V3, Moonlight) -------------
    # On where kv_lora_rank > 0: K and V come out of a normed latent of that
    # width, each head's Q.K dim is qk_nope_head_dim + qk_rope_head_dim (the
    # rope part of K one head shared by all), V's is v_head_dim.
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- state-space (mamba2 / jamba) ----------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # --- hybrid (jamba) -------------------------------------------------------
    attn_period: int = 0                     # 1 attention layer per period
    attn_pos: int = 3                        # position of attn inside period
    moe_every: int = 0                       # MoE FFN every k-th sublayer

    # --- encoder-decoder (whisper) -------------------------------------------
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    dec_seq: int = 256                       # transcript length for enc-dec cells

    # --- multimodal (llava) ---------------------------------------------------
    n_patches: int = 0                       # patch embeddings prepended (stub frontend)

    # --- transfer-learning structure (the paper's object of study) -----------
    freeze_frac: float = 0.75                # freeze index = round(frac * n_blocks)

    # --- numerics -------------------------------------------------------------
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    vocab_pad_to: int = 512                  # pad vocab for clean TP sharding

    # -----------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.router not in ("softmax", "sigmoid_bias"):
            raise ValueError(f"unknown router {self.router!r}")

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        """Each head's Q.K dim: ``hdim``, or MLA's nope and rope parts."""
        return self.qk_nope_head_dim + self.qk_rope_head_dim if self.is_mla else self.hdim

    def dense_block(self, i: int) -> bool:
        """Block ``i`` of a MoE family has a SwiGLU MLP, not a MoE."""
        return i < self.first_k_dense

    @property
    def hdim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    # --- block structure (split-candidate granularity) ----------------------
    @property
    def n_blocks(self) -> int:
        """Number of blocks. Split candidates live at block boundaries."""
        if self.family == "encdec":
            return self.n_enc_layers  # splitting happens in the encoder prefix
        if self.local_global_period:
            return self.n_layers // self.local_global_period
        if self.attn_period:
            return self.n_layers // self.attn_period
        return self.n_layers

    @property
    def layers_per_block(self) -> int:
        if self.local_global_period:
            return self.local_global_period
        if self.attn_period:
            return self.attn_period
        return 1

    @property
    def freeze_index(self) -> int:
        """Block index separating feature extraction from training (paper §2.3)."""
        return max(1, min(self.n_blocks - 1, round(self.freeze_frac * self.n_blocks)))

    # --- analytic parameter counts -------------------------------------------
    def _attn_params(self) -> int:
        if self.is_mla:
            h, r, dr = self.n_heads, self.kv_lora_rank, self.qk_rope_head_dim
            q = self.d_model * h * self.qk_head_dim
            kv = self.d_model * (r + dr) + r + r * h * (self.qk_nope_head_dim + self.v_head_dim)
            return q + kv + h * self.v_head_dim * self.d_model
        hd = self.hdim
        q = self.d_model * self.n_heads * hd
        kv = 2 * self.d_model * self.n_kv_heads * hd
        o = self.n_heads * hd * self.d_model
        b = (self.n_heads + 2 * self.n_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _dense_ffn_params(self, width: int = 0) -> int:
        # gated (SwiGLU-style): up, gate, down
        return 3 * self.d_model * (width or self.d_ff)

    def _moe_ffn_params(self, active: bool) -> int:
        per_expert = 3 * self.d_model * self.d_ff
        router = self.d_model * self.n_experts
        n = self.top_k if active else self.n_experts
        shared = self.n_shared_experts * per_expert
        bias = self.n_experts if self.router == "sigmoid_bias" else 0
        return n * per_expert + router + shared + bias

    def _ssm_params(self) -> int:
        di, ns, nh = self.d_inner, self.ssm_state, self.ssm_nheads
        in_proj = self.d_model * (2 * di + 2 * ns + nh)  # z, x, B, C, dt
        conv = self.conv_width * (di + 2 * ns)
        out = di * self.d_model
        extra = nh * 3  # A_log, D, dt_bias
        return in_proj + conv + out + extra

    def block_params(self, active_only: bool = False, index: Optional[int] = None) -> int:
        """Params of one block (all sublayers inside it): block ``index`` where
        the blocks differ (a MoE family's dense leading blocks), else any."""
        d = self.d_model
        norm = 2 * d  # two norms per sublayer (approx, pre-norm archs)
        if self.family == "moe" and index is not None and self.dense_block(index):
            return self._attn_params() + self._dense_ffn_params(self.d_ff_dense) + norm
        if self.local_global_period:
            # gemma2: one block == one (local, global) pair.
            per = self._attn_params() + self._dense_ffn_params() + norm
            return per * self.local_global_period
        if self.family in ("dense", "vlm"):
            return self._attn_params() + self._dense_ffn_params() + norm
        if self.family == "moe":
            return self._attn_params() + self._moe_ffn_params(active_only) + norm
        if self.family == "ssm":
            return self._ssm_params() + norm
        if self.family == "hybrid":
            total = 0
            for i in range(self.attn_period):
                mixer = self._attn_params() if i == self.attn_pos else self._ssm_params()
                if self.moe_every and (i % self.moe_every == 1):
                    ffn = self._moe_ffn_params(active_only)
                else:
                    ffn = self._dense_ffn_params()
                total += mixer + ffn + norm
            return total
        if self.family == "encdec":
            # one encoder layer (self-attn + ffn); decoder counted separately
            return self._attn_params() + self._dense_ffn_params() + norm
        raise ValueError(self.family)

    def param_count(self, active_only: bool = False) -> int:
        emb = self.padded_vocab * self.d_model
        head = emb if not self.tie_embeddings else 0
        body = sum(self.block_params(active_only, i) for i in range(self.n_blocks))
        if self.family == "encdec":
            dec = self.n_dec_layers * (
                2 * self._attn_params() + self._dense_ffn_params() + 3 * self.d_model
            )
            body += dec
        return emb + head + body + self.d_model  # final norm


# ---------------------------------------------------------------------------
# Input shape
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# Archs allowed to run long_500k (sub-quadratic / O(1)-state decode).
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def cell_is_runnable(model: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether an (arch x shape) cell runs or is a documented skip."""
    if shape.name == "long_500k":
        return model.family in LONG_CONTEXT_FAMILIES
    return True


# ---------------------------------------------------------------------------
# Mesh specification
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MeshSpec:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return math.prod(self.shape)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a in ("pod", "data"))

    @property
    def model_axis(self) -> str:
        return "model"

    def axis_size(self, name: str) -> int:
        return self.shape[self.axes.index(name)]


SINGLE_POD = MeshSpec((16, 16), ("data", "model"))
MULTI_POD = MeshSpec((2, 16, 16), ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# Hapi (paper technique) configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class HapiConfig:
    enabled: bool = True
    # Splitting algorithm (paper §5.4): C = bandwidth * window_s.
    network_bandwidth: float = 1e9 / 8        # bytes/s (paper default: 1 Gbps)
    window_s: float = 1.0
    # Batch adaptation (paper §5.5).
    cos_batch: int = 200                      # default COS batch size
    # b_r_min. The paper uses 25; 32 was chosen for the TPU's 8-row sublane
    # tiling and is kept so that both packages plan alike.
    cos_batch_min: int = 32
    cos_hbm_budget: float = HW.hbm_capacity   # per-card budget on the storage tier
    memory_headroom: float = 0.08             # over-estimation discipline (paper §5.3)
    # POST request granularity (paper: 1000 images per request).
    request_size: int = 1024                  # samples per POST request
    # Beyond-paper: compress split activations crossing the tier boundary.
    compress_transfer: bool = False           # int8 per-tile quantization
    # Beyond-paper: split candidates are block boundaries (always on).
    collective_aware: bool = True


# ---------------------------------------------------------------------------
# Training configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    microbatch: int = 0                       # 0 -> whole per-device batch at once
    remat: str = "block"                      # none | block
    opt_state_dtype: str = "float32"          # grok overrides to bfloat16
    zero_sharding: bool = True                # shard optimizer states over data axis
    seed: int = 0


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshSpec = SINGLE_POD
    hapi: HapiConfig = field(default_factory=HapiConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
