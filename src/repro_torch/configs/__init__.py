"""Architecture registry — the 10 assigned archs (+ paper vision models),
and the port's own architectures.

``get_config(arch_id)`` returns the exact published configuration;
``get_smoke_config(arch_id)`` returns a reduced same-family variant for
CPU smoke tests (small width/depth/experts/vocab — structure preserved).
``ARCH_IDS`` are the JAX package's ten, which the parity tests iterate;
``PORT_ARCH_IDS`` the port's alone (no JAX counterpart): Moonlight's
DeepSeek-V3 block.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.config import ModelConfig

from repro_torch.configs import (  # noqa: E402
    moonshot_v1_16b_a3b,
    grok_1_314b,
    mistral_nemo_12b,
    gemma2_9b,
    qwen3_32b,
    qwen1_5_110b,
    mamba2_1_3b,
    llava_next_mistral_7b,
    whisper_small,
    jamba_v0_1_52b,
    moonlight_16b_a3b,
)

_MODULES = {
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b,
    "grok-1-314b": grok_1_314b,
    "mistral-nemo-12b": mistral_nemo_12b,
    "gemma2-9b": gemma2_9b,
    "qwen3-32b": qwen3_32b,
    "qwen1.5-110b": qwen1_5_110b,
    "mamba2-1.3b": mamba2_1_3b,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "whisper-small": whisper_small,
    "jamba-v0.1-52b": jamba_v0_1_52b,
}

ARCH_IDS: List[str] = list(_MODULES)

_PORT_MODULES = {
    "moonlight-16b-a3b": moonlight_16b_a3b,
}

PORT_ARCH_IDS: List[str] = list(_PORT_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    return {**_MODULES, **_PORT_MODULES}[arch_id].config()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def get_smoke_config(arch_id: str) -> ModelConfig:
    """Reduced config of the same family for 1-device CPU smoke tests."""
    cfg = get_config(arch_id)
    kw = dict(
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        vocab_pad_to=64,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.is_mla:
        # Moonlight: the dense block and two MoE blocks, latent attention at
        # Q.K dim 24 (16 + 8) and V dim 16, 8 routed experts (2 a token)
        # beside 2 shared ones.
        kw.update(n_layers=3, n_kv_heads=4, head_dim=None, d_ff=32, d_ff_dense=128,
                  n_experts=8, top_k=2, kv_lora_rank=32, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16)
    elif cfg.family == "moe":
        kw.update(n_layers=2, n_experts=8, top_k=2, capacity_factor=8.0)
    elif cfg.family == "ssm":
        kw.update(n_layers=2, ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    elif cfg.family == "hybrid":
        kw.update(
            n_layers=8, attn_period=4, attn_pos=1, moe_every=2,
            n_experts=4, top_k=2, capacity_factor=8.0, ssm_state=16,
            ssm_headdim=16, ssm_chunk=16,
        )
    elif cfg.family == "encdec":
        kw.update(n_layers=2, n_enc_layers=2, n_dec_layers=2, dec_seq=8,
                  n_kv_heads=4)
    elif cfg.family == "vlm":
        kw.update(n_layers=2, n_patches=8)
    elif cfg.local_global_period:
        kw.update(n_layers=4, sliding_window=16)
    else:
        kw.update(n_layers=2)
    return dataclasses.replace(cfg, **kw)
