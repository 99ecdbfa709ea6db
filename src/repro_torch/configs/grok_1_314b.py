"""grok-1-314b — 314B MoE, 8 experts top-2. [hf:xai-org/grok-1; unverified]

bf16 optimizer states are required to fit a v5e pod (DESIGN.md §2) — set
via TrainConfig(opt_state_dtype="bfloat16") in the launcher for this arch.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b",
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        n_experts=8,
        top_k=2,
        rope_theta=1e4,
    )
