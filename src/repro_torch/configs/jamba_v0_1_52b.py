"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

Block (scan unit) = one 8-sublayer period: attention at position 3 (paper
fig. 1 places it mid-period), MoE FFN every other sublayer. Jamba uses
mamba-1 (d_state 16); we instantiate the SSD form with N=16.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        n_experts=16,
        top_k=2,
        attn_period=8,
        attn_pos=3,
        moe_every=2,
        ssm_state=16,
        ssm_expand=2,
        ssm_headdim=64,
        ssm_chunk=256,
    )
