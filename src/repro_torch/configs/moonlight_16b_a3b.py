"""moonlight-16b-a3b -- Moonlight-16B-A3B at its published widths: the
DeepSeek-V3 block, multi-head latent attention and a sigmoid-routed MoE of 64
dropless experts (6 a token) beside 2 shared ones, the first block dense.
[hf:moonshotai/Moonlight-16B-A3B config.json]

The port's own architecture: the JAX package has no counterpart (its
``moonshot-v1-16b-a3b`` is plain attention with softmax routing).
``q_lora_rank`` is null there: Q is one projection. No ``rope_scaling``.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonlight-16b-a3b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,                  # moe_intermediate_size
        vocab_size=163840,
        rope_theta=5e4,
        norm_eps=1e-5,
        n_experts=64,
        top_k=6,
        router="sigmoid_bias",      # scoring_func sigmoid, topk_method noaux_tc
        routed_scaling_factor=2.446,
        n_shared_experts=2,
        first_k_dense=1,
        d_ff_dense=11264,           # intermediate_size
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    )
