"""llava-next-mistral-7b — Mistral-7B backbone, anyres patch frontend STUB.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

input_specs() provides precomputed patch embeddings (B, n_patches, d_model);
the vision tower itself is out of scope per the assignment.
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        n_patches=576,
        rope_theta=1e6,
    )
