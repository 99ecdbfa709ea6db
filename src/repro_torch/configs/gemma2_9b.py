"""gemma2-9b — local+global alternating attention, logit softcaps.
[arXiv:2408.00118; hf]"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=256000,
        head_dim=256,
        local_global_period=2,
        sliding_window=4096,
        attn_softcap=50.0,
        logit_softcap=30.0,
        tie_embeddings=True,
        rope_theta=1e4,
    )
