"""mistral-nemo-12b — dense GQA, 128k context.
[hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=131072,
        head_dim=128,           # nemo uses 128 (not d_model / n_heads)
        rope_theta=1e6,         # 128k ctx
    )
