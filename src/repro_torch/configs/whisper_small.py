"""whisper-small — encoder-decoder, conv/mel frontend STUB.
[arXiv:2212.04356; unverified]

12 attention heads are not divisible by the 16-way model axis — heads are
replicated and the MLP is tensor-parallel (graceful sharding rule,
DESIGN.md §4).
"""
from repro_torch.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        n_layers=12,
        n_enc_layers=12,
        n_dec_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        dec_seq=256,
        norm_eps=1e-5,
    )
