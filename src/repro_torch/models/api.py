"""Model registry: config -> model builder dispatch.

Counterpart of ``repro/models/api.py``.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.transformer import LM, build_lm


def build_model(cfg: ModelConfig, *, device="cuda", generator: torch.Generator) -> LM:
    if cfg.family == "encdec":
        raise NotImplementedError("the encoder-decoder family is not ported yet")
    return build_lm(cfg, device=device, generator=generator)
