"""Model registry: config -> model builder dispatch.

Counterpart of ``repro/models/api.py``: the encoder-decoder family goes to
``models/encdec.py``, every other family to ``models/transformer.py``.
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.encdec import EncDec, build_encdec
from repro_torch.models.transformer import LM, build_lm


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator) -> Union[LM, EncDec]:
    if cfg.family == "encdec":
        return build_encdec(cfg, device=device, generator=generator)
    return build_lm(cfg, device=device, generator=generator)
