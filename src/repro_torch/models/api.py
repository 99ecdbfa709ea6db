"""Model registry: config -> model builder dispatch.

Counterpart of ``repro/models/api.py``: the encoder-decoder family goes to
``models/encdec.py``, every other family to ``models/transformer.py``.
``merge_params`` joins a frozen prefix and a trainable suffix back into a
model with the merge of their own family.
"""
from __future__ import annotations

from typing import Union

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.encdec import EncDec, build_encdec
from repro_torch.models.transformer import LM, build_lm


def build_model(cfg: ModelConfig, *, device="cuda",
                generator: torch.Generator) -> Union[LM, EncDec]:
    if cfg.family == "encdec":
        return build_encdec(cfg, device=device, generator=generator)
    return build_lm(cfg, device=device, generator=generator)


def merge_params(frozen: nn.Module, trainable: nn.Module) -> Union[LM, EncDec]:
    """The whole model of ``split_params``' two halves, sharing their
    parameters."""
    if frozen.cfg.family == "encdec":
        return encdec.merge_params(frozen, trainable)
    return transformer.merge_params(frozen, trainable)
