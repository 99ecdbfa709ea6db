"""Meta-tensor stand-ins for every (arch x shape) cell.

Counterpart of ``repro/launch/specs.py``: the dry-run runs against these,
and nothing here allocates memory. The model is built on the ``meta``
device; its parameters, a batch and a decode cache are meta tensors of the
JAX package's shapes and dtypes (ints as int32).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models.api import build_model
from repro_torch.models.module import dtype_of

META = torch.device("meta")


def meta_model(cfg: ModelConfig) -> nn.Module:
    """The model of ``cfg`` with meta parameters."""
    return build_model(cfg, device=META, generator=torch.Generator())


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Batch stand-ins for the train and prefill kinds."""
    b, s = shape.global_batch, shape.seq_len
    i32 = dict(dtype=torch.int32, device=META)
    cdt = dict(dtype=dtype_of(cfg.compute_dtype), device=META)
    if cfg.family == "encdec":
        return {"frames": torch.empty((b, s, cfg.d_model), **cdt),
                "tokens": torch.empty((b, cfg.dec_seq), **i32),
                "labels": torch.empty((b, cfg.dec_seq), **i32)}
    if cfg.family == "vlm":
        return {"tokens": torch.empty((b, s - cfg.n_patches), **i32),
                "patches": torch.empty((b, cfg.n_patches, cfg.d_model), **cdt),
                "labels": torch.empty((b, s - cfg.n_patches), **i32)}
    return {"tokens": torch.empty((b, s), **i32), "labels": torch.empty((b, s), **i32)}


def decode_specs(model: nn.Module, cfg: ModelConfig, shape: ShapeConfig) -> Tuple:
    """(cache, token, pos) for the decode kinds: one new token against a
    cache of ``seq_len`` positions; ``pos`` is the last one, a host int."""
    b, s = shape.global_batch, shape.seq_len
    cache = model.init_cache(b, s)
    token = torch.empty((b, 1), dtype=torch.int32, device=META)
    return cache, token, s - 1


def param_specs(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{name: meta tensor} of the model's parameters."""
    return {k: torch.empty(p.shape, dtype=p.dtype, device=META)
            for k, p in model.named_parameters()}
