"""Dtypes and initializers shared by the port's layers.

Counterpart of ``repro/models/module.py``. Parameters live in
``nn.Module``s; each block is its own module in an ``nn.ModuleList``, so
the stacking helpers of the JAX package have no counterpart here. Of its
remat policies the port has "block" (each block rematerialised, its inputs
alone saved: the default) and "none". ``TrainConfig.remat`` chooses one; the
train steps run the model under ``remat_policy`` of it.
Storage dtype (``param_dtype``) and compute dtype are decoupled as there.
"""
from __future__ import annotations

import contextlib
import math
from typing import Sequence, Union

import torch

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def dense_init(generator: torch.Generator, in_dim: int,
               out_shape: Union[int, Sequence[int]], dtype: torch.dtype,
               device) -> torch.Tensor:
    """Fan-in scaled normal init (LeCun): N(0, 1) / sqrt(in_dim), drawn in f32."""
    out = (out_shape,) if isinstance(out_shape, int) else tuple(out_shape)
    x = torch.randn((in_dim,) + out, generator=generator, device=device,
                    dtype=torch.float32)
    return (x * (1.0 / math.sqrt(in_dim))).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype, device) -> torch.Tensor:
    x = torch.randn((vocab, dim), generator=generator, device=device,
                    dtype=torch.float32)
    return (x * 0.02).to(dtype)


REMAT_POLICIES = ("none", "block")
_REMAT = {"policy": "block"}


def check_remat(name: str) -> str:
    if name not in REMAT_POLICIES:
        raise ValueError(f"remat policy {name!r}: the port has {REMAT_POLICIES}")
    return name


@contextlib.contextmanager
def remat_policy(name: str):
    """The blocks run under ``name`` (a ``TrainConfig.remat``) inside."""
    prev = _REMAT["policy"]
    _REMAT["policy"] = check_remat(name)
    try:
        yield
    finally:
        _REMAT["policy"] = prev


def current_remat() -> str:
    return _REMAT["policy"]
