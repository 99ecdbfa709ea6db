"""Serving steps: the prefill and decode functions a server calls.

Counterpart of the serving part of ``repro/train/steps.py``. Each step runs
under ``torch.no_grad``: serving records no graph, and the port's kernels
have no backward. The train steps are not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.transformer import LM


def build_prefill_step(model: LM) -> Callable:
    @torch.no_grad()
    def prefill_step(batch: dict):
        return model.prefill(batch)

    return prefill_step


def build_decode_step(model: LM) -> Callable:
    @torch.no_grad()
    def serve_step(cache, token: torch.Tensor, pos: int):
        return model.decode_step(cache, token, pos)

    return serve_step
