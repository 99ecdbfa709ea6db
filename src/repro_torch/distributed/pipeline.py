"""GPipe-style microbatch pipeline parallelism over a process group.

Counterpart of ``repro/distributed/pipeline.py``. The paper's tier split is
a 2-stage pipeline (feature extraction | training); this module is the
general N-stage machinery, so deeper models can spread their suffix over
more cards.

Each rank of ``group`` is one stage and holds its own group of layers.
Each tick every stage applies its group to its in-flight microbatch, then
the activations rotate one rank downstream (``batch_isend_irecv``, JAX's
``ppermute``). Stage 0 injects microbatch t from the rank that owns it (an
``all_reduce`` of the owner's copy against everyone's zeros, JAX's
``psum``); the last stage commits microbatch ``t - (S - 1)``. After
``n_micro + n_stages - 1`` ticks every microbatch has passed every stage
(bubble fraction (S-1)/(M+S-1)). On a one-rank group the rotation is the
identity.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist


def _rotate(y: torch.Tensor, group, n_stages: int) -> torch.Tensor:
    """y sent one stage downstream; returns what the upstream stage sent."""
    if n_stages == 1:
        return y
    rank = dist.get_rank(group)
    send_to = dist.get_global_rank(group, (rank + 1) % n_stages) if group else \
        (rank + 1) % n_stages
    recv_from = dist.get_global_rank(group, (rank - 1) % n_stages) if group else \
        (rank - 1) % n_stages
    buf = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(), send_to, group),
           dist.P2POp(dist.irecv, buf, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


def pipeline_stages(
    fn: Callable,             # (stage_params, x) -> x, shape-preserving
    n_stages: int,
    n_micro: int,
    group: Optional[dist.ProcessGroup] = None,
) -> Callable:
    """The per-rank body of an N-stage GPipe pipeline over ``group`` (the
    default group if None), which must have ``n_stages`` ranks:

        body = pipeline_stages(stage_fn, S, M, group)
        y = body(my_stage_params, my_micro_x)

    ``my_micro_x`` is this rank's contiguous share of the microbatches,
    (n_micro / n_stages, ...): rank r holds microbatches [r * per, (r + 1)
    * per). The result is the full (n_micro, ...) output in microbatch
    order on every rank (the last stage commits; an all_reduce broadcasts)."""
    assert n_micro % n_stages == 0, (n_micro, n_stages)
    per = n_micro // n_stages
    n_ticks = n_micro + n_stages - 1

    def body(stage_params, micro_x: torch.Tensor) -> torch.Tensor:
        world = dist.get_world_size(group)
        if world != n_stages:
            raise ValueError(f"a pipeline of {n_stages} stages on a group of {world} ranks")
        idx = dist.get_rank(group)
        x_shape = micro_x.shape[1:]
        slot = torch.zeros(x_shape, dtype=micro_x.dtype, device=micro_x.device)
        out = torch.zeros((n_micro,) + x_shape, dtype=micro_x.dtype, device=micro_x.device)
        for t in range(n_ticks):
            # Stage 0 injects microbatch t (owner shard = t // per).
            owner = t // per
            local = min(max(t % per, 0), per - 1)
            injected = micro_x[local].clone() if idx == owner else torch.zeros_like(slot)
            dist.all_reduce(injected, group=group)
            if idx == 0 and t < n_micro:
                slot = injected
            # Every stage applies its layer group.
            y = fn(stage_params, slot)
            # The last stage commits microbatch t - (S - 1).
            done_t = t - (n_stages - 1)
            if idx == n_stages - 1 and done_t >= 0:
                out[done_t] = y.to(out.dtype)
            # Rotate activations downstream.
            slot = _rotate(y, group, n_stages)
        # Only the last stage wrote; broadcast the result.
        dist.all_reduce(out, group=group)
        return out

    return body


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
