"""Collective helpers: tier-boundary transfer + compressed reductions.

Counterpart of ``repro/distributed/collectives.py``. ``tier_transfer`` is
the storage tier's hop to the compute tier: the split-boundary activations
moved to a target ``torch.device`` (the reference's target sharding),
optionally int8-compressed, with the bytes they put on the wire.

``compressed_psum`` is an error-feedback int8 all-reduce for data-parallel
gradients over a ``torch.distributed`` process group: int8 codes and their
per-128-lane f32 scales cross the wire instead of bf16 values, and the
quantization residual is carried into the next round. The codes come from
``kernels.ops.quantize_int8`` and go back through ``ops.dequantize_int8``,
so a CUDA tensor (an NCCL group) runs the int8 kernels and a CPU tensor (a
gloo group) their plain versions. It needs an initialised process group and
raises without one.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops


def tier_transfer(acts, device: Optional[torch.device] = None, compress: bool = False):
    """Move split-boundary activations from the storage tier to the compute
    tier. ``acts`` is a tensor or an int8 payload ``(q, scales)``; with
    ``compress`` a tensor is quantized first. Returns (payload on
    ``device``, wire bytes: every tensor of the payload)."""
    if compress and not isinstance(acts, tuple):
        acts = ops.quantize_int8(acts)
    leaves = acts if isinstance(acts, tuple) else (acts,)
    wire = sum(x.numel() * x.element_size() for x in leaves)
    if device is not None:
        moved = tuple(x.to(device) for x in leaves)
        acts = moved if isinstance(acts, tuple) else moved[0]
    return acts, wire


def decompress_boundary(acts, dtype: torch.dtype = torch.bfloat16):
    """A ``(q, scales)`` payload dequantized into ``dtype``; anything else
    as it is."""
    if isinstance(acts, tuple) and len(acts) == 2:
        return ops.dequantize_int8(*acts, dtype=dtype)
    return acts


def compressed_psum(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
                    error: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 all-reduce of ``x`` over ``group`` (the default
    group if None). Returns (total, new_error), both in x's dtype.

    q = quant(x + e); total = sum over ranks of dequant(all_gather(q));
    e' = (x + e) - dequant(q), where dequant is into bf16, as the
    reference's. The all-gather moves int8 codes and f32 scales (1/128 of
    them): about 4x fewer bytes than a psum of f32, 2x fewer than of bf16.
    Each rank launches one quantize and one dequantize: its own rows of the
    gathered dequantize are its local dequantize, bit for bit."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("compressed_psum needs an initialised torch.distributed process "
                           "group (init_process_group)")
    carry = x if error is None else x + error
    n = carry.numel()
    flat = F.pad(carry.reshape(-1), (0, (-n) % 128))
    q, scales = ops.quantize_int8(flat[None, :])             # (1, D), (1, D/128)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    qg = [torch.empty_like(q) for _ in range(world)]
    sg = [torch.empty_like(scales) for _ in range(world)]
    dist.all_gather(qg, q, group=group)                      # int8 on the wire
    dist.all_gather(sg, scales, group=group)
    deq = ops.dequantize_int8(torch.stack(qg), torch.stack(sg))   # (N, 1, D) bf16
    local = deq[rank, 0, :n].reshape(carry.shape)
    new_error = carry.float() - local.float()
    total = deq.sum(dim=0)[0, :n].reshape(carry.shape)
    return total.to(x.dtype), new_error.to(x.dtype)
