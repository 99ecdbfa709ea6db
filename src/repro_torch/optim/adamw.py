"""AdamW with a weight-decay mask, a warmup-cosine schedule, global-norm
clipping and a configurable state dtype.

Counterpart of ``repro/optim/adamw.py``, written by hand on tensors (not
``torch.optim.AdamW``). Parameters, gradients and the moments are dicts from
the trainable module's state_dict names to tensors. The arithmetic is the
JAX function's: gradients clipped in f32, both moments and the bias
corrections in f32, the moments stored in ``opt_state_dtype``, the update
computed in f32 and written in the parameter's dtype. Where the JAX function
returns new arrays, ``adamw_update`` updates the parameters and the moments
in place, which keeps one copy of each on the device. ZeRO sharding of the
states waits for the collectives slice.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.module import dtype_of

Tensors = Dict[str, torch.Tensor]


class OptState(NamedTuple):
    m: Tensors
    v: Tensors
    step: torch.Tensor   # int32 scalar on the parameters' device


# The JAX trees' block stacks: the LMs' blocks, the encoder-decoder's two.
STACKED = ("blocks", "enc_blocks", "dec_blocks")


def jax_path(name: str) -> Tuple[str, bool]:
    """The JAX tree path of a state_dict name ("blocks.3.sub0.attn.wq" ->
    "blocks/sub0/attn/wq") and whether the leaf is stacked over the blocks
    there, which gives it one more axis than it has in the port."""
    parts = name.split(".")
    if parts[0] in STACKED:
        return "/".join([parts[0], *parts[2:]]), True
    return "/".join(parts), False


def _decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """No weight decay on norms/biases/scalars (rank < 2 or norm-ish names),
    by the leaf's rank in the JAX tree: a per-block vector such as mamba2's
    ``A_log`` (H,) is (n_blocks, H) there, rank 2, and is decayed."""
    out = {}
    for name, x in params.items():
        path, stacked = jax_path(name)
        rank = x.dim() + int(stacked)
        out[name] = 0.0 if rank < 2 or any(t in path for t in ("norm", "scale", "bias", "ln")) \
            else 1.0
    return out


def init_opt_state(params: Mapping[str, torch.Tensor], tc: TrainConfig) -> OptState:
    dt = dtype_of(tc.opt_state_dtype)
    device = next(iter(params.values())).device
    return OptState(m={k: torch.zeros(p.shape, dtype=dt, device=p.device)
                       for k, p in params.items()},
                    v={k: torch.zeros(p.shape, dtype=dt, device=p.device)
                       for k, p in params.items()},
                    step=torch.zeros((), dtype=torch.int32, device=device))


def lr_schedule(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    """Linear warmup, then cosine to a floor of 0.1 of the peak, in f32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tc.warmup_steps) / max(tc.total_steps - tc.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    norms = torch._foreach_norm([t.to(torch.float32) for t in tensors.values()])
    return torch.sqrt(sum(n.square() for n in norms))


def adamw_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 opt: OptState, tc: TrainConfig):
    """One AdamW step on ``params`` in place. Returns (params, new OptState,
    metrics) with the moments updated in place and a new step count."""
    step = opt.step + 1
    lr = lr_schedule(step, tc)
    gnorm = global_norm(grads)
    clip = torch.clamp(tc.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0) \
        if tc.grad_clip else 1.0
    decay = _decay_mask(params)
    b1, b2 = tc.beta1, tc.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    with torch.no_grad():
        for name, p in params.items():
            g = grads[name].to(torch.float32) * clip
            m, v = opt.m[name], opt.v[name]
            # .to() is the tensor itself for f32 moments, so these update in place.
            m32 = m.to(torch.float32).mul_(b1).add_(g, alpha=1 - b1)
            v32 = v.to(torch.float32).mul_(b2).addcmul_(g, g, value=1 - b2)
            delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(tc.eps))
            if tc.weight_decay * decay[name]:
                delta.add_(p.to(torch.float32), alpha=tc.weight_decay * decay[name])
            p.copy_(p.to(torch.float32).sub_(delta.mul_(lr)))
            m.copy_(m32)
            v.copy_(v32)
    return params, OptState(opt.m, opt.v, step), {"lr": lr, "grad_norm": gnorm}
