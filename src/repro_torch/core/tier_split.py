"""TierPlan — the executable form of the paper's technique.

Counterpart of ``repro/core/tier_split.py``. It combines the three
decisions (split index, COS batch size, compression) into two functions:

  * ``extract(frozen, batch)`` — feature extraction of blocks [0, split)
    at *COS batch size* granularity (a loop over microbatches under
    ``torch.no_grad`` — the decoupled batch of §5.5), emitting the
    split-boundary activations, int8-compressed per microbatch when the
    plan compresses (beyond-paper).
  * ``tune_loss(trainable, acts, batch)`` — the training side: the
    remaining blocks and the head, at the *training batch size*.

``make_vision_executor`` is the storage tier's executor of a paper vision
model (``models/vision.py``), in the form the COS server registers
(``HapiServer.register_executor`` in the reference): an object's images in
microbatches of the COS batch through the prefix on the card, each
microbatch's boundary int8-quantized there when the request compresses, and
the result back on the host as numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import HapiConfig, ModelConfig, ShapeConfig
from repro_torch.core.batch_adapt import AdaptRequest, adapt_batches
from repro_torch.core.profiler import LayerProfile, profile_lm
from repro_torch.core.splitter import SplitDecision, choose_split
from repro_torch.distributed.autoshard import cat_rows, chunk_rows
from repro_torch.kernels import ops
from repro_torch.models.module import dtype_of
from repro_torch.models.transformer import Prefix, Suffix
from repro_torch.obs.program import METRICS, TRACER, count_copy

# What extract() emits: the activations, or int8 codes and their f32 scales.
Acts = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]


@dataclass(frozen=True)
class TierPlan:
    split: int
    cos_batch: int            # samples per extraction microbatch
    compress: bool
    decision: SplitDecision


def largest_divisor_leq(n: int, cap: int) -> int:
    cap = max(1, min(cap, n))
    for d in range(cap, 0, -1):
        if n % d == 0:
            return d
    return 1


def plan_tiers(
    cfg: ModelConfig,
    shape: ShapeConfig,
    hapi: HapiConfig,
    *,
    profile: Optional[LayerProfile] = None,
    local_batch: Optional[int] = None,
) -> TierPlan:
    """Profile -> Alg. 1 split -> Eq. 4 batch adaptation -> TierPlan."""
    prof = profile or profile_lm(cfg, shape.seq_len, hapi.memory_headroom)
    decision = choose_split(prof, hapi, shape.global_batch)
    split = decision.split_index

    b = local_batch or shape.global_batch
    if split > 0:
        req = AdaptRequest(
            req_id=0,
            mem_per_sample=prof.act_peak_bytes[split] * (1 + prof.headroom),
            mem_model=prof.prefix_param_bytes[split],
            b_max=min(b, hapi.cos_batch),
        )
        res = adapt_batches([req], hapi.cos_hbm_budget, b_min=hapi.cos_batch_min)
        adapted = res.assignments[0].batch if res.assignments else hapi.cos_batch_min
    else:
        adapted = b
    cos_batch = largest_divisor_leq(b, adapted)
    return TierPlan(split=split, cos_batch=cos_batch,
                    compress=hapi.compress_transfer, decision=decision)


# ---------------------------------------------------------------------------
# Executable halves
# ---------------------------------------------------------------------------
def _microbatches(batch: dict, mb: int):
    """Microbatches of ``mb`` samples; a batch of DTensors is cut on each
    rank's local rows (``autoshard.chunk_rows``), ``mb`` counting the
    microbatch's samples over all ranks."""
    lead = next(iter(batch.values())).shape[0]
    if lead % mb:
        raise ValueError(f"batch of {lead} does not split into microbatches of {mb}")
    parts = {k: chunk_rows(v, lead // mb) for k, v in batch.items()}
    for i in range(lead // mb):
        yield {k: v[i] for k, v in parts.items()}


def make_extract_fn(plan: TierPlan) -> Callable[[Prefix, dict], Acts]:
    """Feature extraction at COS-batch granularity (frozen => no grads).
    Traced, a call is a ``train.extract`` span (a root where the storage
    tier calls it alone) over its microbatches' ``extract.prefix`` and
    ``extract.quantize``; the slicing and the final concatenation are its
    self time, and its payload counts in ``wire_bytes_total``."""
    tr, mx = TRACER, METRICS

    def extract(frozen: Prefix, batch: dict) -> Acts:
        outs = []
        with tr.span("train.extract", batch), torch.no_grad():
            for mb in _microbatches(batch, plan.cos_batch):
                with tr.span("extract.prefix", mb):
                    acts = frozen(mb)
                if plan.compress:
                    with tr.span("extract.quantize", acts):
                        acts = ops.quantize_int8(acts)
                outs.append(acts)
                if tr.enabled:
                    mx.inc("microbatches_total")
            if plan.compress:
                out = (cat_rows([q for q, _ in outs]), cat_rows([s for _, s in outs]))
            else:
                out = cat_rows(outs)
        if tr.enabled:
            mx.inc("wire_bytes_total", wire_bytes(out))
        return out

    return extract


def make_tune_loss_fn(plan: TierPlan) -> Callable[[Suffix, Acts, dict], torch.Tensor]:
    def tune_loss(trainable: Suffix, acts: Acts, batch: dict) -> torch.Tensor:
        if plan.compress:
            q, scales = acts
            # Dequantize straight into the model's compute dtype.
            acts = ops.dequantize_int8(q, scales, dtype=dtype_of(trainable.cfg.compute_dtype))
        return trainable.loss(acts, batch)

    return tune_loss


def wire_bytes(acts: Acts) -> int:
    """Actual bytes this activation payload puts on the bottleneck link."""
    leaves = acts if isinstance(acts, tuple) else (acts,)
    return sum(x.numel() * x.element_size() for x in leaves)


def make_vision_executor(vm, *, compress: bool, device="cuda") -> Callable:
    """``fn(payload, split, cos_batch)`` for ``register_executor``: the
    prefix [0, split) of ``vm`` (which must live on ``device``) over
    ``payload["x"]`` (numpy NHWC float32) in microbatches of ``cos_batch``
    images, without gradients. Returns numpy on the host: the float32
    boundary activations, or with ``compress`` the int8 codes and float32
    scales of ``kernels/ops.quantize_int8`` on each microbatch's boundary.
    Each image's result depends on that image alone, not on ``cos_batch``.
    The server counts int8 leaves as the measured wire. Traced, a call is an
    ``executor.request`` span over each microbatch's ``executor.copy_in``,
    ``extract.prefix`` and ``extract.quantize`` and the final
    ``executor.copy_out``."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    tr, mx = TRACER, METRICS

    def execute(payload: dict, split: int, cos_batch: int):
        x = payload["x"]
        outs = []
        with tr.span("executor.request", x, dev), torch.no_grad():
            for lo in range(0, len(x), cos_batch):
                part = x[lo:lo + cos_batch]
                with tr.span("executor.copy_in", part, dev):
                    host = torch.from_numpy(np.ascontiguousarray(part, dtype=np.float32))
                    mb = host.to(dev)
                with tr.span("extract.prefix", mb):
                    acts = vm.apply_range(mb, 0, split).contiguous()
                if compress:
                    with tr.span("extract.quantize", acts):
                        acts = ops.quantize_int8(acts)
                outs.append(acts)
                if tr.enabled:
                    mx.inc("microbatches_total")
                    if on_card:
                        count_copy("h2d_bytes_total", [host])
            with tr.span("executor.copy_out", where=dev):
                if compress:
                    back = [torch.cat([q for q, _ in outs]).cpu(),
                            torch.cat([s for _, s in outs]).cpu()]
                else:
                    back = [torch.cat(outs).cpu()]
                out = tuple(h.numpy() for h in back)
        if tr.enabled:
            mx.inc("wire_bytes_total", sum(h.nbytes for h in back))
            if on_card:
                count_copy("d2h_bytes_total", back)
        return out if compress else out[0]

    return execute
