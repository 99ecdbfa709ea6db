"""Step functions: the Hapi fine-tune step, the status-quo baseline, the two
tier steps, the forward step, and serving's prefill and decode steps.

Counterpart of ``repro/train/steps.py``. The Hapi train step is the paper's
pipeline in one call:
  1. extract: frozen prefix at *COS batch* granularity (a loop over
     microbatches under ``torch.no_grad``, optional int8 boundary
     compression) — §5.5's decoupled batch;
  2. tune: remaining blocks + head, gradients accumulated in f32 over the
     chunks of the training batch and divided by their number, then AdamW on
     the trainable part only.

The baseline step is the paper's status quo: one pass, one batch
granularity, frozen prefix still excluded from grads.

A ``TrainState`` holds the frozen ``Prefix`` and the trainable ``Suffix``
modules (which share no parameter) and the optimizer state. Where the JAX
steps return a new state, these update the trainable parameters and the
moments in place and return a state that holds them. The functions that
make the train steps take the model, as the JAX ones do, but the steps run
the state's modules. Gradients come from ``torch.autograd.grad``, so no
``.grad`` is left on a parameter. The serving steps run under
``torch.no_grad``.

With the program's tracer on (``repro_torch.obs.program``) a Hapi step is the
span tree ``train.step`` -> ``train.extract`` per extraction (its microbatches'
``extract.prefix`` and ``extract.quantize`` inside), ``train.tune`` per chunk
and ``train.adamw``; the compute tier's ``tune_step`` is a ``train.step`` of
its own. The Hapi step looks ``make_extract_fn`` and ``adamw_update`` up in
this module at each call, so a caller may wrap them.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.config import RunConfig
from repro_torch.distributed.autoshard import chunk_rows
from repro_torch.core.tier_split import Acts, TierPlan, make_extract_fn, make_tune_loss_fn
from repro_torch.models.api import merge_params
from repro_torch.models.module import check_remat, remat_policy
from repro_torch.models.transformer import LM, Prefix, Suffix
from repro_torch.obs.program import METRICS, TRACER
from repro_torch.optim.adamw import OptState, adamw_update, init_opt_state


class TrainState(NamedTuple):
    frozen: Prefix      # feature-extraction prefix (never updated)
    trainable: Suffix   # suffix and head
    opt: OptState


def init_train_state(model: LM, rc: RunConfig, plan: TierPlan) -> TrainState:
    """Split ``model`` (already initialised) at the plan's split; the frozen
    part stops requiring grad."""
    frozen, trainable = model.split_params(plan.split)
    frozen.requires_grad_(False)
    return TrainState(frozen, trainable,
                      init_opt_state(dict(trainable.named_parameters()), rc.train))


def _chunks(tree, n_chunks: int) -> Iterator:
    """``n_chunks`` equal slices of every tensor of a batch dict, an int8
    payload tuple or a tensor, along the leading axis (``chunk_rows``: a
    DTensor on each rank's local rows)."""
    if isinstance(tree, dict):
        parts = {k: chunk_rows(v, n_chunks) for k, v in tree.items()}
        for i in range(n_chunks):
            yield {k: v[i] for k, v in parts.items()}
    elif isinstance(tree, tuple):
        yield from zip(*(chunk_rows(x, n_chunks) for x in tree))
    else:
        yield from chunk_rows(tree, n_chunks)


def _accumulate(tune, trainable: Suffix, params: Dict[str, torch.Tensor],
                chunks, constrain: Optional[Callable] = None,
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Sum of the chunks' gradients in f32, divided by their number, and the
    mean loss. ``constrain(tree, "grads")`` places the accumulator and each
    chunk's gradients (ZeRO-sharded in the dry-run)."""
    tr, mx = TRACER, METRICS
    grads = {k: torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
             for k, p in params.items()}
    if constrain is not None:
        grads = constrain(grads, "grads")
    loss_sum, n_chunks = 0.0, 0
    for acts, bt in chunks:
        with tr.span("train.tune", bt):
            loss = tune(trainable, acts, bt)
            step = torch.autograd.grad(loss, list(params.values()))
            if constrain is not None:
                step = constrain(dict(zip(params, step)), "grads").values()
            for acc, g in zip(grads.values(), step):
                acc.add_(g)
            loss_sum = loss_sum + loss.detach()
        n_chunks += 1
        if tr.enabled:
            mx.inc("chunks_total")
    for g in grads.values():
        g.div_(n_chunks)
    return grads, loss_sum / n_chunks


@contextlib.contextmanager
def _running(tc, constrain: Optional[Callable] = None):
    """A train step's model under ``tc.remat``. Where a step is given a
    ``constrain`` hook its tensors may be DTensors: plain tensors the model
    makes (positions, masks) then join them as replicated."""
    with remat_policy(tc.remat), (implicit_replication() if constrain is not None
                                  else contextlib.nullcontext()):
        yield


def build_hapi_train_step(model: LM, rc: RunConfig, plan: TierPlan, *,
                          constrain: Optional[Callable] = None) -> Callable:
    """(state, batch) -> (state, metrics). ``constrain(tree, kind)`` may
    place the boundary activations (kind "acts": a tensor or an int8
    payload) and the gradients (kind "grads": a dict by name) on a mesh."""
    tune = make_tune_loss_fn(plan)
    tc = rc.train
    check_remat(tc.remat)
    tr, mx = TRACER, METRICS

    def train_step(state: TrainState, batch: dict):
        with tr.span("train.step", batch), _running(tc, constrain):
            out = _train_step(state, batch)
        if tr.enabled:
            mx.inc("steps_total")
        return out

    def _train_step(state: TrainState, batch: dict):
        b = next(iter(batch.values())).shape[0]
        cos_b = min(plan.cos_batch, b)          # §5.5: the adapted COS batch
        micro = min(tc.microbatch or b, b)      # grad-accumulation chunk
        extract = make_extract_fn(TierPlan(plan.split, cos_b, plan.compress, plan.decision))
        params = dict(state.trainable.named_parameters())
        acts_of = (lambda a: constrain(a, "acts")) if constrain else (lambda a: a)
        if cos_b <= micro:
            # Fused path: extract chunk -> grad on chunk -> accumulate. One
            # chunk's boundary activations live at a time.
            chunks = ((acts_of(extract(state.frozen, bt)), bt)
                      for bt in _chunks(batch, max(1, b // cos_b)))
        else:
            # Coarse-extraction path (batch adaptation granted a big COS
            # batch): extract at cos_b, then accumulate over micro chunks of
            # the stored activations.
            n_chunks = max(1, b // micro)
            chunks = ((acts_of(a), bt) for a, bt in zip(
                _chunks(acts_of(extract(state.frozen, batch)), n_chunks),
                _chunks(batch, n_chunks)))
        grads, loss = _accumulate(tune, state.trainable, params, chunks, constrain)
        with tr.span("train.adamw", where=grads):
            _, new_opt, om = adamw_update(params, grads, state.opt, tc)
        return TrainState(state.frozen, state.trainable, new_opt), {"loss": loss, **om}

    return train_step


def build_baseline_train_step(model: LM, rc: RunConfig, split: int) -> Callable:
    """Status quo (paper Fig. 5a): full model, training-batch granularity,
    grads on the trainable suffix only."""
    tc = rc.train
    check_remat(tc.remat)

    def train_step(state: TrainState, batch: dict):
        params = dict(state.trainable.named_parameters())
        with _running(tc):
            loss = merge_params(state.frozen, state.trainable).loss(batch)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        _, new_opt, om = adamw_update(params, grads, state.opt, tc)
        return TrainState(state.frozen, state.trainable, new_opt), \
            {"loss": loss.detach(), **om}

    return train_step


def build_tier_steps(model: LM, rc: RunConfig, plan: TierPlan, *,
                     constrain: Optional[Callable] = None):
    """The two-program tier split (paper Fig. 8): ``extract_step`` runs on
    the storage tier, ``tune_step`` on the compute tier; the returned
    activations cross the link between them (optionally int8).
    ``constrain(tree, "grads")`` places the gradients, as in
    ``build_hapi_train_step``."""
    tc = rc.train
    check_remat(tc.remat)
    extract = make_extract_fn(plan)
    tune = make_tune_loss_fn(plan)
    tr, mx = TRACER, METRICS

    def extract_step(frozen: Prefix, batch: dict) -> Acts:
        with _running(tc, constrain):
            return extract(frozen, batch)

    def tune_step(trainable: Suffix, opt: OptState, acts: Acts, batch: dict):
        b = next(iter(batch.values())).shape[0]
        n_chunks = max(1, b // min(tc.microbatch or b, b))
        params = dict(trainable.named_parameters())
        with tr.span("train.step", batch), _running(tc, constrain):
            grads, loss = _accumulate(tune, trainable, params,
                                      zip(_chunks(acts, n_chunks), _chunks(batch, n_chunks)),
                                      constrain)
            with tr.span("train.adamw", where=grads):
                _, new_opt, om = adamw_update(params, grads, opt, tc)
        if tr.enabled:
            mx.inc("steps_total")
        return trainable, new_opt, {"loss": loss, **om}

    return extract_step, tune_step


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
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


def build_forward_step(model: LM) -> Callable:
    """Pure forward to logits (prefill-shaped, for encoder-style cells where
    the KV cache is not meaningful)."""

    @torch.no_grad()
    def fwd(batch: dict):
        return model(batch)

    return fwd
