"""Faults planted under the timed path, for the checks that ``correct``
catches them (``test_hapibench_faults.py`` on the CPU, ``calibrate.py`` on
the card at the cells' own sizes):

  * ``unchanged_state``: a step that returns its state unchanged (AdamW
    updates nothing);
  * ``half_batch``: half of each step's batch left out, the mean taken over
    the rest;
  * ``altered_answer``: one int8 code of every extraction's payload altered
    where it is produced (its largest code negated);
  * ``small_leaf_grad``: the gradient of the trainable leaf with the fewest
    elements (mamba2's ``A_log``, a dense block's norm scale) left at zero
    before AdamW takes it, as by a kernel that leaves an output unwritten: a
    fault that the gap over the median leaf cannot see.

Which faults a traffic kind's path can have is its ``FAULTS``. A cell on
one card has no exchange between chips to leave out.
"""
from __future__ import annotations

import contextlib

import torch

def _alter(payload):
    q, s = payload
    q = q.clone()
    flat = q.view(-1)
    i = int(flat.abs().argmax())
    flat[i] = -flat[i] if flat[i] != 0 else 127
    return q, s


@contextlib.contextmanager
def planted(fault, job):
    """``job`` (a ``program.Train`` or ``program.Pushdown``) with ``fault``
    planted while inside; None plants nothing."""
    from repro_torch.optim import adamw as program_adamw
    from repro_torch.train import steps as train_steps
    saved = (train_steps.make_extract_fn, train_steps.adamw_update,
             getattr(job, "step", None), getattr(job, "extract", None))
    try:
        if fault == "unchanged_state":
            def unchanged(params, grads, opt, tc):
                return params, opt, {"lr": torch.zeros(()),
                                     "grad_norm": program_adamw.global_norm(grads)}
            train_steps.adamw_update = unchanged
        elif fault == "half_batch":
            step = job.step
            job.step = lambda state, batch: step(
                state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
        elif fault == "small_leaf_grad":
            adamw = train_steps.adamw_update

            def unwritten(params, grads, opt, tc):
                leaf = min(grads, key=lambda k: (grads[k].numel(), k))
                return adamw(params, {**grads, leaf: torch.zeros_like(grads[leaf])}, opt, tc)
            train_steps.adamw_update = unwritten
        elif fault == "altered_answer":
            if hasattr(job, "extract"):
                extract = job.extract
                job.extract = lambda prefix, batch: _alter(extract(prefix, batch))
            else:
                make = train_steps.make_extract_fn
                train_steps.make_extract_fn = lambda plan: (
                    lambda prefix, batch: _alter(make(plan)(prefix, batch)))
        elif fault is not None:
            raise ValueError(f"no fault {fault!r}")
        yield job
    finally:
        train_steps.make_extract_fn, train_steps.adamw_update = saved[:2]
        if saved[2] is not None:
            job.step = saved[2]
        if saved[3] is not None:
            job.extract = saved[3]
