"""A tenant's fine-tune, closed loop: each step is issued when the last one
returns, on a batch that ``COSDataPipeline`` reads from the object store.

Set-up runs the first ``checked_steps`` steps through the window's own call
and feed, on rows that all differ, and keeps the first extraction's payload;
after the window the plain reference follows those steps on the same rows.
A traced run then profiles ``traced_steps`` more steps.

A step (the fused path: microbatch >= COS batch) takes rows / COS batch
chunks, each the prefix's forwards, each trainable block's forward twice
(remat) and its backward, one quantize and one dequantize.
"""
from __future__ import annotations

import time
from typing import Dict, Iterator

import torch

from repro_torch.config import HapiConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.data.pipeline import COSDataPipeline
from repro_torch.launch.train import to_device
from repro_torch.train.steps import build_hapi_train_step, init_train_state

from hapibench import check, families
from hapibench import program as P
from hapibench.runtime import GIB, free, log, peak, peak_reset, traced

FAULTS = ("unchanged_state", "half_batch", "altered_answer", "small_leaf_grad")


def launches(kernels: dict, config: dict, traffic: dict) -> Dict[str, int]:
    split, n = config["split"], config["model"]["n_layers"]
    chunks = traffic["rows"] // traffic["hapi"]["cos_batch"]
    return {kernels["forward"]: chunks * (split + 2 * (n - split)),
            kernels["backward"]: chunks * (n - split),
            "quantize_int8": chunks, "dequantize_int8": chunks}


def unit_flops(config: dict, traffic: dict) -> Dict[str, float]:
    """Model FLOPs of one step, by part: the frozen blocks' forward at 2 N T,
    the trainable blocks' and the head's forward and backward at 6 N T (N
    the projection weights a token meets), and the sequence mixer's own
    products. The embedding lookup and the recomputation under remat are
    not counted; the head counts the published vocabulary, not the
    program's padding."""
    m, split, fam = config["model"], config["split"], families.of(config)
    rows, seq = traffic["rows"], traffic["seq"]
    t, n_block, trained = rows * seq, fam.block_matmul_params(m), m["n_layers"] - split
    return {"frozen": 2.0 * split * n_block * t,
            "trainable": 6.0 * trained * n_block * t,
            "head": 6.0 * m["vocab_size"] * m["d_model"] * t,
            "mixer": split * fam.mixer_flops(m, rows, seq, False)
            + trained * fam.mixer_flops(m, rows, seq, True)}


class Train:
    """A tenant's fine-tune: the train state and step, and its batches."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.device = torch.device(device)
        self.plan = P.plan(config, traffic)
        cfg = P.model_config(config)
        tc = TrainConfig(**traffic["train"])
        rc = RunConfig(model=cfg, shape=ShapeConfig("bench", "train", traffic["seq"],
                                                    traffic["rows"]),
                       hapi=HapiConfig(**traffic["hapi"]), train=tc)
        lm = P.model(config, seed, self.device)
        self.state = init_train_state(lm, rc, self.plan)
        self.step = build_hapi_train_step(lm, rc, self.plan)
        self.split = self.plan.split
        self.store = P.store(config, traffic, seed)
        self.pipe = COSDataPipeline(self.store, "bench", traffic["rows"])
        self._batches = self._forever()

    def _forever(self) -> Iterator[dict]:
        while True:
            yield from self.pipe

    def next_batch(self) -> dict:
        return to_device(next(self._batches), self.device)

    def run(self, batch: dict) -> dict:
        """One step; returns its metrics with the loss read on the host."""
        self.state, metrics = self.step(self.state, batch)
        return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}

    def trainable(self) -> dict:
        """The trainable leaves under the whole model's names."""
        return {global_name(k, self.split): p
                for k, p in self.state.trainable.named_parameters()}

    def first_moment(self) -> dict:
        return {global_name(k, self.split): m for k, m in self.state.opt.m.items()}


def global_name(name: str, split: int) -> str:
    """A suffix leaf's name in the whole model (the suffix counts its blocks
    from 0)."""
    if name.startswith("blocks."):
        _, i, rest = name.split(".", 2)
        return f"blocks.{int(i) + split}.{rest}"
    return name


def run(c, seed, seconds, trace, device, fault, t_start):
    from hapibench import faults
    from hapibench.readings import Readings
    from hapibench.reference import lm as R
    from hapibench.reference.common import Precision
    tr = c.traffic
    job = Train(c.config, tr, seed, device)
    log(f"model, weights and data made at {time.perf_counter() - t_start} s")
    log(f"plan: split {job.plan.split}, COS batch {job.plan.cos_batch}, int8 "
        f"{job.plan.compress}, Alg. 1's wire bytes a step {job.plan.decision.wire_bytes_per_iter}")
    b1, clip_at = 0.9, 1.0
    captured = []
    with faults.planted(fault, job):
        # Set-up: the first steps through the window's own call and feed,
        # the first extraction's payload kept for the reference.
        start = {k: p.detach().clone() for k, p in job.trainable().items()}
        with P.extract_capture(captured):
            out = job.run(job.next_batch())
        clip = min(1.0, clip_at / max(out["grad_norm"], 1e-9))
        grads = {k: float(m.float().norm()) / ((1 - b1) * clip)
                 for k, m in job.first_moment().items()}
        losses = [out["loss"]] + [job.run(job.next_batch())["loss"]
                                  for _ in range(tr["checked_steps"] - 1)]
        change = {k: float((p.detach().float() - start[k].float()).norm())
                  for k, p in job.trainable().items()}
        del start
        wire = sum(P.wire_bytes(x) for x in captured)
        log(f"set-up steps: losses {losses}; wire bytes of the first step {wire}")
        free(device)
        clock = P.Clock(trace, device)
        if trace:
            clock.install()
        per_step = sum(unit_flops(c.config, tr).values())

        def step(clk):
            with clk.span("data"):
                batch = job.next_batch()
            with clk.span("step"):
                job.run(batch)

        peak_reset(device)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        steps = 0
        while True:
            step(clock)
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        peak_bytes = peak(device)
        readings = Readings("train", window, steps, steps * per_step, clock.snapshot())
        if trace:
            # The profiled steps carry the spans' ranges but no synchronise.
            clock.remove()
            quiet = P.Clock(False, device).install()
            readings.trace, readings.bounds = traced(c, lambda i: step(quiet),
                                                     tr["traced_steps"], device)
            quiet.remove()
    tokens = steps * tr["rows"] * tr["seq"]
    log(f"window: {steps} steps, {tokens} tokens in {window} s; peak {peak_bytes} bytes")
    program_side = {"losses": losses, "grad_norms": grads, "change_norms": change}
    del job
    free(device)
    # The reference follows the checked steps on the same rows.
    t_ref = time.perf_counter()
    ref_side, first = R.follow_train(c.config, tr, seed, device, Precision("f32"))
    numbers = check.boundary_numbers(*captured[0], first)
    gaps, leaves = check.train_numbers(program_side, ref_side)
    numbers.update(gaps)
    log(f"worst leaves {leaves}")
    log(f"reference losses {ref_side['losses']}, in {time.perf_counter() - t_ref} s")
    metrics = {"tl_tokens_per_s": tokens / window, "peak_hbm_gib": peak_bytes / GIB,
               "setup_s": setup_s}
    return readings, metrics, numbers, peak_bytes, steps


def control(c, seed, device) -> dict:
    """The control's numbers: the fp8 reference in the program's place."""
    from hapibench.reference import lm as R
    from hapibench.reference.common import Precision, quantize_int8
    want, want_b = R.follow_train(c.config, c.traffic, seed, device, Precision("f32"))
    free(device)
    got, got_b = R.follow_train(c.config, c.traffic, seed, device, Precision("fp8"))
    numbers = check.boundary_numbers(*quantize_int8(got_b), want_b)
    numbers.update(check.train_numbers(got, want)[0])
    return numbers
