"""The storage tier's pushdown, closed loop: each POST is issued when the
last one returns and takes one object, whose tokens go to the card, through
the plan's extraction, and back to the host as int8 codes and scales in
numpy. A POST's latency runs from its start to that payload on the host.

Set-up warms two POSTs. The window keeps ``checked_posts`` of its POSTs'
payloads, a uniform sample drawn from the seed, which the plain reference
checks after the window. A traced run then profiles ``traced_posts`` more.

A POST takes rows / COS batch microbatches, each the prefix's forwards and
one quantize.
"""
from __future__ import annotations

import random
import time
from typing import Dict

import torch

from repro_torch.core.tier_split import make_extract_fn
from repro_torch.launch.train import to_device

from hapibench import check, families
from hapibench import program as P
from hapibench import traffic as T
from hapibench.runtime import GIB, free, log, nearest_rank, peak, peak_reset, traced

FAULTS = ("altered_answer",)


def launches(kernels: dict, config: dict, traffic: dict) -> Dict[str, int]:
    chunks = traffic["rows"] // traffic["hapi"]["cos_batch"]
    return {kernels["forward"]: chunks * config["split"], "quantize_int8": chunks}


def unit_flops(config: dict, traffic: dict) -> Dict[str, float]:
    """Model FLOPs of one POST: the frozen prefix's forward at 2 N T and its
    mixer's products."""
    m, split, fam = config["model"], config["split"], families.of(config)
    rows, seq = traffic["rows"], traffic["seq"]
    return {"frozen": 2.0 * split * fam.block_matmul_params(m) * rows * seq,
            "mixer": split * fam.mixer_flops(m, rows, seq, False)}


class Pushdown:
    """The storage tier: the prefix alone and the extraction of the plan."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.device = torch.device(device)
        self.plan = P.plan(config, traffic)
        lm = P.model(config, seed, self.device, blocks=range(self.plan.split))
        self.prefix, _ = lm.split_params(self.plan.split)
        del lm
        self.extract = make_extract_fn(self.plan)
        self.store = P.store(config, traffic, seed)
        self.objects = self.store.object_names("bench")

    def post(self, index: int, clock: P.Clock) -> tuple:
        """POST ``index``: its object's tokens to the card, the extraction,
        and the codes and scales back on the host."""
        obj, _ = self.store.read(self.objects[index % len(self.objects)], 0.0)
        with clock.span("copy_in"):
            batch = to_device(obj.payload, self.device)
        with clock.span("extract", sync=True):
            q, s = self.extract(self.prefix, batch)
        with clock.span("copy_out"):
            out = (q.cpu().numpy(), s.cpu().numpy())
        return out


def run(c, seed, seconds, trace, device, fault, t_start):
    from hapibench import faults
    from hapibench.readings import Readings
    from hapibench.reference import lm as R
    from hapibench.reference.common import Precision
    tr = c.traffic
    job = Pushdown(c.config, tr, seed, device)
    log(f"model, weights and data made at {time.perf_counter() - t_start} s")
    log(f"plan: split {job.plan.split}, COS batch {job.plan.cos_batch}, int8 "
        f"{job.plan.compress}")
    keep, rng = tr["checked_posts"], random.Random(T.seed_of(seed))
    sample = []
    with faults.planted(fault, job):
        clock = P.Clock(trace, device)
        quiet = P.Clock(False, device)
        for i in range(2):
            job.post(i, quiet)
        per_post = sum(unit_flops(c.config, tr).values())
        peak_reset(device)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        latencies, posts = [], 0
        while True:
            t = time.perf_counter()
            out = job.post(posts, clock)
            latencies.append(time.perf_counter() - t)
            # A uniform sample of the window's POSTs, drawn from the seed.
            if len(sample) < keep:
                sample.append((posts, out))
            else:
                j = rng.randrange(posts + 1)
                if j < keep:
                    sample[j] = (posts, out)
            posts += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window = time.perf_counter() - t0
        peak_bytes = peak(device)
        readings = Readings("pushdown", window, posts, posts * per_post, clock.snapshot())
        if trace:
            # The profiled POSTs carry the spans' ranges but no synchronise.
            readings.trace, readings.bounds = traced(
                c, lambda i: job.post(posts + i, quiet), tr["traced_posts"], device)
    tokens = posts * tr["rows"] * tr["seq"]
    log(f"window: {posts} POSTs, {tokens} tokens in {window} s; {P.payload_bytes(out)} wire "
        f"bytes a POST; peak {peak_bytes} bytes")
    del job
    free(device)
    t_ref = time.perf_counter()
    refs = R.follow_posts(c.config, tr, seed, device, Precision("f32"), [i for i, _ in sample])
    got = [check.boundary_numbers(torch.from_numpy(q).to(device), torch.from_numpy(s).to(device),
                                  ref) for (_, (q, s)), ref in zip(sample, refs)]
    log(f"checked POSTs {[i for i, _ in sample]}, the reference in {time.perf_counter() - t_ref} s")
    metrics = {"pushdown_tokens_per_s": tokens / window,
               "pushdown_p95_ms": 1e3 * nearest_rank(latencies, 0.95),
               "peak_hbm_gib": peak_bytes / GIB, "setup_s": setup_s}
    log(f"POST latency: {len(latencies)} POSTs, median {1e3 * nearest_rank(latencies, 0.5)} ms, "
        f"p95 {metrics['pushdown_p95_ms']} ms")
    return readings, metrics, check.worst(got), peak_bytes, posts


CONTROL_POSTS = (0, 1, 2)


def control(c, seed, device) -> dict:
    """The control's numbers: the fp8 reference in the program's place."""
    from hapibench.reference import lm as R
    from hapibench.reference.common import Precision, quantize_int8
    want = R.follow_posts(c.config, c.traffic, seed, device, Precision("f32"), CONTROL_POSTS)
    free(device)
    got = R.follow_posts(c.config, c.traffic, seed, device, Precision("fp8"), CONTROL_POSTS)
    return check.worst(check.boundary_numbers(*quantize_int8(g), w) for g, w in zip(got, want))
