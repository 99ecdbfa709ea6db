"""The running program's spans and counters (``repro_torch.obs.program``) on
the CPU: the span tree of a traced Hapi step, its tier steps, the data path
and the vision executor; the wire counter against ``wire_bytes`` and Alg. 1;
a step with the tracer off (nothing recorded, the same bits as a traced
step); the bounded window; the host stamps against ``torch.profiler``'s
ranges; a caller's wrapper of ``make_extract_fn``; the schema both ways;
threads; the summary, the idle-gap reader and the export beside a profiler
trace. The stream times need a card: ``tests/test_torch_cuda.py``.
"""
import dataclasses
import json
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config import HapiConfig, RunConfig, ShapeConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core.tier_split import make_vision_executor, plan_tiers, wire_bytes
from repro_torch.cos.objectstore import ObjectStore
from repro_torch.data.pipeline import COSDataPipeline, synthetic_dataset
from repro_torch.launch.train import run_training, to_device
from repro_torch.models import vision
from repro_torch.models.api import build_model
from repro_torch.obs import program as P
from repro_torch.obs import chrome_trace, validate_chrome_trace
from repro_torch.obs.schema import METRIC_KEYS, PROGRAM_METRIC_KEYS, PROGRAM_SPAN_NAMES
from repro_torch.train import steps as train_steps

ROOT = Path(__file__).resolve().parents[1]
ARCH = "mistral-nemo-12b"
BATCH, SEQ = 4, 16


def _job(microbatch=2, seed=0):
    """A smoke-size Hapi step: int8 boundary, COS batch 2, ``microbatch``
    (2: the fused path, two chunks of one microbatch each). bf16 and a
    boundary of 128 lanes, the int8 wire ratio Alg. 1 counts with."""
    cfg = dataclasses.replace(get_smoke_config(ARCH), d_model=128, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    shape = ShapeConfig("t", "train", SEQ, BATCH)
    hapi = HapiConfig(compress_transfer=True, cos_batch=2, cos_batch_min=1)
    rc = RunConfig(model=cfg, shape=shape, hapi=hapi,
                   train=TrainConfig(microbatch=microbatch, learning_rate=1e-3,
                                     warmup_steps=1, total_steps=4))
    plan = plan_tiers(cfg, shape, hapi)
    assert plan.split > 0 and plan.cos_batch == 2 and plan.compress
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    state = train_steps.init_train_state(model, rc, plan)
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (BATCH, SEQ)))
    return model, rc, plan, state, {"tokens": toks, "labels": toks}


def _tree(tr, root):
    """(name, [children's trees]) under ``root``."""
    kids = [s for s in tr.spans if s.parent_id == root.span_id]
    return (root.name, [_tree(tr, k) for k in kids])


EXTRACT = ("train.extract", [("extract.prefix", []), ("extract.quantize", [])])


def test_traced_hapi_step_gives_the_span_tree_under_one_step_id():
    model, rc, plan, state, batch = _job()
    step = train_steps.build_hapi_train_step(model, rc, plan)
    with P.tracing() as tr:
        step(state, batch)
    roots = tr.roots()
    assert [s.name for s in roots] == ["train.step"]
    assert _tree(tr, roots[0]) == ("train.step", [EXTRACT, ("train.tune", []), EXTRACT,
                                                  ("train.tune", []), ("train.adamw", [])])
    assert {s.unit for s in tr.spans} == {roots[0].span_id}
    assert all(not s.is_open and s.t1 >= s.t0 and s.stream_ms is None for s in tr.spans)
    counts = {s.name: dict(s.counts) for s in tr.spans}
    assert counts["train.step"] == {"rows": BATCH, "tokens": BATCH * SEQ,
                                    "bytes": 2 * BATCH * SEQ * 8}
    assert counts["train.tune"]["rows"] == counts["extract.prefix"]["rows"] == 2
    assert P.METRICS.snapshot()["counters"] == {
        "chunks_total": 2.0, "head_products_total{route=f32}": 2.0, "microbatches_total": 2.0,
        "steps_total": 1.0, "wire_bytes_total": float(plan.decision.wire_bytes_per_iter)}
    assert not P.TRACER.enabled


def test_coarse_path_and_tier_steps_are_rooted():
    model, rc, plan, state, batch = _job(microbatch=1)
    with P.tracing() as tr:
        train_steps.build_hapi_train_step(model, rc, plan)(state, batch)
        (root,) = tr.roots()
        assert _tree(tr, root) == ("train.step", [
            ("train.extract", [("extract.prefix", []), ("extract.quantize", [])] * 2),
            *[("train.tune", [])] * 4, ("train.adamw", [])])
        last = max(s.span_id for s in tr.spans)
        tr.clear()
        assert len(tr) == 0 and tr.dropped == 0
        extract_step, tune_step = train_steps.build_tier_steps(model, rc, plan)
        acts = extract_step(state.frozen, batch)
        tune_step(state.trainable, state.opt, acts, batch)
        roots = tr.roots()
        assert [_tree(tr, r)[0] for r in roots] == ["train.extract", "train.step"]
        assert _tree(tr, roots[1]) == ("train.step", [*[("train.tune", [])] * 4,
                                                      ("train.adamw", [])])
        assert len({s.unit for s in tr.spans}) == 2
        assert min(s.span_id for s in tr.spans) == last + 1    # ids go on past a clear


def test_wire_bytes_total_is_the_payload_and_alg1s_wire():
    model, rc, plan, state, batch = _job()
    payloads = []
    make = train_steps.make_extract_fn

    def capturing(p):
        fn = make(p)

        def run(prefix, b):
            out = fn(prefix, b)
            payloads.append(out)
            return out
        return run

    step = train_steps.build_hapi_train_step(model, rc, plan)
    train_steps.make_extract_fn = capturing
    try:
        with P.tracing() as tr:
            step(state, batch)
    finally:
        train_steps.make_extract_fn = make
    # The caller's wrapper still intercepts the step, inside its spans.
    assert len(payloads) == 2 and len(tr.by_name("train.extract")) == 2
    total = P.METRICS.total("wire_bytes_total")
    assert total == sum(wire_bytes(p) for p in payloads) == plan.decision.wire_bytes_per_iter


def test_tracer_off_records_nothing_and_the_step_is_bit_identical():
    runs = []
    for on in (False, True):
        model, rc, plan, state, batch = _job()
        step = train_steps.build_hapi_train_step(model, rc, plan)
        P.TRACER.clear()
        P.METRICS.clear()
        if on:
            with P.tracing():
                state, metrics = step(state, batch)
            assert len(P.TRACER) == 10
        else:
            assert P.TRACER.span("train.step") is P.TRACER.span("no.such.span")
            state, metrics = step(state, batch)
            assert len(P.TRACER) == 0 and P.TRACER.total == 0
            assert P.METRICS.snapshot()["counters"] == {}
        runs.append((metrics, {k: v.clone() for k, v in state.trainable.state_dict().items()},
                     state.opt))
    (m0, p0, o0), (m1, p1, o1) = runs
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"], m1["grad_norm"])
    assert p0.keys() == p1.keys() and all(torch.equal(p0[k], p1[k]) for k in p0)
    for a, b in zip(torch.utils._pytree.tree_leaves(o0), torch.utils._pytree.tree_leaves(o1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [7, 16, 17, 100])
def test_window_is_bounded(n):
    tr = P.ProgramTracer(max_spans=8)
    tr.enabled = True
    for i in range(n):
        with tr.span("train.step"):
            with tr.span("train.tune"):
                pass
    assert tr.total == 2 * n and len(tr) < 16 and tr.dropped == 2 * n - len(tr)
    ids = [s.span_id for s in tr.spans]
    assert ids == list(range(tr.dropped, 2 * n))
    assert (8 <= len(tr) < 16) if tr.dropped else len(tr) == 2 * n
    s = P.summary(tr, P.MetricsRegistry(keys=PROGRAM_METRIC_KEYS))
    assert s["dropped"] == tr.dropped and s["spans"]["train.tune"]["n"] == 1


def test_host_stamps_lie_within_the_profiler_ranges():
    """The spans' host clock is the profiler's, read from the trace's start
    stamp: each span's stamps lie inside its ``record_function`` range
    (which opens just before and closes just after them), and within 1 ms
    of its ends but where the thread lost the processor in between: the
    median span by 1 ms, every span by 20 ms. A first profiled step pays
    the ranges' first calls."""
    from torch.profiler import ProfilerActivity, profile
    model, rc, plan, state, batch = _job()
    step = train_steps.build_hapi_train_step(model, rc, plan)
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU]) as prof, P.tracing() as tr:
            step(state, batch)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    _, host = P.profiler_events(prof)
    assert sorted(n for n, _, _ in host) == sorted(P.RANGE_PREFIX + s.name for s in tr.spans)
    off = []
    for name in {s.name for s in tr.spans}:
        ranges = sorted((a, b) for n, a, b in host if n == P.RANGE_PREFIX + name)
        spans = sorted((s.t0, s.t1) for s in tr.by_name(name))
        for (a, b), (t0, t1) in zip(ranges, spans):
            a_s, b_s = (start_ns + 1e3 * a) * 1e-9, (start_ns + 1e3 * b) * 1e-9
            assert a_s - 1e-4 <= t0 <= t1 <= b_s + 1e-4, name
            off.append(max(t0 - a_s, b_s - t1))
    assert len(off) == len(tr) and max(off) < 2e-2 and np.median(off) < 1e-3, off


def test_data_path_spans_and_counts():
    cfg = get_smoke_config(ARCH)
    store = ObjectStore()
    store.put_dataset("d", synthetic_dataset(cfg, ShapeConfig("t", "train", SEQ, BATCH), 12),
                      object_size=2)
    pipe = COSDataPipeline(store, "d", global_batch=BATCH)
    with P.tracing() as tr:
        batches = [to_device(b, torch.device("cpu")) for b in pipe]
    assert len(batches) == 3
    waits, assembles = tr.by_name("data.wait"), tr.by_name("data.assemble")
    assert len(waits) == 4 and len(assembles) == 4     # the last finds the end
    assert {s.track for s in waits} == {threading.current_thread().name}
    assert {s.track for s in assembles} == {"cos-data"}
    assert all(s.parent_id < 0 for s in waits + assembles)
    moves = tr.by_name("data.to_device")
    assert [dict(s.counts) for s in moves] == [
        {"rows": BATCH, "tokens": BATCH * SEQ, "bytes": 2 * BATCH * SEQ * 4}] * 3
    assert P.METRICS.snapshot()["counters"] == {}       # no copy to a card


def test_vision_executor_spans_and_wire():
    vm = vision.alexnet(10, device="cpu", generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(0).standard_normal((5, 64, 64, 3)).astype(np.float32)
    execute = make_vision_executor(vm, compress=True, device="cpu")
    with P.tracing() as tr:
        q, s = execute({"x": x}, 3, 2)
    (root,) = tr.roots()
    mb = [("executor.copy_in", []), ("extract.prefix", []), ("extract.quantize", [])]
    assert _tree(tr, root) == ("executor.request", mb * 3 + [("executor.copy_out", [])])
    assert dict(root.counts)["rows"] == 5
    assert P.METRICS.snapshot()["counters"] == {"microbatches_total": 3.0,
                                                "wire_bytes_total": float(q.nbytes + s.nbytes)}


def test_schema_names_every_site_and_every_site_is_registered():
    """Each ``tr.span("...")`` name in the port is in PROGRAM_SPAN_NAMES and
    each registered name has a site; the same for the counter keys."""
    src = "\n".join(p.read_text() for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    spans = set(re.findall(r'tr\.span\(\s*"(\w+\.\w+)"', src))
    assert spans == PROGRAM_SPAN_NAMES
    keys = set(re.findall(r'(?:mx\.inc|count_copy)\(\s*"(\w+)"', src))
    assert PROGRAM_METRIC_KEYS <= keys <= PROGRAM_METRIC_KEYS | METRIC_KEYS
    with pytest.raises(ValueError, match="PROGRAM_SPAN_NAMES"):
        with P.tracing() as tr:
            tr.span("request")
    with pytest.raises(ValueError, match="PROGRAM_METRIC_KEYS"):
        P.MetricsRegistry(keys=PROGRAM_METRIC_KEYS).inc("requests_total")


def test_threads_record_their_own_trees():
    tr = P.ProgramTracer(max_spans=64)
    tr.enabled = True
    errors = []

    def work(k):
        try:
            for _ in range(200):
                with tr.span("train.step") as root:
                    with tr.span("train.tune") as kid:
                        assert kid.parent_id == root.span_id and kid.unit == root.unit
                        assert kid.track == root.track == f"w{k}"
        except AssertionError as e:     # pragma: no cover - reported below
            errors.append(e)

    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,), name=f"w{k}") for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(was)
    assert not any(t.is_alive() for t in threads) and not errors
    assert tr.total == 8 * 200 * 2
    ids = [s.span_id for s in tr.spans]
    assert ids == sorted(set(ids))


def test_summary_medians_and_self_time():
    tr = P.ProgramTracer()
    tr.enabled = True
    for host in ((1.0, 0.25), (3.0, 0.5), (2.0, 1.0)):
        with tr.span("train.step", np.zeros((2, 8), np.int64)) as root:
            with tr.span("train.tune") as kid:
                pass
        root.t0, root.t1 = 0.0, host[0] * 1e-3
        kid.t0, kid.t1 = 0.0, host[1] * 1e-3
    s = P.summary(tr, P.MetricsRegistry(keys=PROGRAM_METRIC_KEYS))["spans"]
    assert s["train.step"]["host_ms"] == pytest.approx(2.0)
    assert s["train.step"]["self_ms"] == pytest.approx(1.0)
    assert s["train.tune"]["host_ms"] == pytest.approx(0.5)
    assert s["train.step"]["stream_ms"] is None and s["train.step"]["units"] == 3
    assert s["train.step"]["tokens"] == 16 and s["train.step"]["bytes"] == 128
    assert "train.step" in P.format_summary(P.summary(tr))


def test_idle_gaps_name_the_innermost_range():
    device = [("k", 0.0, 10.0), ("k", 30.0, 40.0), ("k", 60.0, 100.0)]
    host = [("repro_torch.train.step", 0.0, 100.0), ("repro_torch.train.adamw", 25.0, 45.0),
            ("repro_torch.train.tune", 10.0, 20.0)]
    gaps = P.idle_gaps(device, host, (0.0, 110.0))
    assert gaps == pytest.approx({"train.tune": 20e-6, "train.step": 20e-6, "other": 10e-6})


def test_export_beside_a_profiler_trace(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    model, rc, plan, state, batch = _job()
    step = train_steps.build_hapi_train_step(model, rc, plan)
    with profile(activities=[ProfilerActivity.CPU]) as prof, P.tracing() as tr:
        step(state, batch)
    prof.export_chrome_trace(str(tmp_path / "prof.json"))
    validate_chrome_trace(chrome_trace(tr))
    doc = P.export_beside(str(tmp_path / "prof.json"), str(tmp_path / "both.json"))
    assert json.loads((tmp_path / "both.json").read_text()) == doc
    ev = doc["traceEvents"]
    ranges = {e["name"]: e for e in ev if e.get("cat") == "user_annotation"}
    ours = [e for e in ev if e.get("ph") == "X" and "span_id" in e.get("args", {})]
    assert len(ours) == len(tr)
    # The step's span sits inside its range on the profiler's time base.
    (step,) = [e for e in ours if e["name"] == "train.step"]
    r = ranges[P.RANGE_PREFIX + "train.step"]
    assert r["ts"] - 100 <= step["ts"] <= step["ts"] + step["dur"] <= r["ts"] + r["dur"] + 100
    theirs = {x.get("pid") for x in ev if x.get("ph") == "X" and "span_id" not in x.get("args", {})}
    assert not theirs & {e["pid"] for e in ours}


def test_run_training_prints_the_summary_and_leaves_the_tracer_off(capsys):
    out = run_training("qwen3-32b", steps=2, batch=4, seq=16, log_every=1, device="cpu")
    text = capsys.readouterr().out
    assert text.count("train.step ") == 2 and "steps_total 2" in text
    assert "train.adamw" in text and "data.to_device" in text
    assert len(out["losses"]) == 2 and not P.TRACER.enabled
