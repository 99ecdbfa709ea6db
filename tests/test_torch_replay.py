"""The port's trace record/replay subsystem against the JAX package's.

``repro_torch.replay`` is a copy of ``repro/replay``: the same workload spec
generates the same trace, a recorded fleet run writes the same JSONL bytes,
and the replayer reaches the same decisions, queue delays and decision hash
under every policy combination (only its wall-clock fields, ``wall_seconds``
and ``events_per_sec``, are the host's own). The learned placement's ridge
fit runs in torch where the reference's runs in JAX, both in float32: the
rows it fits are equal, its weights agree to float32 rounding (tolerance
below) and the placements it decides are equal.

Recorded runs use the reference's figures in both packages, as in
``tests/test_torch_fleet.py``.
"""
import dataclasses
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.replay as rreplay
from repro.api import policies as rpol
from repro.obs import hist as rhist
from repro.obs import Tracer as RTracer
from repro.replay import learned as rlearned
from repro.replay import replayer as rreplayer
import repro_torch.replay as treplay
from repro_torch.api import policies as tpol
from repro_torch.cos import server as tserver
from repro_torch.obs import hist as thist
from repro_torch.obs import Tracer as TTracer
from repro_torch.replay import learned as tlearned
from repro_torch.replay import replayer as treplayer
from test_replay import GOLDEN_ROUNDTRIP
from test_torch_fleet import PORT, REF, ROOT, V5E, _cluster, _verdict

SIDES = {"ref": (rreplay, rpol, rlearned, RTracer), "port": (treplay, tpol, tlearned, TTracer)}

# Weights of the learned placement head, port (torch float32) against the
# reference (JAX float32). Features 0 and 1 (decayed demand, and the same
# demand class-weighted) are nearly collinear, so the 3 x 3 normal matrix is
# ill-conditioned and float32 rounding of its entries (sums of ~800 rows,
# summed in another order by each library) moves individual weights by up to
# about 2e-5 absolute on this trace. The scores the policy acts on,
# w . z + bias, agree far closer: the hot and cold thresholds to 1e-6.
WEIGHT_ATOL = 1e-4
SCORE_RTOL = 1e-6


@pytest.fixture
def v5e(monkeypatch):
    """The port server's model-load rate at the v5e's HBM bandwidth."""
    monkeypatch.setattr(tserver, "HW", V5E)


SPECS = [dict(n_requests=5_000, duration=600.0, seed=5),
         dict(n_requests=500, duration=120.0, seed=3),
         dict(n_requests=2_000, duration=300.0, seed=1, models=("alexnet", "resnet18"),
              objects_per_model=8, n_tenants=3, tenant_weights=(2.0, 1.0), n_bursts=3),
         dict(n_requests=200_000, duration=5760.0, n_bursts=12, scaled=(3_000, 7))]


def _generate(side, spec):
    replay = SIDES[side][0]
    spec = dict(spec)
    scaled = spec.pop("scaled", None)
    ws = replay.WorkloadSpec(**spec)
    if scaled:
        ws = ws.scaled(*scaled)
    return replay.generate(ws)


@pytest.mark.parametrize("spec", SPECS, ids=["5k", "500", "two-models", "scaled"])
def test_generated_trace_equals_the_references(spec):
    got, want = _generate("port", spec), _generate("ref", spec)
    assert got.to_jsonl_bytes() == want.to_jsonl_bytes()
    assert dataclasses.asdict(got.header) == dataclasses.asdict(want.header)
    assert [tuple(r) for r in got.requests] == [tuple(r) for r in want.requests]
    assert len(got.requests) == (spec.get("scaled") or (spec["n_requests"],))[0]


def test_traces_read_across_packages():
    trace = _generate("ref", SPECS[1])
    blob = trace.to_jsonl_bytes()
    back = treplay.Trace.from_jsonl_bytes(blob)
    assert back.to_jsonl_bytes() == blob
    assert rreplay.Trace.from_jsonl_bytes(back.to_jsonl_bytes()).to_jsonl_bytes() == blob
    assert (treplay.TRACE_VERSION, treplay.EVENT_KINDS) == \
        (rreplay.TRACE_VERSION, rreplay.EVENT_KINDS)
    with pytest.raises(ValueError, match="not in repro_torch.replay.schema"):
        treplay.validate_kind("made-up-kind")


def _golden(m, retention="full"):
    c = (_cluster(m, 11, 2).with_storage(n_nodes=4, replication=2)
         .with_retention(retention)
         .with_dataset("ds", n_samples=2000, object_size=500, n_classes=100))
    c.submit_burst("ds", "alexnet", tenant=0, n_classes=100)
    c.submit_burst("ds", "alexnet", tenant=1, n_classes=100)
    return c


def _record(m, path, retention="full"):
    c = _golden(m, retention)
    trace = m.replay.record_trace(c, c.drain())
    trace.write(str(path))
    return trace


REF.replay, PORT.replay = rreplay, treplay


@pytest.mark.parametrize("retention", ["full", "compact"])
def test_recorded_trace_file_is_byte_identical(v5e, tmp_path, retention):
    _record(REF, tmp_path / "ref.jsonl", retention)
    trace = _record(PORT, tmp_path / "port.jsonl", retention)
    blob = (tmp_path / "port.jsonl").read_bytes()
    assert blob == (tmp_path / "ref.jsonl").read_bytes()
    assert treplay.Trace.read(str(tmp_path / "port.jsonl")).to_jsonl_bytes() == blob
    assert trace.header.mode == "batch" and len(trace.requests) == 8


def test_live_roundtrip_reproduces_the_golden_route_decisions(v5e, tmp_path):
    """tests/test_replay.py's GOLDEN_ROUNDTRIP through the port's cluster,
    recorder and replayer."""
    _record(PORT, tmp_path / "live.jsonl")
    reloaded = treplay.Trace.read(str(tmp_path / "live.jsonl"))
    v = treplay.TraceReplayer(reloaded, collect_decisions=True).run()
    live = treplay.live_route_decisions(reloaded)
    assert v.route_decisions() == live == rreplay.live_route_decisions(
        rreplay.Trace.read(str(tmp_path / "live.jsonl")))
    h = hashlib.sha256()
    for d in v.route_decisions():
        h.update(repr(d).encode())
    assert h.hexdigest() == GOLDEN_ROUNDTRIP


def test_compact_and_full_recordings_replay_alike(v5e, tmp_path):
    hashes = {}
    for side, m in (("ref", REF), ("port", PORT)):
        for retention in ("full", "compact"):
            trace = _record(m, tmp_path / f"{side}-{retention}.jsonl", retention)
            hashes[side, retention] = m.replay.TraceReplayer(trace).run().decision_hash
    assert len(set(hashes.values())) == 1


# ---------------------------------------------------------------------------
# The replayer under every registry policy
# ---------------------------------------------------------------------------
POLICIES = {
    "defaults": {},
    "demand-aware": dict(placement=("PLACEMENT_POLICIES", "demand-aware")),
    "learned-untrained": dict(placement=("PLACEMENT_POLICIES", "learned")),
    "hash-slo-fifo": dict(routing=("ROUTING_POLICIES", "hash"),
                          scaling=("SCALING_POLICIES", "slo"),
                          scheduler=("SCHEDULER_POLICIES", "fifo")),
    "least-loaded-queue-depth": dict(routing=("ROUTING_POLICIES", "least-loaded"),
                                     scaling=("SCALING_POLICIES", "queue-depth")),
    "fabric": dict(routing=("ROUTING_POLICIES", "fabric-aware"),
                   scaling=("SCALING_POLICIES", "fabric")),
    "hash-learned-queue-depth": dict(routing=("ROUTING_POLICIES", "hash"),
                                     placement=("PLACEMENT_POLICIES", "learned"),
                                     scaling=("SCALING_POLICIES", "queue-depth")),
}


@pytest.fixture(scope="module")
def day():
    spec = dict(n_requests=10_000, duration=300.0, seed=2)
    return {side: _generate(side, spec) for side in SIDES}


def _replay(side, trace, policies, **kw):
    replay, pol = SIDES[side][:2]
    made = {k: getattr(pol, reg)[name]() for k, (reg, name) in policies.items()}
    return replay.TraceReplayer(trace, collect_decisions=True, **made, **kw).run()


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_replay_verdict_equals_the_references(day, name):
    got = _replay("port", day["port"], POLICIES[name])
    want = _replay("ref", day["ref"], POLICIES[name])
    assert _verdict(got) == _verdict(want)
    assert got.decisions == want.decisions
    assert got.n_executed > 0 and got.wall_seconds > 0


@pytest.mark.parametrize("sample", [1, 8])
def test_replay_spans_equal_the_references(day, sample):
    digests = []
    for side in ("ref", "port"):
        tracer = SIDES[side][3]()
        v = _replay(side, day[side], POLICIES["demand-aware"], tracer=tracer,
                    trace_sample=sample)
        digests.append((tracer.digest(), len(tracer.by_name("replay.request")),
                        v.n_executed))
    assert digests[0] == digests[1]
    assert digests[1][1] == digests[1][2] // sample > 0


def test_replay_uses_the_shared_percentile():
    assert treplayer._percentile is thist.percentile
    assert rreplayer._percentile is rhist.percentile


# ---------------------------------------------------------------------------
# Learned placement
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def training():
    spec = dict(n_requests=30_000, duration=864.0, seed=0)
    return {side: (_generate(side, spec), _generate(side, {**spec, "scaled": (10_000, 1)}))
            for side in SIDES}


@pytest.mark.parametrize("window", [108.0, 50.0])
def test_featurize_equals_the_references(training, window):
    got = tlearned.featurize(training["port"][1], window=window)
    want = rlearned.featurize(training["ref"][1], window=window)
    assert got == want and len(got[1]) > 100


def test_learned_model_fits_and_places_like_the_references(training):
    day, train = training["port"]
    rday, rtrain = training["ref"]
    got = tlearned.train_placement_model(train, window=108.0)
    want = rlearned.train_placement_model(rtrain, window=108.0)
    assert (got.window, got.byte_unit, got.train_rows) == \
        (want.window, want.byte_unit, want.train_rows)
    np.testing.assert_allclose(got.weights, want.weights, rtol=0, atol=WEIGHT_ATOL)
    for f in ("bias", "hot_score", "cold_score", "train_rmse"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=SCORE_RTOL), f
    np.testing.assert_allclose(got.feature_mean, want.feature_mean, rtol=SCORE_RTOL)
    np.testing.assert_allclose(got.feature_std, want.feature_std, rtol=SCORE_RTOL)
    assert isinstance(got.to_policy(), tpol.LearnedPlacement)
    # The placements each model decides on the held-out day are equal.
    v = treplay.TraceReplayer(day, placement=got.to_policy(), collect_decisions=True).run()
    w = rreplay.TraceReplayer(rday, placement=want.to_policy(), collect_decisions=True).run()
    assert v.decisions == w.decisions and _verdict(v) == _verdict(w)
    # And tests/test_replay.py's claim holds for the port's model.
    da = treplay.TraceReplayer(day, placement=tpol.DemandAwarePlacement()).run()
    assert v.queue_delay_p99 < da.queue_delay_p99


def test_ridge_fit_is_float32_with_the_population_std():
    rng = np.random.default_rng(0)
    X = [tuple(map(float, row)) for row in rng.normal(size=(50, 3))]
    X = [(a, b, 0.0) for a, b, _ in X]                 # a constant feature
    y = [float(v) for v in rng.normal(size=50)]
    w, bias, mean, std, pred, rmse = tlearned._fit_ridge(X, y, 1e-3)
    Xa = np.asarray(X, np.float32)
    np.testing.assert_allclose(std[:2], Xa[:, :2].std(axis=0), rtol=1e-6)
    assert std[2] == 1.0                                # std <= 1e-9 -> 1.0
    rw = rlearned._fit_ridge(X, y, 1e-3)
    np.testing.assert_allclose(w, rw[0], rtol=0, atol=WEIGHT_ATOL)
    np.testing.assert_allclose(pred, rw[4], rtol=0, atol=1e-5)
    assert all(isinstance(v, float) for v in (*w, bias, *mean, *std, rmse))


def test_learned_exports_stay_lazy():
    code = ("import sys\n"
            "import repro_torch.replay as r\n"
            "assert 'repro_torch.replay.learned' not in sys.modules\n"
            "assert 'torch' not in sys.modules\n"
            "r.train_placement_model\n"
            "assert 'repro_torch.replay.learned' in sys.modules\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr
