"""The port's single-server HAPI runtime against the JAX package's.

``repro_torch.obs`` and ``repro_torch.cos`` (the simulator clock, the object
store, the warm-weight cache, the compute scheduler, the server and the
client) are copies of ``repro/obs`` and ``repro/cos``. Each test drives both
packages with the same inputs and holds the port's results, event logs and
digests to the reference's exactly: the virtual clock's arithmetic is copied
operation for operation.

Two things are carried across so that both packages see the same numbers:

* Profiles, field by field. A digest comparison feeds the reference's
  ``LayerProfile`` to both; one test drains on the port's own profile and
  holds decisions equal and times to 1e-12. (The port's own
  ``profile_layered`` in fact equals the reference's bit for bit, and
  ``tests/test_torch_fleet.py`` runs the cluster goldens on it.)
* Hardware constants. The reference's ``HW`` is a TPU v5e, the port's an
  H100. Parity runs pass the v5e's figures to both packages explicitly and
  patch the port server's ``HW`` for the model-load rate (``v5e``).

The live epoch registers the port's ``make_vision_executor(device="cpu")``
with the port's server, beside the reference's server with a JAX executor.
"""
import dataclasses
import os
import subprocess
import sys
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

import repro.config as rconfig
from repro import obs as robs
from repro.core.profiler import profile_layered as r_profile_layered
from repro.cos import client as rclient
from repro.cos import clock as rclock
from repro.cos import objectstore as rstore
from repro.cos import scheduler as rsched
from repro.cos import server as rserver
from repro.cos import weightcache as rwc
from repro.models import vision as rv
import repro_torch.config as tconfig
from repro_torch import obs as tobs
from repro_torch.core import tier_split as tts
from repro_torch.core.profiler import LayerProfile as TLayerProfile
from repro_torch.core.profiler import profile_layered as t_profile_layered
from repro_torch.cos import client as tclient
from repro_torch.cos import clock as tclock
from repro_torch.cos import objectstore as tstore
from repro_torch.cos import scheduler as tsched
from repro_torch.cos import server as tserver
from repro_torch.cos import weightcache as twc
from repro_torch.models import vision as tv
from test_scheduler import GOLDEN_BARE, _digest_hash
from test_torch_vision import _images, _jax_executor, _pair

ROOT = Path(__file__).resolve().parents[1]
ATOL = 1e-4                 # float32 boundary activations, as test_torch_vision

REF = SimpleNamespace(name="ref", clock=rclock, store=rstore, sched=rsched,
                      server=rserver, client=rclient, wc=rwc, obs=robs)
PORT = SimpleNamespace(name="port", clock=tclock, store=tstore, sched=tsched,
                       server=tserver, client=tclient, wc=twc, obs=tobs)
SIDES = (REF, PORT)

# The reference's TPU v5e figures, passed to both packages explicitly.
V5E = rconfig.HW
SERVER_HW = dict(hbm_per_accel=V5E.hbm_capacity, flops_per_accel=V5E.peak_flops_bf16)
CLIENT_HW = dict(client_flops=V5E.peak_flops_bf16, client_hbm=V5E.hbm_capacity)


@pytest.fixture
def v5e(monkeypatch):
    """The port server's model-load rate at the v5e's HBM bandwidth."""
    monkeypatch.setattr(tserver, "HW", V5E)


@pytest.fixture(scope="module")
def ref_profiles():
    return {"alexnet": r_profile_layered(rv.alexnet(100)),
            "resnet18": r_profile_layered(rv.resnet18(100))}


def _profile(m, ref_profile):
    """The reference's profile, as a LayerProfile of ``m``'s package."""
    if m is REF:
        return ref_profile
    return TLayerProfile(**dataclasses.asdict(ref_profile))


def _hapi(m, **kw):
    """HapiConfig of ``m``'s package with the reference's defaults (the
    port's default HBM budget is the H100's)."""
    h = rconfig.HapiConfig(**kw)
    return h if m is REF else tconfig.HapiConfig(**dataclasses.asdict(h))


def _server(m, store, **kw):
    return m.server.HapiServer(store, **{**SERVER_HW, **kw})


def _client(m, server, link, prof, hapi, key, **kw):
    return m.client.HapiClient(server, link, prof, hapi, key, **{**CLIENT_HW, **kw})


def _make_store(m, n=4000, obj=1000, img_bytes=110_000, sim=None):
    """tests/test_cos_runtime.py's store, in ``m``'s package."""
    store = m.store.ObjectStore()
    if sim is not None:
        store.attach_sim(sim)
    rng = np.random.default_rng(0)
    store.put_dataset("ds", {
        "x": rng.normal(size=(n, 8, 8, 3)).astype(np.float32),
        "y": rng.integers(0, 100, size=(n,)).astype(np.int32),
    }, object_size=obj)
    for o in store.objects.values():
        o.nbytes = o.n_samples * img_bytes
    return store


def _sim_record(sim):
    if sim is None:
        return None
    return {"log": sim.log.digest(), "stream": sim.log.stream_digest(),
            "spans": sim.tracer.digest(), "metrics": sim.metrics.snapshot(),
            "now": sim.now}


def _adapted(server):
    return [([tuple(a) for a in r.assignments], list(r.dropped), r.mem_used, r.budget)
            for r in server.adapt_results]


# ---------------------------------------------------------------------------
# obs: schema, percentiles, tracer, metrics, export
# ---------------------------------------------------------------------------
def test_obs_schema_sets_equal_the_reference():
    assert tobs.SPAN_NAMES == robs.SPAN_NAMES
    assert tobs.METRIC_KEYS == robs.METRIC_KEYS
    assert tobs.TIERS == robs.TIERS
    assert tobs.DEFAULT_TIME_BUCKETS == robs.DEFAULT_TIME_BUCKETS
    for m in SIDES:
        with pytest.raises(ValueError):
            m.obs.Tracer().emit("no.such.span", 0.0, 1.0, tier="compute", track="a")
        with pytest.raises(ValueError):
            m.obs.Tracer().emit("request", 0.0, 1.0, tier="nowhere", track="a")
        with pytest.raises(ValueError):
            m.obs.MetricsRegistry().inc("no_such_metric")


@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
def test_obs_percentile_and_buckets_equal_the_reference(n):
    vals = sorted(np.random.default_rng(n).exponential(0.3, n).tolist())
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert tobs.percentile(vals, q) == robs.percentile(vals, q)
    assert tobs.bucket_counts(vals) == robs.bucket_counts(vals)
    edges = (0.1, 0.2, 0.4, float("inf"))
    assert tobs.bucket_counts(vals, edges) == robs.bucket_counts(vals, edges)


def _trace(m, seed, max_spans):
    """The same random emit / emit_fast / begin / extend sequence."""
    rng = np.random.default_rng(seed)
    names = sorted(robs.SPAN_NAMES)
    tiers = sorted(robs.TIERS)
    tr = m.obs.Tracer(max_spans=max_spans)
    opened = []
    for i in range(300):
        name = names[rng.integers(len(names))]
        tier = tiers[rng.integers(len(tiers))]
        track = f"t{rng.integers(4)}"
        t0 = float(rng.uniform(0, 10))
        t1 = t0 + float(rng.exponential(0.5))
        parent = opened[rng.integers(len(opened))] if opened and rng.random() < 0.5 else -1
        labels = (("i", str(i)),)
        kind = rng.integers(4)
        if kind == 0:
            opened.append(tr.emit(name, t0, t1, tier=tier, track=track, parent=parent,
                                  labels=labels))
        elif kind == 1:
            tr.emit_fast(name, t0, t1, tier, track, parent, labels)
        elif kind == 2:
            opened.append(tr.begin(name, t0, tier=tier, track=track, labels=labels))
        elif opened:
            tr.extend(opened[rng.integers(len(opened))], t1 + 1.0)
    return tr


@pytest.mark.parametrize("max_spans", [None, 64])
def test_obs_tracer_digest_and_export_equal_the_reference(max_spans):
    a, b = _trace(PORT, 5, max_spans), _trace(REF, 5, max_spans)
    assert a.digest() == b.digest()
    assert (len(a), a.total, a.dropped) == (len(b), b.total, b.dropped)
    assert [s.as_tuple() for s in a.roots()] == [s.as_tuple() for s in b.roots()]
    assert sorted(a.tracks()) == sorted(b.tracks())
    doc = tobs.chrome_trace(a)
    tobs.validate_chrome_trace(doc)
    assert doc == robs.chrome_trace(b)
    off = PORT.obs.Tracer(enabled=False)
    assert off.emit("request", 0.0, 1.0, tier="client", track="x") == -1 and len(off) == 0


def _metrics(m, overflow):
    rng = np.random.default_rng(9)
    mx = m.obs.MetricsRegistry(max_label_sets=8, overflow=overflow)
    for _ in range(400):
        k = rng.integers(3)
        tenant = int(rng.integers(12 if overflow == "rollup" else 6))
        if k == 0:
            mx.inc("requests_total", float(rng.integers(1, 4)), tenant=tenant)
        elif k == 1:
            mx.gauge_set("trunk_utilization", float(rng.random()), link=f"l{tenant % 3}")
        else:
            mx.observe("stage_seconds", float(rng.exponential(0.2)), stage=f"s{tenant % 4}",
                       tenant=tenant % 2)
    return mx


@pytest.mark.parametrize("overflow", ["raise", "rollup"])
def test_obs_metrics_snapshot_and_dump_equal_the_reference(overflow):
    a, b = _metrics(PORT, overflow), _metrics(REF, overflow)
    assert a.snapshot() == b.snapshot()
    assert a.dump() == b.dump()
    assert a.rolled_up == b.rolled_up
    assert a.total("requests_total") == b.total("requests_total")
    assert a.percentile("stage_seconds", 0.9) == b.percentile("stage_seconds", 0.9)
    for m in SIDES:
        mx = m.obs.MetricsRegistry()
        mx.inc("requests_total")
        with pytest.raises(ValueError, match="different"):
            mx.observe("requests_total", 1.0)


# ---------------------------------------------------------------------------
# The clock: EventLog, Simulator, Timeline, Link, Accelerator
# ---------------------------------------------------------------------------
def _events(m, retention, tail):
    rng = np.random.default_rng(21)
    log = m.clock.EventLog(retention=retention, tail=tail)
    kinds = ["served", "store.read", "busy", "iteration", "reject"]
    for i in range(257):
        log.add(float(rng.uniform(0, 5)), kinds[rng.integers(len(kinds))], f"d{i}")
    return log


@pytest.mark.parametrize("retention,tail", [("full", 1024), ("full", 16), ("compact", 16),
                                            ("compact", 7)])
def test_eventlog_digests_equal_the_reference(retention, tail):
    a, b = _events(PORT, retention, tail), _events(REF, retention, tail)
    assert a.digest() == b.digest()
    assert a.stream_digest() == b.stream_digest()
    assert (len(a), a.counts(), a.kinds()) == (len(b), b.counts(), b.kinds())
    assert a.filter_many(["busy", "reject"]) == b.filter_many(["busy", "reject"])
    assert a.count("served") == b.count("served")
    # The stream digest does not depend on the retention.
    other = _events(PORT, "full" if retention == "compact" else "compact", tail)
    assert other.stream_digest() == a.stream_digest()


def _simulate(m, retention):
    sim = m.clock.Simulator(seed=4, retention=retention, log_tail=8)
    fired = []

    def tick(i):
        def cb():
            fired.append((i, sim.now))
            if i < 30:
                sim.schedule(sim.now + float(sim.rng.exponential(0.1)), "tick", f"{i + 1}",
                             tick(i + 1))
        return cb

    sim.schedule(0.5, "tick", "0", tick(0))
    for t in (0.25, 0.25, 1.0):
        sim.schedule(t, "arrive", f"{t}")
    accel = m.clock.Accelerator(name="a0", flops=1e12, hbm=1e9).attach(sim)
    link = m.clock.Link(name="wan", bandwidth=1e6).attach(sim)
    n = sim.run_until(0.75)
    accel.compute(sim.now, 3e11)
    link.transfer(sim.now, 12345)
    assert accel.try_alloc(6e8) and not accel.try_alloc(6e8)
    accel.free(1e8)
    sim.record(sim.now, "note", "x")
    n += sim.run()
    return (n, fired, sim.now, accel.busy_until, accel.mem_used, link.busy_time,
            _sim_record(sim))


@pytest.mark.parametrize("retention", ["full", "compact"])
def test_simulator_run_and_digests_equal_the_reference(retention):
    assert _simulate(PORT, retention) == _simulate(REF, retention)


def test_link_timeline_and_accelerator_equal_the_reference():
    for start, n in ((0.0, 1000), (0.0005, 5000), (1.0, 0)):
        assert tclock.Link("x", bandwidth=1e6).transfer(start, n) == \
            rclock.Link("x", bandwidth=1e6).transfer(start, n)
    a = tclock.Accelerator("a", flops=2e12, hbm=4e9, slowdown=3.0)
    b = rclock.Accelerator("a", flops=2e12, hbm=4e9, slowdown=3.0)
    for start, f, eff in ((0.0, 1e12, 0.4), (0.1, 5e11, 0.25), (9.0, 0.0, 1.0)):
        assert a.compute(start, f, eff) == b.compute(start, f, eff)
    a.note(10.0, 10.5)
    b.note(10.0, 10.5)
    assert (a.busy_until, a.busy_time) == (b.busy_until, b.busy_time)


# ---------------------------------------------------------------------------
# The object store
# ---------------------------------------------------------------------------
class _EveryOther:
    """A placement policy (duck-typed): replicas on alternate nodes."""

    def initial(self, index, n_nodes, replication):
        return [2 * index + r for r in range(replication)]


@pytest.mark.parametrize("placement", [None, _EveryOther()])
def test_objectstore_reads_and_replicas_equal_the_reference(placement):
    out = []
    for m in SIDES:
        sim = m.clock.Simulator(seed=0)
        store = m.store.ObjectStore(n_storage_nodes=4, replication=2,
                                    placement=placement).attach_sim(sim)
        rng = np.random.default_rng(3)
        cols = {"x": rng.normal(size=(23, 5)).astype(np.float32),
                "y": rng.integers(0, 9, 23).astype(np.int64)}
        names = store.put_dataset("d", cols, object_size=5)
        reads = []
        for i, oname in enumerate(names * 3):
            obj, ready = store.read(oname, 0.001 * i, parent=i)
            reads.append((oname, ready, obj.n_samples, obj.nbytes,
                          obj.payload["x"].tobytes(), obj.payload["y"].tobytes()))
        reps = [(store.add_replica(names[0], 3), store.add_replica(names[0], 3),
                 store.remove_replica(names[1], store.replicas(names[1])[0], 2.0),
                 store.remove_replica(names[2], 9, 2.0))]
        reads.append(store.read(names[0], 3.0)[1])
        assert store.read_batch(names, 4.0) is None          # no fabric: one read each
        out.append((names, reads, reps, [store.replicas(o) for o in names],
                    store.total_bytes("d"), store.object_names("d"), _sim_record(sim)))
    assert out[0] == out[1]


def test_synthetic_image_store_equals_the_reference():
    a = tstore.synthetic_image_store("ds", n_samples=2500, object_size=1000, n_classes=10,
                                     seed=7)
    b = rstore.synthetic_image_store("ds", n_samples=2500, object_size=1000, n_classes=10,
                                     seed=7)
    assert list(a.objects) == list(b.objects)
    for oname, o in a.objects.items():
        p = b.objects[oname]
        assert (o.nbytes, o.n_samples) == (p.nbytes, p.n_samples)
        for k in ("x", "y"):
            assert o.payload[k].dtype == p.payload[k].dtype
            assert o.payload[k].tobytes() == p.payload[k].tobytes()
        assert a.replicas(oname) == b.replicas(oname)


# ---------------------------------------------------------------------------
# The scheduler: WDRR and FIFO orders, class-aware Eq. 4, the weight cache
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Req:
    req_id: int
    tenant: int
    arrival: float = 0.0
    compute_weight: float = 1.0


def _queues(seed):
    rng = np.random.default_rng(seed)
    pending, weights, rid = {}, {}, 0
    for t in range(int(rng.integers(1, 6))):
        q = deque()
        for _ in range(int(rng.integers(0, 9))):
            q.append(_Req(rid, t, arrival=float(rng.integers(0, 4)) * 0.5))
            rid += 1
        pending[t] = q
        weights[t] = float(rng.choice([0.25, 1.0, 1.0, 3.0, 4.0, 1e-4]))
    return pending, weights


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("policy", ["WdrrScheduling", "FifoScheduling"])
def test_dispatch_orders_equal_the_reference(seed, policy):
    got = getattr(tsched, policy)().order(*_queues(seed))
    want = getattr(rsched, policy)().order(*_queues(seed))
    assert [(r.tenant, r.req_id) for r in got] == [(r.tenant, r.req_id) for r in want]


def test_scheduler_weights_and_share_equal_the_reference(v5e, ref_profiles):
    out = []
    for m in SIDES:
        sched = m.sched.ComputeScheduler()
        sched.enqueue(_Req(0, 7, compute_weight=3.0))
        w = [sched.weight_of(7)]
        sched.set_weight(7, 2.0)
        w += [sched.weight_of(7), sched.weight_of(99), sched.pending_total()]
        with pytest.raises(ValueError):
            sched.set_weight(1, 0.0)
        store = _make_store(m, n=4000)
        srv = _server(m, store, n_accelerators=1)
        prof = _profile(m, ref_profiles["alexnet"])
        for i, oname in enumerate(store.object_names("ds")):
            srv.submit(m.server.PostRequest(i, i % 2, "alexnet", 5, oname, 500, prof, 0.0))
        out.append((w, m.sched.windowed_accel_share(srv.drain(), 2)))
    assert out[0] == out[1]


def _class_aware_round(m, seed, prof):
    """Tenants of weight 1, 2 and 4 on one accelerator whose HBM holds fewer
    requests than a round admits even at the floor of 25 images (about 45 MB
    each): Eq. 4 shrinks and defers by class."""
    rng = np.random.default_rng(seed)
    store = _make_store(m, n=3000, obj=250)
    srv = _server(m, store, n_accelerators=1, hbm_per_accel=2.5e8)
    for i, oname in enumerate(store.object_names("ds")):
        tenant = int(rng.integers(3))
        srv.submit(m.server.PostRequest(
            i, tenant, "alexnet", 5, oname, 250, prof, float(rng.integers(0, 3)) * 0.01,
            compute_weight=float(2 ** tenant)))
    resp = srv.drain()
    return ([(r.req_id, r.tenant, r.cos_batch, r.started, r.finished) for r in resp],
            _adapted(srv), srv.log.digest())


@pytest.mark.parametrize("seed", range(3))
def test_class_aware_eq4_equals_the_reference(v5e, ref_profiles, seed):
    p = ref_profiles["alexnet"]
    got = _class_aware_round(PORT, seed, _profile(PORT, p))
    want = _class_aware_round(REF, seed, p)
    assert got == want
    assert any(dropped for _, dropped, _, _ in want[1])       # HBM, not the wire, binds


# Cache cases: (keep-warm window, prefix bytes scale, HBM, eviction reason).
# Alexnet's real prefixes at a short window expire; prefixes scaled 3000x fill
# much of the HBM, so entries are evicted under pressure before Eq. 4 shrinks.
CACHE_CASES = {"expire": (0.05, 1, 2.5e9), "pressure": (1.0, 3000, 6e9)}


def _cached_rounds(m, policy, prof, window, hbm):
    """A bare server with the warm-weight cache: three models, rounds spread
    over virtual time so leases expire into the cache and hit it warm."""
    sim = m.clock.Simulator(seed=1)
    store = _make_store(m, n=4000, obj=500, sim=sim)
    cache = m.wc.WeightCache(window=window, policy=policy)
    srv = _server(m, store, n_accelerators=2, hbm_per_accel=hbm, sim=sim,
                  scheduler=m.sched.ComputeScheduler(cache=cache))
    names = store.object_names("ds")
    rid, resp = 0, []
    for rnd, t in enumerate((0.0, 0.02, 0.2, 0.21, 0.5, 0.6)):
        for j, oname in enumerate(names[rnd % 2::2][:3]):
            rid += 1
            srv.submit(m.server.PostRequest(rid, j % 2, f"m{(rnd + j) % 3}", 3 + 2 * (j % 2),
                                            oname, 400, prof, t))
        resp += srv.drain(now=t)
    return ([(r.req_id, r.cos_batch, r.started, r.finished) for r in resp], cache.evictions,
            cache.warm_hits, cache.retained_bytes, srv.scheduler.reload_bytes,
            srv.scheduler.reload_saved_bytes, [a.mem_used for a in srv.accels],
            _sim_record(sim))


@pytest.mark.parametrize("case", sorted(CACHE_CASES))
@pytest.mark.parametrize("policy", ["lru", "demand"])
def test_weight_cache_rounds_equal_the_reference(v5e, ref_profiles, policy, case):
    window, scale, hbm = CACHE_CASES[case]
    p = ref_profiles["alexnet"]
    p = dataclasses.replace(p, prefix_param_bytes=[scale * b for b in p.prefix_param_bytes])
    got = _cached_rounds(PORT, policy, _profile(PORT, p), window, hbm)
    want = _cached_rounds(REF, policy, p, window, hbm)
    assert got == want
    assert want[2] > 0 and case in {e[5] for e in want[1]}


# ---------------------------------------------------------------------------
# The server: GOLDEN_BARE, the port's own profile, leaves
# ---------------------------------------------------------------------------
def _bare_drain(m, prof):
    store = m.store.synthetic_image_store("ds", n_samples=2000, object_size=500,
                                          n_classes=100)
    srv = _server(m, store, n_accelerators=2)
    for i, oname in enumerate(store.object_names("ds")):
        srv.submit(m.server.PostRequest(i, 0, "alexnet", 5, oname, 500, prof, 0.0))
    return srv.drain(), srv


def test_golden_bare_server_drain_through_the_port(v5e, ref_profiles):
    """tests/test_scheduler.py's pinned GOLDEN_BARE, served by the port's
    server on the reference's profile and constants."""
    resp, srv = _bare_drain(PORT, _profile(PORT, ref_profiles["alexnet"]))
    payload = tuple((r.req_id, r.cos_batch, r.started, r.finished) for r in resp) + \
        srv.log.digest()
    assert _digest_hash(payload) == GOLDEN_BARE


def test_bare_drain_on_the_ports_own_profile(v5e, ref_profiles):
    """The port's own profile_layered: the same COS batches and request order,
    times within 1e-12 relative of the reference's."""
    own = t_profile_layered(tv.alexnet(100, device="meta"))
    got, gsrv = _bare_drain(PORT, own)
    want, wsrv = _bare_drain(REF, ref_profiles["alexnet"])
    assert [(r.req_id, r.cos_batch, r.object_name) for r in got] == \
        [(r.req_id, r.cos_batch, r.object_name) for r in want]
    assert [[tuple(a)[:2] for a in r.assignments] for r in gsrv.adapt_results] == \
        [[tuple(a)[:2] for a in r.assignments] for r in wsrv.adapt_results]
    for r, w in zip(got, want):
        np.testing.assert_allclose([r.started, r.finished, r.act_bytes],
                                   [w.started, w.finished, w.act_bytes], rtol=1e-12, atol=0)


def test_leaves_follow_jax_tree_order():
    tree = {"b": (np.zeros(1), [np.ones(2), None]), "a": np.full(3, 2.0),
            "c": {"z": np.arange(4), "y": ()}}
    got = tserver._leaves(tree)
    want = jax.tree.leaves(tree)
    assert len(got) == len(want) == 4
    assert all(g is w for g, w in zip(got, want))
    assert tserver._leaves(None) == [] and tserver._leaves(np.zeros(2))[0].shape == (2,)


# ---------------------------------------------------------------------------
# The client: tests/test_cos_runtime.py's scenarios through both packages
# ---------------------------------------------------------------------------
def _sc_epoch(m, profs, sim):
    store = _make_store(m, sim=sim)
    server = _server(m, store, n_accelerators=2, sim=sim)
    link = m.clock.Link(name="wan", bandwidth=1e9 / 8)
    res = _client(m, server, link, profs["alexnet"], _hapi(m), "alexnet").run_epoch(
        "ds", train_batch=2000)
    assert res.n_iterations == 2 and not res.oom
    return [res], server


def _sc_slow_network(m, profs, sim):
    store = _make_store(m, sim=sim)
    server = _server(m, store, n_accelerators=2, sim=sim)
    l1 = m.clock.Link(name="a", bandwidth=150e6 / 8)
    l2 = m.clock.Link(name="b", bandwidth=150e6 / 8)
    h = _client(m, server, l1, profs["alexnet"], _hapi(m, network_bandwidth=150e6 / 8),
                "alexnet").run_epoch("ds", 2000)
    b = m.client.BaselineClient(store, l2, profs["alexnet"], **CLIENT_HW).run_epoch("ds", 2000)
    assert h.execution_time < b.execution_time
    return [h, b], server


def _sc_baseline_oom(m, profs, sim):
    store = _make_store(m, sim=sim)
    base = m.client.BaselineClient(store, m.clock.Link(name="x", bandwidth=1e9),
                                   profs["resnet18"], client_flops=V5E.peak_flops_bf16,
                                   client_hbm=2e9)
    res = base.run_epoch("ds", train_batch=4000)
    assert res.oom
    return [res, base.run_epoch("ds", train_batch=500, max_iterations=3)], None


def _sc_restart(m, profs, sim):
    store = _make_store(m, sim=sim)
    server = _server(m, store, n_accelerators=1, sim=sim)
    client = _client(m, server, m.clock.Link(name="wan", bandwidth=1e9), profs["alexnet"],
                     _hapi(m), "alexnet")
    server.kill()
    with pytest.raises(ConnectionError):
        server.submit(m.server.PostRequest(1, 0, "alexnet", 5, "ds/part-00000", 200,
                                           profs["alexnet"], 0.0))
    server.restart()
    res = client.run_epoch("ds", train_batch=1000, max_iterations=2)
    assert not res.oom and res.n_iterations == 2
    return [res], server


def _sc_straggler(m, profs, sim):
    store = _make_store(m, sim=sim)
    server = _server(m, store, n_accelerators=2, sim=sim)
    server.accels[1].slowdown = 100.0
    res = _client(m, server, m.clock.Link(name="wan", bandwidth=1e9), profs["alexnet"],
                  _hapi(m), "alexnet", straggler_factor=2.0).run_epoch(
        "ds", train_batch=4000, max_iterations=1)
    assert sum(i.reissued for i in res.iterations) >= 1
    return [res], server


def _sc_adapt_under_load(m, profs, sim):
    store = _make_store(m, n=8000, sim=sim)
    server = _server(m, store, n_accelerators=1, hbm_per_accel=4e9, sim=sim)
    res = _client(m, server, m.clock.Link(name="wan", bandwidth=1e9), profs["alexnet"],
                  _hapi(m, cos_batch=1000), "alexnet").run_epoch(
        "ds", train_batch=8000, max_iterations=1)
    assert any(a.batch < 1000 for r in server.adapt_results for a in r.assignments) or \
        any(r.dropped for r in server.adapt_results)
    return [res], server


def _sc_in_proxy(m, profs, sim):
    store = _make_store(m, sim=sim)
    out = []
    for decoupled in (True, False):
        server = _server(m, store, n_accelerators=2, decoupled=decoupled, sim=sim)
        out.append(_client(m, server, m.clock.Link(name=f"wan{decoupled}", bandwidth=1e9),
                           profs["alexnet"], _hapi(m), "alexnet").run_epoch(
            "ds", train_batch=4000, max_iterations=1))
    assert out[0].execution_time < out[1].execution_time
    return out, server


def _sc_two_tenants(m, profs, sim):
    """Two tenants on one server, one pushing training down (ALL_IN_COS)."""
    store = _make_store(m, n=2000, sim=sim)
    server = _server(m, store, n_accelerators=2, flops_per_accel=65e12, sim=sim)
    out = []
    for t, push in ((0, False), (1, True), (2, False)):
        c = _client(m, server, m.clock.Link(name=f"wan{t}", bandwidth=12e9 / 8),
                    profs["alexnet"], _hapi(m), "alexnet", tenant=t, push_training=push,
                    network_weight=1.0 + t)
        out.append(c.run_epoch("ds", train_batch=1000, max_iterations=1))
    return out, server


SCENARIOS = {"epoch_and_reorder": _sc_epoch, "hapi_beats_baseline_on_slow_network":
             _sc_slow_network, "baseline_oom": _sc_baseline_oom,
             "stateless_restart": _sc_restart, "straggler_reissue": _sc_straggler,
             "adaptation_under_load": _sc_adapt_under_load,
             "decoupled_vs_in_proxy": _sc_in_proxy, "two_tenants_one_pushed": _sc_two_tenants}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_client_scenarios_equal_the_reference(v5e, ref_profiles, scenario, traced):
    """EpochResult for EpochResult, and with a Simulator attached the shared
    event log, spans and metrics digest for digest."""
    out = []
    for m in SIDES:
        sim = m.clock.Simulator(seed=2) if traced else None
        profs = {k: _profile(m, p) for k, p in ref_profiles.items()}
        results, server = SCENARIOS[scenario](m, profs, sim)
        out.append(([dataclasses.asdict(r) for r in results],
                    None if server is None else (server.log.digest(), _adapted(server)),
                    _sim_record(sim)))
    assert out[0] == out[1]


class _ScriptedServer:
    """tests/test_cos_runtime.py's stub: each drain() pops the next scripted
    response batch (a shared fleet may answer requests the caller never
    issued)."""

    def __init__(self, script):
        self.script = [list(batch) for batch in script]
        self.submitted = []
        self.unclaimed = {}

    def submit(self, req):
        self.submitted.append(req)

    def drain(self, now=0.0):
        return self.script.pop(0) if self.script else []


def _resp(m, req_id, finished, act_bytes=1000.0):
    return m.server.PostResponse(req_id=req_id, tenant=0, object_name=f"o{req_id}", acts=None,
                                 act_bytes=act_bytes, cos_batch=100, arrival=0.0, started=0.0,
                                 finished=finished)


def _stub_straggler(m, prof):
    """The re-issue's drain returns a stranger first, then the duplicate."""
    server = _ScriptedServer([
        [_resp(m, 1, 1.0), _resp(m, 2, 1.0), _resp(m, 3, 10.0, act_bytes=3333.0)],
        [_resp(m, 999_777, 5.0, act_bytes=4444.0), _resp(m, 500_003, 2.0, act_bytes=7777.0)],
    ])
    client = _client(m, server, m.clock.Link(name="wan", bandwidth=1e9), prof, _hapi(m),
                     "alexnet", straggler_factor=2.0)
    stats = client._run_iteration(0, 0.0, ["o1", "o2", "o3"], 5, 300)
    assert stats.reissued == 1 and stats.wire_bytes == 1000.0 + 1000.0 + 7777.0
    return [stats], sorted(client.unclaimed), [r.req_id for r in server.submitted]


def _stub_claims_own(m, prof):
    server = _ScriptedServer([[_resp(m, 1, 1.0), _resp(m, 2, 1.0)]])
    client = _client(m, server, m.clock.Link(name="wan", bandwidth=1e9), prof, _hapi(m),
                     "alexnet")
    client.unclaimed[3] = _resp(m, 3, 1.5)
    stats = client._run_iteration(0, 0.0, ["o1", "o2", "o3"], 5, 300)
    assert stats.n_posts == 3 and 3 not in client.unclaimed
    return [stats], sorted(client.unclaimed), [r.req_id for r in server.submitted]


def _stub_shared_stash(m, prof):
    b_req = 2 * 1_000_000 + 1
    server = _ScriptedServer([[_resp(m, 1, 1.0), _resp(m, b_req, 1.2)], []])
    a = _client(m, server, m.clock.Link(name="wanA", bandwidth=1e9), prof, _hapi(m),
                "alexnet", tenant=0)
    b = _client(m, server, m.clock.Link(name="wanB", bandwidth=1e9), prof, _hapi(m),
                "alexnet", tenant=2)
    assert a.unclaimed is server.unclaimed is b.unclaimed
    sa = a._run_iteration(0, 0.0, ["o1"], 5, 300)
    assert b_req in server.unclaimed
    sb = b._run_iteration(0, 0.0, ["oB"], 5, 300)
    assert b_req not in server.unclaimed
    return [sa, sb], sorted(server.unclaimed), [r.req_id for r in server.submitted]


@pytest.mark.parametrize("stub", [_stub_straggler, _stub_claims_own, _stub_shared_stash])
def test_client_response_matching_equals_the_reference(ref_profiles, stub):
    """Straggler re-issue matched by req_id, a response claimed from an
    earlier shared drain, and the stash shared across clients."""
    got, want = (stub(m, _profile(m, ref_profiles["alexnet"])) for m in (PORT, REF))
    assert [dataclasses.asdict(s) for s in got[0]] == [dataclasses.asdict(s) for s in want[0]]
    assert got[1:] == want[1:]


def test_overcommitted_allocation_fails_loudly_as_the_reference(v5e, ref_profiles):
    msgs = []
    for m in SIDES:
        store = _make_store(m, n=1000, obj=1000)
        server = _server(m, store, n_accelerators=1, hbm_per_accel=1e6)
        req = m.server.PostRequest(1, 0, "alexnet", 5, "ds/part-00000", 200,
                                   _profile(m, ref_profiles["alexnet"]), 0.0)
        with pytest.raises(AssertionError, match="overcommitted") as e:
            server._execute(req, 200, 2e6, 0, 0.0)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_baseline_joins_the_sim_and_links_without_a_fabric(ref_profiles):
    """link=None builds a private Link (the reference's wan_link without a
    fabric); on a traced store the baseline's transfers and compute are in
    the shared trace."""
    out = []
    for m in SIDES:
        sim = m.clock.Simulator(0)
        store = _make_store(m, n=2000, sim=sim)
        prof = _profile(m, ref_profiles["alexnet"])
        b2 = m.client.BaselineClient(store, None, prof, tenant=2, bandwidth=1e9, **CLIENT_HW)
        b2.run_epoch("ds", train_batch=1000, max_iterations=1)
        c = _client(m, _server(m, store), None, prof, _hapi(m), "alexnet", tenant=3)
        out.append(((b2.link.name, b2.link.bandwidth, b2.link.latency, b2.accel.name),
                    (c.link.name, c.link.bandwidth, c.link.latency), _sim_record(sim)))
    assert out[0] == out[1]


def test_a_fabric_needs_the_network_module(v5e, ref_profiles):
    """A client, a baseline client and a store given a shared fabric take
    their links from the port's own ``cos.network`` (imported only then):
    fabric ports on one trunk, the store's reads batched through it. Their
    epochs on the shared simulator log what the reference's do."""
    from repro.cos import network as rnet
    from repro_torch.cos import network as tnet

    out = []
    for m, net in ((REF, rnet), (PORT, tnet)):
        sim = m.clock.Simulator(0)
        fabric = net.NetworkFabric(net.NetworkSpec(trunk_bandwidth=1e9 / 8), sim=sim)
        store = _make_store(m, n=2000, sim=sim)
        store.use_fabric(fabric)
        prof = _profile(m, ref_profiles["alexnet"])
        c = _client(m, _server(m, store, sim=sim), None, prof, _hapi(m), "alexnet",
                    tenant=0, fabric=fabric, network_weight=2.0)
        b = m.client.BaselineClient(store, None, prof, tenant=1, bandwidth=1e9 / 8,
                                    fabric=fabric, **CLIENT_HW)
        assert type(c.link).__module__ == type(b.link).__module__ == net.__name__
        runs = [c.start_epoch("ds", train_batch=1000, max_iterations=2)]
        res = net.run_concurrently(runs)
        base = b.run_epoch("ds", train_batch=1000, max_iterations=1)
        out.append(([dataclasses.asdict(r) for r in res], dataclasses.asdict(base),
                    sorted(fabric.ports), fabric.effective_bandwidth(0),
                    (c.link.name, c.link.weight, b.link.name, b.link.weight),
                    _sim_record(sim)))
    assert out[0] == out[1]


def test_server_and_client_default_to_the_h100():
    hw = tconfig.HW
    assert (hw.peak_flops_bf16, hw.hbm_capacity) == (989e12, 80e9)
    assert tserver.HW is hw
    store = tstore.ObjectStore()
    srv = tserver.HapiServer(store)
    assert [(a.flops, a.hbm) for a in srv.accels] == [(989e12, 80e9)] * 2
    prof = t_profile_layered(tv.alexnet(10, device="meta"))
    c = tclient.HapiClient(srv, None, prof, tconfig.HapiConfig(), "alexnet")
    assert (c.accel.flops, c.accel.hbm) == (989e12, 80e9)
    b = tclient.BaselineClient(store, None, prof, has_accelerator=False)
    assert (b.accel.flops, b.accel.hbm) == (989e12 / 40.0, 80e9)
    a = tclock.Accelerator("a")
    assert (a.flops, a.hbm) == (989e12, 80e9)
    # The model's load on the virtual clock runs at the H100's HBM rate.
    store.put_dataset("d", {"x": np.zeros((10, 2), np.float32)}, object_size=10)
    srv.submit(tserver.PostRequest(0, 0, "alexnet", 3, "d/part-00000", 10, prof, 0.0))
    (r,) = srv.drain()
    flops = prof.cum_flops[3] * 10 + 1e3
    load = prof.prefix_param_bytes[3] / 3.35e12
    assert r.finished - r.started == pytest.approx(flops / (989e12 * 0.4 * 10 / 128) + load,
                                                   rel=1e-12)


# ---------------------------------------------------------------------------
# A live epoch: the port's executor on the port's server
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compress", [False, True])
def test_live_epoch_with_the_ports_executor_matches_the_reference(v5e, compress):
    """16 images in 4 objects of 4, a train batch of 8 (two POSTs an
    iteration, two iterations): the port's make_vision_executor on the port's
    server against a JAX executor on the reference's. float32 acts to 1e-4,
    int8 codes within one step and scales to 1e-4; the measured wire, and so
    the whole EpochResult, equal."""
    jvm, params, tvm = _pair("alexnet", num_classes=10)
    x = _images(16, seed=5)
    ref_prof = r_profile_layered(jvm)
    out = {}
    for m, executor in ((REF, _jax_executor(jvm, params, compress)),
                        (PORT, tts.make_vision_executor(tvm, compress=compress, device="cpu"))):
        store = m.store.ObjectStore()
        store.put_dataset("live", {"x": x}, object_size=4)
        server = _server(m, store, n_accelerators=1)
        server.register_executor("alexnet", executor)
        seen = []
        client = _client(m, server, m.clock.Link(name="wan", bandwidth=1e9 / 8),
                         _profile(m, ref_prof), _hapi(m, compress_transfer=compress),
                         "alexnet", train_fn=seen.extend)
        res = client.run_epoch("live", train_batch=8)
        out[m.name] = (res, seen, _adapted(server), client.decision.split_index)
    (res, got, ad, split), (wres, want, wad, wsplit) = out["port"], out["ref"]
    assert split == wsplit > 0 and ad == wad
    assert res.n_iterations == 2 and len(got) == len(want) == 4
    assert dataclasses.asdict(res) == dataclasses.asdict(wres)
    for g, w in zip(got, want):
        if not compress:
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)
            continue
        (q, s), (qj, sj) = g, w
        assert q.dtype == np.int8 and s.dtype == np.float32 and q.shape == qj.shape
        assert np.abs(q.astype(np.int32) - qj.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(s, sj, rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# Imports
# ---------------------------------------------------------------------------
def test_runtime_imports_no_jax_and_nothing_of_repro():
    mods = ["repro_torch.obs", "repro_torch.cos.clock", "repro_torch.cos.objectstore",
            "repro_torch.cos.weightcache", "repro_torch.cos.scheduler",
            "repro_torch.cos.server", "repro_torch.cos.client", "repro_torch.cos.network",
            "repro_torch.cos.fleet", "repro_torch.api", "repro_torch.replay"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr
