"""The port's fleet half of the HAPI control plane against the JAX package's.

``repro_torch.cos.network``, ``repro_torch.cos.fleet``, ``repro_torch.api``
and the fleet half of ``repro_torch.launch.serve`` are copies of their
``repro`` counterparts. Each scenario below is one of the reference's own
(``tests/test_network.py``, ``test_fleet.py``, ``test_api_cluster.py``,
``test_scale_core.py``, ``test_scheduler.py``, ``test_weight_cache.py`` and
the cluster cases of ``test_obs.py``), run once in each package with the
same inputs: event-log digests, streaming digests, cluster reports, metrics
snapshots, span digests and responses must be equal, float for float.

Profiles are each package's own: a cluster profiles its models itself
(``HapiCluster.profile``; the port builds them on ``device="meta"``), and
both packages' ``profile_layered`` give the same ``LayerProfile`` field for
field. Hardware figures: the reference's ``HW`` is a TPU v5e, the port's an
H100, so both packages are given the v5e's figures explicitly and the port
server's ``HW`` is patched for the model-load rate (``v5e``); where the
reference relies on its defaults (``with_servers(2)``, ``TenantSpec``'s
``client_flops`` of 65e12), the port gets those same numbers.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import types
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

try:
    import hypothesis.strategies as st
    from hypothesis import example, given, settings
except ImportError:                       # pragma: no cover - env dependent
    import _propcheck as st
    from _propcheck import given, settings

    def example(**_kw):
        return lambda f: f

import repro.api as rapi
import repro.config as rconfig
from repro.api import cluster as rcluster
from repro.core.profiler import profile_layered as r_profile_layered
from repro.cos import client as rclient
from repro.cos import clock as rclock
from repro.cos import fleet as rfleet
from repro.cos import network as rnet
from repro.cos import objectstore as rstore
from repro.cos import scheduler as rsched
from repro.cos import server as rserver
from repro.cos import weightcache as rwc
from repro.launch import serve as rserve
from repro.models import vision as rv
from repro.obs import chrome_trace as r_chrome_trace
import repro_torch.api as tapi
import repro_torch.config as tconfig
from repro_torch.api import cluster as tcluster
from repro_torch.core import tier_split as tts
from repro_torch.core.profiler import profile_layered as t_profile_layered
from repro_torch.cos import client as tclient
from repro_torch.cos import clock as tclock
from repro_torch.cos import fleet as tfleet
from repro_torch.cos import network as tnet
from repro_torch.cos import objectstore as tstore
from repro_torch.cos import scheduler as tsched
from repro_torch.cos import server as tserver
from repro_torch.cos import weightcache as twc
from repro_torch.launch import serve as tserve
from repro_torch.models import vision as tv
from repro_torch.obs import chrome_trace as t_chrome_trace
from test_scale_core import _scalar_max_min
from test_scheduler import GOLDEN_BURST, GOLDEN_EPOCH, _digest_hash
from test_torch_vision import _images, _jax_executor, _pair
from test_weight_cache import PARITY_COALESCE_1MODEL, PARITY_COALESCE_MULTI

ROOT = Path(__file__).resolve().parents[1]
TRUNK = 1e9 / 8                             # 1 Gbps, the paper's testbed rate

REF = SimpleNamespace(name="ref", api=rapi, cluster=rcluster, net=rnet, fleet=rfleet,
                      clock=rclock, store=rstore, sched=rsched, server=rserver, client=rclient, wc=rwc,
                      config=rconfig, serve=rserve, chrome_trace=r_chrome_trace,
                      profile_layered=r_profile_layered, vision=rv, meta={})
PORT = SimpleNamespace(name="port", api=tapi, cluster=tcluster, net=tnet, fleet=tfleet,
                       clock=tclock, store=tstore, sched=tsched, server=tserver, client=tclient, wc=twc,
                       config=tconfig, serve=tserve, chrome_trace=t_chrome_trace,
                       profile_layered=t_profile_layered, vision=tv, meta={"device": "meta"})

# The reference's TPU v5e figures, passed to both packages explicitly.
V5E = rconfig.HW
SERVER_HW = dict(hbm_per_accel=V5E.hbm_capacity, flops_per_accel=V5E.peak_flops_bf16)
CLIENT_HW = dict(client_flops=V5E.peak_flops_bf16, client_hbm=V5E.hbm_capacity)
SPEC_FLOPS = 65e12                          # the reference TenantSpec's default


@pytest.fixture
def v5e(monkeypatch):
    """The port server's model-load rate at the v5e's HBM bandwidth."""
    monkeypatch.setattr(tserver, "HW", V5E)


@functools.lru_cache(maxsize=None)
def _prof_of(side: str, name: str = "alexnet", n_classes: int = 100):
    m = REF if side == "ref" else PORT
    return m.profile_layered(m.vision.PAPER_MODELS[name](n_classes, **m.meta))


def _prof(m, name="alexnet", n_classes=100):
    return _prof_of(m.name, name, n_classes)


def _hapi(m, **kw):
    """HapiConfig of ``m``'s package with the reference's defaults."""
    h = rconfig.HapiConfig(**kw)
    return h if m is REF else tconfig.HapiConfig(**dataclasses.asdict(h))


def _cluster(m, seed=0, n_servers=2, **server_kw):
    return m.api.HapiCluster(seed=seed).with_servers(n_servers, **{**SERVER_HW, **server_kw})


def _spec(m, hapi=None, **kw):
    kw = {"client_flops": SPEC_FLOPS, "client_hbm": V5E.hbm_capacity, **kw}
    return m.api.TenantSpec(hapi=_hapi(m, **(hapi or {})), **kw)


def _resp(r):
    return (r.req_id, r.tenant, r.object_name, r.act_bytes, r.cos_batch, r.arrival,
            r.started, r.finished, r.server_id, r.span_id, r.delivered)


def _rec(c, responses=None, **extra):
    """Everything observable of a cluster's run."""
    out = {"events": c.event_digest(), "stream": c.sim.log.stream_digest(),
           "report": c.report().as_dict(), "metrics": c.metrics().snapshot(),
           "spans": c.tracer.digest(), "now": c.sim.now, **extra}
    if responses is not None:
        out["responses"] = [_resp(r) for r in responses]
    return out


def _fleet_rec(fleet, responses=None, **extra):
    out = {"events": fleet.sim.log.digest(), "stream": fleet.sim.log.stream_digest(),
           "metrics": fleet.sim.metrics.snapshot(), "spans": fleet.sim.tracer.digest(),
           "reissued": fleet.reissued, "served": dict(fleet.served_by_server),
           "tenants": {t: dataclasses.asdict(s) for t, s in sorted(fleet.tenant_stats.items())},
           "scale": fleet.scale_events(), "n_alive": fleet.n_alive,
           "makespan": fleet.makespan(), **extra}
    if responses is not None:
        out["responses"] = [_resp(r) for r in responses]
    return out


def _epoch(res):
    return dataclasses.asdict(res)


def _raises(fn):
    try:
        fn()
    except Exception as e:              # the exception is part of the record
        return (type(e).__name__, str(e))
    return None


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------------------
# Network fabric (tests/test_network.py)
# ---------------------------------------------------------------------------
@scenario
def net_single_flow_port_vs_link(m):
    sim_a = m.clock.Simulator(0)
    link = m.clock.Link(name="wan0", bandwidth=125e6).attach(sim_a)
    sim_b = m.clock.Simulator(0)
    fabric = m.net.NetworkFabric(m.net.NetworkSpec(trunk_bandwidth=125e6), sim=sim_b)
    port = fabric.tenant_port(0, bandwidth=125e6)
    out = []
    for t, nbytes in [(0.0, 5e6), (0.01, 3e7), (10.0, 1e5), (10.0, 2e6)]:
        a, b = link.transfer(t, nbytes), port.transfer(t, nbytes)
        assert a == b
        out.append(b)
    assert sim_a.log.digest() == sim_b.log.digest()
    return out, sim_b.log.digest(), port.busy_until, port.busy_time


def _single_tenant(m, network):
    c = _cluster(m, 3, 2, n_accelerators=2, flops_per_accel=65e12).with_dataset(
        "ds", n_samples=2000, object_size=500, n_classes=100)
    if network:
        c.with_network(m.net.NetworkSpec(trunk_bandwidth=TRUNK))
    t = c.tenant(_spec(m, model="alexnet", n_classes=100,
                       hapi={"network_bandwidth": TRUNK}))
    res = t.run_epoch("ds", train_batch=500)
    return _rec(c, epoch=_epoch(res))


@scenario
def net_single_tenant_without_fabric(m):
    return _single_tenant(m, False)


@scenario
def net_single_tenant_on_fabric(m):
    rec = _single_tenant(m, True)
    assert rec["events"] == _single_tenant(m, False)["events"]
    return rec


def _micro(m, trunk=100.0):
    return m.net.NetworkFabric(m.net.NetworkSpec(trunk_bandwidth=trunk), sim=m.clock.Simulator(0))


def _concurrent(m, ports_spec, flows):
    fabric = _micro(m)
    ports = [fabric.tenant_port(i, bandwidth=bw, latency=lat, weight=w)
             for i, (bw, lat, w) in enumerate(ports_spec)]
    out = fabric.transfer_concurrent([(ports[p], *rest) for p, *rest in flows])
    return (out, [(p.busy_until, p.busy_time, p.observed_bw) for p in ports],
            fabric.sim.log.digest())


@scenario
def net_two_equal_flows(m):
    return _concurrent(m, [(100.0, 0.0, 1.0)] * 2, [(0, 0.0, 1000.0), (1, 0.0, 1000.0)])


@scenario
def net_three_equal_flows(m):
    return _concurrent(m, [(100.0, 0.0, 1.0)] * 3, [(i, 0.0, 1000.0) for i in range(3)])


@scenario
def net_max_min_port_caps(m):
    return _concurrent(m, [(20.0, 0.0, 1.0), (100.0, 0.0, 1.0)],
                       [(0, 0.0, 1000.0), (1, 0.0, 1000.0)])


@scenario
def net_rates_recompute_at_start_and_finish(m):
    return _concurrent(m, [(100.0, 0.0, 1.0)] * 2, [(0, 0.0, 2000.0), (1, 10.0, 1000.0)])


@scenario
def net_same_port_batch(m):
    return _concurrent(m, [(100.0, 0.0, 1.0)], [(0, 0.0, 1000.0), (0, 0.0, 1000.0)])


@scenario
def net_weighted_2_to_1(m):
    return _concurrent(m, [(100.0, 0.0, 2.0), (100.0, 0.0, 1.0)],
                       [(0, 0.0, 1000.0), (1, 0.0, 1000.0)])


@scenario
def net_weighted_port_cap(m):
    return _concurrent(m, [(20.0, 0.0, 4.0), (100.0, 0.0, 1.0)],
                       [(0, 0.0, 1000.0), (1, 0.0, 1000.0)])


@scenario
def net_per_request_weight(m):
    return _concurrent(m, [(100.0, 0.0, 1.0)], [(0, 0.0, 1000.0, 2.0), (0, 0.0, 1000.0, 1.0)])


@scenario
def net_weight_one_explicit(m):
    implicit = _concurrent(m, [(70.0, 1e-3, 1.0)] * 3, [(i, 0.0, 1000.0) for i in range(3)])
    explicit = _concurrent(m, [(70.0, 1e-3, 1.0)] * 3,
                           [(i, 0.0, 1000.0, 1.0) for i in range(3)])
    assert implicit == explicit
    return implicit


@scenario
def net_pruned_history_and_committed_profiles(m):
    fabric = _micro(m)
    p0 = fabric.tenant_port(0, bandwidth=100.0, latency=0.0)
    out = [p0.transfer(0.0, 1000.0), p0.transfer(10.0, 1000.0)]
    p1 = fabric.tenant_port(1, bandwidth=100.0, latency=0.0)
    out.append(p1.transfer(0.0, 1000.0))
    p2 = fabric.tenant_port(2, bandwidth=100.0, latency=0.0)
    out.append(p2.transfer(0.0, 500.0))
    return (out, [fabric.effective_bandwidth(i) for i in range(3)],
            fabric.sim.log.digest(), fabric.trunk.capacity)


def _reads(out):
    return [(o.name, o.nbytes, o.n_samples, t) for o, t in out]


def _one_node_store(m, sim=None, trunk=1e12, storage_trunk=None, n_nodes=1):
    store = m.store.ObjectStore(n_storage_nodes=n_nodes, replication=1,
                                internal_bandwidth=100.0)
    store.put_dataset("ds", {"x": np.zeros((2, 1), np.float32)}, object_size=1)
    for o in store.objects.values():
        o.nbytes = 1000
    if sim is not None:
        store.attach_sim(sim)
    spec = m.net.NetworkSpec(trunk_bandwidth=trunk, storage_trunk_bandwidth=storage_trunk)
    store.use_fabric(m.net.NetworkFabric(spec, sim=sim))
    return store


@scenario
def net_storage_batch_window(m):
    store = _one_node_store(m)
    out = store.read_batch(store.object_names("ds"), 0.0, [2.0, 1.0])
    assert out is not None
    return _reads(out), store.nodes[0].latency


@scenario
def net_drain_round_batches_weighted_reads(m):
    sim = m.clock.Simulator(0)
    store = _one_node_store(m, sim=sim)
    server = m.server.HapiServer(store, n_accelerators=2, sim=sim, **SERVER_HW)
    for i, (oname, w) in enumerate(zip(store.object_names("ds"), [2.0, 1.0])):
        server.submit(m.server.PostRequest(
            req_id=i + 1, tenant=i, model_key="m", split=3, object_name=oname, b_max=100,
            profile=_prof(m), arrival=0.0, network_weight=w))
    responses = server.drain()
    assert len(responses) == 2
    return [_resp(r) for r in responses], sim.log.digest(), sim.tracer.digest()


@scenario
def net_read_batch_declines_without_sharing(m):
    plain = m.store.ObjectStore(n_storage_nodes=2, replication=1)
    plain.put_dataset("ds", {"x": np.zeros((2, 1), np.float32)}, object_size=1)
    fab = _one_node_store(m, n_nodes=2)
    trunked = _one_node_store(m, n_nodes=2, storage_trunk=5e9)
    return (plain.read_batch(plain.object_names("ds"), 0.0),
            fab.read_batch(fab.object_names("ds"), 0.0),
            _reads(trunked.read_batch(trunked.object_names("ds"), 0.0)))


@scenario
def net_fabric_aware_routing(m):
    c = (_cluster(m, 0, 2, n_accelerators=2).with_storage(n_nodes=2, replication=2)
         .with_dataset("ds", n_samples=1000, object_size=500, n_classes=100)
         .with_network(m.net.NetworkSpec(trunk_bandwidth=TRUNK))
         .with_routing(m.api.FabricAwareRouting()))
    fleet = c.fleet
    req = m.server.PostRequest(req_id=1, tenant=0, model_key="alexnet", split=3,
                               object_name=c.store.object_names("ds")[0], b_max=100,
                               profile=_prof(m), arrival=0.0)
    first = fleet.routing.route(fleet, req, fleet.servers).server_id
    c.store.nodes[0].busy_until = 50.0
    return first, fleet.routing.route(fleet, req, fleet.servers).server_id


@scenario
def net_fabric_aware_scaling(m):
    c = (_cluster(m, 0, 2, n_accelerators=2)
         .with_dataset("ds", n_samples=2000, object_size=500, n_classes=100)
         .with_network(m.net.NetworkSpec(trunk_bandwidth=TRUNK)))
    fleet = c.fleet
    t = c.tenant(_spec(m, model="alexnet", n_classes=100, hapi={"network_bandwidth": TRUNK}))
    c.submit_burst("ds", "alexnet", tenant=t.tenant_id, train_batch=500, n_classes=100)
    policy = m.api.FabricAwareScaling(scale_up_depth=0.5, max_servers=8)
    port = next(p for p in c.fabric.ports.values() if p.tenant == t.tenant_id)
    port.observed_bw = c.fabric.trunk.capacity
    held = policy.decide(fleet)
    port.observed_bw = 0.1 * c.fabric.trunk.capacity
    grown = policy.decide(fleet)
    plain = _cluster(m, 1, 2).with_dataset("ds", n_samples=1000, object_size=500,
                                           n_classes=100)
    plain.submit_burst("ds", "alexnet", tenant=0, train_batch=500, n_classes=100)
    assert (held, grown) == (0, 1)
    return held, grown, m.api.FabricAwareScaling(scale_up_depth=0.5).decide(plain.fleet), \
        c.event_digest()


def _contended(m, seed, n_tenants, resplit_every=1, weight=None):
    c = (_cluster(m, seed, 2, n_accelerators=2, flops_per_accel=197e12)
         .with_dataset("ds", n_samples=2000, object_size=500, n_classes=100)
         .with_network(m.net.NetworkSpec(trunk_bandwidth=TRUNK)))
    handles = [c.tenant(_spec(m, model="alexnet", n_classes=100, client_flops=197e12,
                              hapi={"network_bandwidth": TRUNK}, resplit_every=resplit_every,
                              **({"network_weight": weight} if weight else {})))
               for _ in range(n_tenants)]
    results = c.run_epochs([(h, "ds", 500) for h in handles])
    return _rec(c, epochs=[_epoch(r) for r in results],
                ewma=[c.fabric.effective_bandwidth(h.tenant_id) for h in handles])


@scenario
def net_contended_three_tenants(m):
    rec = _contended(m, 11, 3)
    assert len(rec["events"]) > 50
    return rec


@scenario
def net_split_migrates_under_contention(m):
    solo, pair = _contended(m, 0, 1), _contended(m, 0, 2)
    assert solo["epochs"][0]["resplits"] == 0
    assert any(e["resplits"] >= 1 for e in pair["epochs"])
    assert any(e["split"] > solo["epochs"][0]["split"] for e in pair["epochs"])
    return solo, pair


@scenario
def net_four_tenants_fair_share(m):
    return _contended(m, 0, 4)


@scenario
def net_weight_one_cluster_equals_default(m):
    rec = _contended(m, 7, 3, weight=1.0)
    assert rec["events"] == _contended(m, 7, 3)["events"]
    return rec


@scenario
def net_gold_and_bronze_tenants(m):
    c = (_cluster(m, 5, 2, n_accelerators=2, flops_per_accel=197e12)
         .with_dataset("ds", n_samples=2000, object_size=500, n_classes=100)
         .with_network(m.net.NetworkSpec(trunk_bandwidth=TRUNK)))
    handles = [c.tenant(_spec(m, model="alexnet", n_classes=100, client_flops=197e12,
                              hapi={"network_bandwidth": TRUNK}, resplit_every=2,
                              network_weight=w, compute_weight=cw))
               for w, cw in ((2.0, None), (1.0, 4.0))]
    results = c.run_epochs([(h, "ds", 500) for h in handles])
    return _rec(c, epochs=[_epoch(r) for r in results])


@scenario
def net_run_concurrently_order(m):
    order = []

    class FakeRun:
        def __init__(self, name, steps):
            self.name, self.t, self.steps = name, 0.0, steps

        @property
        def done(self):
            return not self.steps

        def step(self):
            self.t += self.steps.pop(0)
            order.append(self.name)

        def result(self):
            return self.name

    out = m.net.run_concurrently([FakeRun("a", [5.0, 5.0]), FakeRun("b", [2.0, 2.0, 2.0])])
    return out, order


@scenario
def net_measure_trunk_shares(m):
    return (m.net.measure_trunk_shares([2.0, 1.0], 100.0, nbytes=1000.0),
            m.net.measure_trunk_shares([4.0, 1.0], 1e9 / 8))


# ---------------------------------------------------------------------------
# HapiFleet (tests/test_fleet.py)
# ---------------------------------------------------------------------------
def _store(m, n=4000, obj=500):
    return m.store.synthetic_image_store("ds", n_samples=n, object_size=obj, n_classes=100)


def _fleet(m, store, **kw):
    return m.fleet.HapiFleet(store, **{**SERVER_HW, **kw})


def _burst(m, fleet, objects, tenants=(0,), split=5, b_max=500, rid0=0):
    rid = rid0
    for t in tenants:
        for oname in objects:
            rid += 1
            fleet.submit(m.server.PostRequest(rid, t, "alexnet", split, oname, b_max,
                                              _prof(m), 0.0))
    return rid - rid0


@scenario
def fleet_two_tenant_epochs(m):
    fleet = _fleet(m, _store(m), n_servers=3, seed=7)
    epochs = []
    for t in range(2):
        link = m.clock.Link(name=f"wan{t}", bandwidth=1e9 / 8)
        c = m.client.HapiClient(fleet, link, _prof(m), _hapi(m), "alexnet", tenant=t,
                                **CLIENT_HW)
        epochs.append(_epoch(c.run_epoch("ds", train_batch=2000, max_iterations=2)))
    return _fleet_rec(fleet, epochs=epochs)


@scenario
def fleet_kill_mid_epoch_reissues(m):
    store = _store(m)
    fleet = _fleet(m, store, n_servers=3, seed=0)
    objects = store.object_names("ds")
    n = _burst(m, fleet, objects, tenants=(0, 1))
    fleet.dispatch()
    fleet.kill(1)
    responses = fleet.drain()
    assert len(responses) == n and fleet.reissued >= 1
    fleet.restart(1)
    _burst(m, fleet, objects[:3], tenants=(0,), rid0=10_000)
    return _fleet_rec(fleet, responses + fleet.drain())


@scenario
def fleet_kill_restart_before_drain(m):
    store = _store(m, n=2000)
    fleet = _fleet(m, store, n_servers=2, seed=0)
    _burst(m, fleet, store.object_names("ds"), tenants=(0, 1))
    fleet.dispatch()
    fleet.kill(1)
    fleet.restart(1)
    return _fleet_rec(fleet, fleet.drain())


@scenario
def fleet_kill_all_raises(m):
    store = _store(m, n=1000)
    fleet = _fleet(m, store, n_servers=2, seed=0)
    _burst(m, fleet, store.object_names("ds"))
    fleet.dispatch()
    fleet.kill(0)
    fleet.kill(1)
    errs = (_raises(fleet.drain), _raises(lambda: fleet.submit(m.server.PostRequest(
        99, 0, "alexnet", 5, "ds/part-00000", 500, _prof(m), 0.0))))
    assert errs[0][0] == errs[1][0] == "ConnectionError"
    return errs, _fleet_rec(fleet)


@scenario
def fleet_scheduled_kill(m):
    store = _store(m)
    fleet = _fleet(m, store, n_servers=2, seed=0)
    fleet.sim.schedule(1e-4, "chaos", callback=lambda: fleet.kill(0))
    _burst(m, fleet, store.object_names("ds"), tenants=(0, 1))
    first = fleet.drain()
    _burst(m, fleet, store.object_names("ds")[:2], rid0=50_000)
    return _fleet_rec(fleet, first + fleet.drain())


@scenario
def fleet_equal_demand_fairness(m):
    store = _store(m, n=8000)
    fleet = _fleet(m, store, n_servers=2, seed=0, n_accelerators=2)
    _burst(m, fleet, store.object_names("ds"), tenants=(0, 1))
    return _fleet_rec(fleet, fleet.drain())


@scenario
def fleet_fair_queueing_interleaves(m):
    store = _store(m, n=8000)
    objects = store.object_names("ds")
    fleet = _fleet(m, store, n_servers=1, seed=0)
    _burst(m, fleet, objects, tenants=(0,))
    _burst(m, fleet, objects[:4], tenants=(1,), rid0=5000)
    return _fleet_rec(fleet, fleet.drain())


@scenario
def fleet_replica_aware_spread(m):
    store = _store(m, n=8000)
    fleet = _fleet(m, store, n_servers=4, seed=0)
    _burst(m, fleet, store.object_names("ds"), tenants=(0, 1, 2))
    return _fleet_rec(fleet, fleet.drain())


@scenario
def fleet_autoscaler_up_and_down(m):
    store = _store(m, n=8000)
    policy = m.fleet.AutoscalePolicy(min_servers=1, max_servers=4, scale_up_depth=2.0,
                                     scale_down_depth=0.75, cooldown_rounds=0)
    fleet = _fleet(m, store, n_servers=1, seed=0, autoscale=policy)
    _burst(m, fleet, store.object_names("ds"), tenants=(0, 1))
    first = fleet.drain()
    _burst(m, fleet, store.object_names("ds")[:1], rid0=90_000)
    rec = _fleet_rec(fleet, first + fleet.drain())
    kinds = [e[1] for e in rec["scale"]]
    assert "scale-up" in kinds and "scale-down" in kinds
    return rec


@scenario
def fleet_scale_down_cordons_and_drains(m):
    store = _store(m, n=8000)
    fleet = _fleet(m, store, n_servers=2, seed=0)
    objects = store.object_names("ds")
    _burst(m, fleet, objects, tenants=(0, 1))
    fleet.dispatch()
    victim = fleet.remove_server()
    cordoned = (victim.server_id, sorted(fleet.cordoned), len(victim.queue))
    _burst(m, fleet, objects[:3], tenants=(0,), rid0=70_000)
    fleet.dispatch()
    return _fleet_rec(fleet, fleet.drain(), cordoned=cordoned,
                      after=(victim.alive, sorted(fleet.cordoned)))


@scenario
def fleet_scale_up_uncordons(m):
    store = _store(m, n=2000)
    fleet = _fleet(m, store, n_servers=2, seed=0)
    _burst(m, fleet, store.object_names("ds"), tenants=(0,))
    fleet.dispatch()
    victim = fleet.remove_server()
    s = fleet.add_server()
    assert s.server_id == victim.server_id
    floor = _fleet(m, _store(m, n=1000), n_servers=2, seed=0)
    return _fleet_rec(fleet, fleet.drain()), (floor.remove_server() is not None,
                                              floor.remove_server())


@scenario
def fleet_four_replicas_beat_one(m):
    def makespan(n_servers):
        store = _store(m, n=8000)
        fleet = _fleet(m, store, n_servers=n_servers, seed=0, n_accelerators=2,
                       flops_per_accel=65e12)
        _burst(m, fleet, store.object_names("ds"), tenants=(0, 1, 2), split=13, b_max=200)
        return max(r.finished for r in fleet.drain())

    out = makespan(4), makespan(1)
    assert out[0] < out[1]
    return out


@scenario
def fleet_accel_utilization(m):
    store = _store(m, n=2000)
    fleet = _fleet(m, store, n_servers=2)
    before = fleet.accel_utilization()
    for i, oname in enumerate(store.object_names("ds")):
        fleet.submit(m.server.PostRequest(i, 0, "alexnet", 5, oname, 500, _prof(m), 0.0))
    return before, _fleet_rec(fleet, fleet.drain()), fleet.accel_utilization()


@scenario
def fleet_dispatch_failure_requeues(m):
    store = _store(m, n=2000)
    fleet = _fleet(m, store, n_servers=2)
    for i, oname in enumerate(store.object_names("ds")):
        fleet.submit(m.server.PostRequest(i, 0, "alexnet", 5, oname, 500, _prof(m), 0.0))
    fleet.servers[0].kill()
    fleet.servers[1].kill()
    err = _raises(fleet.dispatch)
    pending = fleet.scheduler.pending_total()
    fleet.restart(0)
    return err, pending, _fleet_rec(fleet, fleet.drain())


@scenario
def fleet_coalesce_moves(m):
    out = []
    for warm_busy, cold_busy, n in ((0.5, 5.0, 2), (5.0, 0.0, 4)):
        store = _store(m, n=2000)
        fleet = _fleet(m, store, n_servers=2, n_accelerators=1,
                       scheduler=m.api.ComputeScheduler(coalescing=True))
        s0, s1 = fleet.servers
        s0.leases.append(m.server._Lease(end=10.0, nbytes=0.0, accel=0, model_key="alexnet",
                                         split=5))
        s0.accels[0].busy_until = warm_busy
        s1.accels[0].busy_until = cold_busy
        for i, oname in enumerate(store.object_names("ds")[:n]):
            req = m.server.PostRequest(i, 0, "alexnet", 5, oname, 500, _prof(m), 0.0)
            s1.submit(req)
            fleet._inflight[req.req_id] = 1
        out.append((fleet.scheduler.coalesce(fleet), len(s0.queue), len(s1.queue),
                    dict(fleet._inflight), fleet.sim.log.digest()))
    return out


@scenario
def fleet_deprecated_fair_queueing(m):
    store = _store(m, n=500)
    with pytest.warns(DeprecationWarning):
        f = m.fleet.HapiFleet(store, fair_queueing=False)
    with pytest.warns(DeprecationWarning):
        c = m.api.HapiCluster(seed=0).with_fair_queueing(False)
    c.with_dataset("ds", n_samples=500, object_size=500, n_classes=100)
    return (type(f.scheduler.policy).__name__, f.fair_queueing,
            type(c.fleet.scheduler.policy).__name__,
            type(m.fleet.HapiFleet(store).scheduler.policy).__name__)


# ---------------------------------------------------------------------------
# HapiCluster and its policies (tests/test_api_cluster.py, test_scheduler.py)
# ---------------------------------------------------------------------------
COMBOS = [(r, p, s) for r in ("ReplicaAwareRouting", "LeastLoadedRouting")
          for p in ("RoundRobinPlacement", "DemandAwarePlacement")
          for s in ("QueueDepthScaling", "SloScaling")]


def _policy_cluster(m, seed, routing, placement, scaling, replication=2):
    api = m.api
    return (_cluster(m, seed, 2).with_storage(n_nodes=4, replication=replication)
            .with_dataset("ds", n_samples=2000, object_size=500, n_classes=100)
            .with_policies(routing=getattr(api, routing)(), placement=getattr(api, placement)(),
                           scaling=getattr(api, scaling)(max_servers=4) if scaling else None))


def _combo_drain(combo):
    def run(m):
        c = _policy_cluster(m, 11, *combo)
        c.submit_burst("ds", "alexnet", tenant=0, n_classes=100)
        c.submit_burst("ds", "alexnet", tenant=1, n_classes=100)
        rec = _rec(c, c.drain())
        assert len(rec["events"]) > 20
        return rec
    return run


def _combo_kill(combo):
    def run(m):
        c = _policy_cluster(m, 0, *combo)
        for t in (0, 1):
            c.submit_burst("ds", "alexnet", tenant=t, n_classes=100)
        c.fleet.dispatch()
        victim = next(s for s in c.fleet.servers if s.queue)
        c.kill(victim.server_id)
        c.restart(victim.server_id)
        rec = _rec(c, c.drain())
        assert rec["report"]["reissued"] >= 1
        return rec
    return run


for _combo in COMBOS:
    SCENARIOS["cluster_drain_" + "_".join(_combo)] = _combo_drain(_combo)
    SCENARIOS["cluster_kill_restart_" + "_".join(_combo)] = _combo_kill(_combo)


@scenario
def cluster_routing_policies_differ(m):
    def run(routing):
        c = _policy_cluster(m, 3, routing, "RoundRobinPlacement", None, replication=1)
        for t in (0, 1):
            c.submit_burst("ds", "alexnet", tenant=t, n_classes=100)
        c.drain()
        return c.event_digest()

    a, b = run("ReplicaAwareRouting"), run("LeastLoadedRouting")
    assert a != b
    return a, b


@scenario
def cluster_hash_and_warm_routing(m):
    out = []
    for routing in ("hash", "warm", "fabric-aware"):
        c = (_cluster(m, 4, 3).with_dataset("ds", n_samples=3000, object_size=500,
                                            n_classes=100)
             .with_routing(m.api.ROUTING_POLICIES[routing]()))
        for t in range(3):
            c.submit_burst("ds", "alexnet", tenant=t, n_classes=100)
        out.append(_rec(c, c.drain()))
    return out


@scenario
def cluster_demand_aware_re_replicates(m):
    c = (_cluster(m, 0, 1).with_storage(n_nodes=4, replication=1)
         .with_dataset("ds", n_samples=2000, object_size=500, n_classes=100)
         .with_placement(m.api.DemandAwarePlacement(hot_threshold=1))
         .with_scaling(m.api.QueueDepthScaling(max_servers=4, scale_up_depth=1.0,
                                               cooldown_rounds=0)))
    for t in range(3):
        c.submit_burst("ds", "alexnet", tenant=t, n_classes=100)
    rec = _rec(c, c.drain())
    reps = {o: c.store.replicas(o) for o in c.store.object_names("ds")}
    assert any(len(r) > 1 for r in reps.values())
    return rec, reps


@scenario
def cluster_demand_decay_drops_cold(m):
    policy = m.api.DemandAwarePlacement(hot_threshold=1, half_life=0.5, cold_threshold=0.5)
    c = (_cluster(m, 0, 1).with_storage(n_nodes=4, replication=1)
         .with_dataset("ds", n_samples=2000, object_size=500, n_classes=100)
         .with_placement(policy))
    for t in range(3):
        c.submit_burst("ds", "alexnet", tenant=t, n_classes=100)
    rec = _rec(c, c.drain())
    grown = {o: c.store.replicas(o) for o in c.store.object_names("ds")}
    c.fleet._vtime += 1000.0
    c.fleet._re_replicate()
    return rec, grown, {o: c.store.replicas(o) for o in c.store.object_names("ds")}, \
        c.event_digest(), dict(policy.demand)


@scenario
def cluster_learned_placement(m):
    c = (_cluster(m, 2, 2).with_storage(n_nodes=4, replication=1)
         .with_dataset("ds", n_samples=3000, object_size=250, n_classes=100)
         .with_placement(m.api.LearnedPlacement(window=1.0, hot_score=0.1, cold_score=0.05)))
    for t in range(3):
        c.submit_burst("ds", "alexnet", tenant=t, n_classes=100)
    return _rec(c, c.drain())


@scenario
def cluster_slo_scaling_on_misses(m):
    c = (_cluster(m, 0, 1).with_dataset("ds", n_samples=4000, object_size=500, n_classes=100)
         .with_scaling(m.api.SloScaling(slo_delay=1e-4, up_miss_rate=0.1, max_servers=4,
                                        cooldown_rounds=0)))
    for t in (0, 1):
        c.submit_burst("ds", "alexnet", tenant=t, n_classes=100)
    rec = _rec(c, c.drain())
    assert rec["report"]["n_servers"] > 1
    return rec


def _slo_util(util):
    def run(m):
        c = (_cluster(m, 0, 1).with_dataset("ds", n_samples=4000, object_size=500,
                                            n_classes=100)
             .with_scaling(m.api.SloScaling(slo_delay=1e9, util_scale_up=util, max_servers=3,
                                            cooldown_rounds=0)))
        for _ in range(2):
            for t in (0, 1):
                c.submit_burst("ds", "alexnet", tenant=t, n_classes=100)
            c.drain()
        return _rec(c)
    return run


SCENARIOS["cluster_slo_scaling_on_utilization"] = _slo_util(0.05)
SCENARIOS["cluster_slo_scaling_utilization_off"] = _slo_util(0.0)


@scenario
def cluster_tenant_handles_and_epochs(m):
    c = _cluster(m, 0, 2, n_accelerators=2, flops_per_accel=65e12).with_dataset(
        "imagenet", n_samples=2000, n_classes=100)
    t0 = c.tenant(_spec(m, model="alexnet", n_classes=100, bandwidth=1e9 / 8))
    t1 = c.tenant(_spec(m, model="alexnet", n_classes=100, bandwidth=1e9 / 8))
    r0 = t0.run_epoch("imagenet", train_batch=1000, max_iterations=1)
    r1 = t1.run_epoch("imagenet", train_batch=1000, max_iterations=1)
    return _rec(c, ids=(t0.tenant_id, t1.tenant_id), epochs=[_epoch(r0), _epoch(r1)],
                stats=[dataclasses.asdict(t.stats()) for t in (t0, t1)],
                split=dataclasses.asdict(t0.choose_split(1000)))


@scenario
def cluster_mixed_tenant_and_burst_ids(m):
    c = _cluster(m, 0, 2, n_accelerators=2, flops_per_accel=65e12).with_dataset(
        "ds", n_samples=2000, object_size=500, n_classes=100)
    ids = c.submit_burst("ds", "alexnet", tenant=5, n_classes=100)
    h = c.tenant(_spec(m, model="alexnet", n_classes=100, bandwidth=1e9 / 8))
    res = h.run_epoch("ds", train_batch=1000, max_iterations=2)
    return _rec(c, ids=ids, epoch=_epoch(res))


@scenario
def cluster_seed_controls_trace(m):
    def run(seed):
        c = _cluster(m, seed, 2).with_dataset("ds", n_samples=1000, object_size=500,
                                              n_classes=100)
        c.submit_burst("ds", "alexnet", tenant=0, n_classes=100)
        c.drain()
        return c.event_digest()

    a, b = run(4), run(9)
    assert a == run(4) and a != b
    return a, b


@scenario
def cluster_topology_frozen_after_build(m):
    c = _cluster(m, 0, 2)
    c.build()
    errs = [_raises(lambda: c.with_servers(4)),
            _raises(lambda: c.with_routing(m.api.LeastLoadedRouting()))]
    c.with_dataset("late", n_samples=500, object_size=500, n_classes=100)
    return errs, c.store.object_names("late"), dataclasses.asdict(
        c.split_for("alexnet", 1000, n_classes=100))


@scenario
def cluster_submit_request_open_loop(m):
    c = (_cluster(m, 6, 2).with_dataset("ds", n_samples=2000, object_size=250, n_classes=100)
         .with_scaling(m.api.QueueDepthScaling(max_servers=3, scale_up_depth=1.0,
                                               cooldown_rounds=0)))
    c.build()
    objs = c.store.object_names("ds")
    models = ["alexnet", "resnet18", "vgg11"]
    ids = [c.submit_request(objs[i % len(objs)], models[i % 3], tenant=i % 3,
                            arrival=0.3 * i, n_classes=100, train_batch=500,
                            compute_weight=1.0 + (i % 2))
           for i in range(12)]
    return _rec(c, c.drain(), ids=ids, err=_raises(lambda: c.submit_request(
        objs[0], "alexnet", tenant=0, compute_weight=0.0, n_classes=100)))


@scenario
def cluster_lm_profile_catalog(m):
    c = _cluster(m, 1, 2, n_accelerators=2).with_dataset("ds", n_samples=1000,
                                                         object_size=250, n_classes=100)
    for t, arch in enumerate(("mamba2-1.3b", "qwen3-32b")):
        c.submit_burst("ds", arch, tenant=t, train_batch=500)
    return _rec(c, c.drain(), profile=dataclasses.asdict(c.profile("qwen3-32b")))


@scenario
def golden_burst(m):
    c = (_cluster(m, 11, 2).with_storage(n_nodes=4, replication=2)
         .with_dataset("ds", n_samples=2000, object_size=500, n_classes=100))
    c.submit_burst("ds", "alexnet", tenant=0, n_classes=100)
    c.submit_burst("ds", "alexnet", tenant=1, n_classes=100)
    c.drain()
    assert _digest_hash(c.event_digest()) == GOLDEN_BURST
    return _rec(c)


@scenario
def golden_epoch(m):
    c = _cluster(m, 3, 2, n_accelerators=2, flops_per_accel=65e12).with_dataset(
        "imagenet", n_samples=2000, n_classes=100)
    t = c.tenant(_spec(m, model="alexnet", bandwidth=1e9 / 8, n_classes=100))
    res = t.run_epoch("imagenet", train_batch=1000, max_iterations=2)
    assert _digest_hash(c.event_digest()) == GOLDEN_EPOCH
    return _rec(c, epoch=_epoch(res))


def _coalescing(m, seed, n_servers, n_accel, n_samples, models, **kw):
    c = (_cluster(m, seed, n_servers, n_accelerators=n_accel, flops_per_accel=65e12, **kw)
         .with_dataset("ds", n_samples=n_samples, object_size=500, n_classes=100)
         .with_scheduler(coalescing=True))
    for t, model in enumerate(models):
        c.submit_burst("ds", model, tenant=t, n_classes=100)
    return c, c.drain()


@scenario
def golden_coalesce_one_model(m):
    c, responses = _coalescing(m, 0, 2, 1, 4000, ["alexnet", "alexnet"])
    assert _digest_hash(c.event_digest()) == PARITY_COALESCE_1MODEL
    return _rec(c, responses)


@scenario
def golden_coalesce_multi_model(m):
    c, responses = _coalescing(m, 7, 3, 2, 3000, ["alexnet", "resnet18", "alexnet", "vgg11"])
    assert _digest_hash(c.event_digest()) == PARITY_COALESCE_MULTI
    return _rec(c, responses)


@scenario
def cluster_coalescing_tight_hbm(m):
    prof = _prof(m)
    one_req = prof.prefix_param_bytes[5] + 40 * prof.act_peak_bytes[5] * (1 + prof.headroom)
    c, responses = _coalescing(m, 0, 2, 1, 3000, ["alexnet"] * 3, hbm_per_accel=one_req * 1.5)
    sched = c.fleet.scheduler
    return _rec(c, responses, adapt=[([tuple(a) for a in r.assignments], list(r.dropped))
                                     for r in c.fleet.adapt_results],
                legacy=(sched.reload_bytes, sched.reload_saved_bytes, sched.coalesced))


@scenario
def cluster_accel_share_by_compute_weight(m):
    c = _cluster(m, 0, 1, n_accelerators=2, flops_per_accel=65e12).with_dataset(
        "ds", n_samples=2000, object_size=125, n_classes=100)
    for t, w in enumerate([4.0, 1.0]):
        c.submit_burst("ds", "alexnet", tenant=t, n_classes=100, compute_weight=w)
    responses = c.drain()
    return _rec(c, responses, share=m.sched.windowed_accel_share(responses, 2))


# ---------------------------------------------------------------------------
# Warm-weight cache through the cluster (tests/test_weight_cache.py)
# ---------------------------------------------------------------------------
def _warm_cell(m, seed=0, *, window=2.0, policy="lru", n_servers=2, n_bursts=6, spread=1.5):
    c = (_cluster(m, seed, n_servers, n_accelerators=1, flops_per_accel=65e12)
         .with_dataset("ds", n_samples=2000, object_size=250, n_classes=100)
         .with_scheduler(coalescing=True)
         .with_weight_cache(window=window, policy=policy)
         .with_routing(m.api.WarmAwareRouting()))
    c.build()
    objs = c.store.object_names("ds")
    models = ["alexnet", "resnet18", "vgg11"]
    for i in range(n_bursts):
        c.submit_request(objs[i % len(objs)], models[i % len(models)], tenant=i % 2,
                         arrival=i * spread, n_classes=100, train_batch=500)
        c.drain()
    c.drain()
    wc = c.weight_cache
    return _rec(c, cache=(wc.evictions, wc.warm_hits, wc.evicted, wc.evicted_bytes,
                          wc.retained_bytes, wc.resident_bytes(), dict(wc.peak_resident)))


for _args in ((0, 2.0, "lru", 2, 6, 1.5), (3, 1.0, "lru", 2, 10, 1.5),
              (1, 0.5, "demand", 2, 12, 1.2), (0, 50.0, "demand", 1, 10, 1.2)):
    SCENARIOS["warm_cell_seed{}_window{}_{}_{}servers".format(*_args[:4])] = functools.partial(
        lambda m, a: _warm_cell(m, a[0], window=a[1], policy=a[2], n_servers=a[3],
                                n_bursts=a[4], spread=a[5]), a=_args)


@scenario
def warm_routing_to_planted_entry(m):
    c = (_cluster(m, 0, 2, n_accelerators=1, flops_per_accel=65e12)
         .with_dataset("ds", n_samples=1000, object_size=250, n_classes=100)
         .with_scheduler(coalescing=True)
         .with_weight_cache(window=100.0)
         .with_routing(m.api.WarmAwareRouting()))
    c.build()
    nbytes = float(c.profile("alexnet", 100).prefix_param_bytes[5])
    c.weight_cache.entries[(1, 0, "alexnet")] = m.wc.CacheEntry(
        server_id=1, accel=0, model_key="alexnet", split=5, charged=nbytes, last_hit=0.0)
    c.fleet.servers[1].accels[0].mem_used += nbytes
    c.submit_request(c.store.object_names("ds")[0], "alexnet", tenant=0, split=5,
                     n_classes=100, train_batch=500)
    rec = _rec(c, c.drain())
    assert [e for e in rec["events"] if e[1] == "route"][-1][2].endswith("-> s1")
    return rec


# ---------------------------------------------------------------------------
# Compaction, the return path (tests/test_scale_core.py), observability
# (tests/test_obs.py)
# ---------------------------------------------------------------------------
def _five_tenants(m, retention):
    c = (_cluster(m, 11, 3).with_dataset("ds", n_samples=400, object_size=50, n_classes=100)
         .with_retention(retention).build())
    for t in range(5):
        c.submit_burst("ds", "alexnet", tenant=t, train_batch=500, n_classes=100)
    return c


@scenario
def scale_compact_retention(m):
    full, compact = _five_tenants(m, "full"), _five_tenants(m, "compact")
    full.drain()
    compact.drain()
    assert full.sim.log.stream_digest() == compact.sim.log.stream_digest()
    assert full.metrics().snapshot() == compact.metrics().snapshot()
    return (_rec(compact), compact.sim.log.counts(), len(compact.sim.log),
            sorted(type(r).__name__ for r in compact.fleet._req_by_id.values()))


def _return_path(m, enabled):
    c = (_cluster(m, 3, 2).with_dataset("ds", n_samples=250, object_size=50, n_classes=100)
         .with_network(m.net.NetworkSpec(trunk_bandwidth=1e9 / 8)))
    if enabled is not None:
        c.with_return_path(enabled)
    c.build()
    for t in range(3):
        c.submit_burst("ds", "alexnet", tenant=t, train_batch=500, n_classes=100)
    return _rec(c, c.drain())


@scenario
def scale_return_path_on(m):
    rec = _return_path(m, True)
    assert all(r[-1] is not None and r[-1] >= r[7] for r in rec["responses"])
    return rec


@scenario
def scale_return_path_default_off(m):
    rec = _return_path(m, None)
    assert rec["events"] == _return_path(m, False)["events"]
    return rec


@scenario
def scale_return_path_bandwidth_without_clients(m):
    c = (_cluster(m, 8, 2).with_dataset("ds", n_samples=500, object_size=100, n_classes=100)
         .with_network(m.net.NetworkSpec(trunk_bandwidth=5e8))
         .with_return_path(True, bandwidth=2e8))
    for t in range(2):
        c.submit_burst("ds", "resnet18", tenant=t, train_batch=500, n_classes=100,
                       network_weight=1.0 + t)
    return _rec(c, c.drain())


def _burst_cluster(m, seed=11, tracing=True):
    c = (_cluster(m, seed, 2).with_storage(n_nodes=4, replication=2)
         .with_dataset("ds", n_samples=2000, object_size=500, n_classes=100)
         .with_tracing(tracing))
    c.submit_burst("ds", "alexnet", tenant=0, n_classes=100)
    c.submit_burst("ds", "alexnet", tenant=1, n_classes=100)
    return c


@scenario
def obs_burst_spans_with_tracing_on_and_off(m):
    on, off = _burst_cluster(m), _burst_cluster(m, tracing=False)
    rec_on, rec_off = _rec(on, on.drain()), _rec(off, off.drain())
    assert rec_on["events"] == rec_off["events"] and len(off.tracer) == 0
    tr = on.tracer
    return rec_on, rec_off, sorted(tr.tracks()), [(s.name, s.t0, s.t1) for s in tr.roots()]


@scenario
def obs_epoch_cluster_chrome_trace(m):
    c = _cluster(m, 7, 2, n_accelerators=2, flops_per_accel=65e12).with_dataset(
        "ds", n_samples=2000, object_size=500, n_classes=100)
    t0 = c.tenant(_spec(m, model="alexnet", n_classes=100, bandwidth=1e9 / 8))
    t1 = c.tenant(_spec(m, model="alexnet", n_classes=100, bandwidth=1e9 / 8))
    results = c.run_epochs([(t0, "ds", 1000), (t1, "ds", 1000)], max_iterations=3)
    return _rec(c, epochs=[_epoch(r) for r in results]), m.chrome_trace(c.tracer)


@scenario
def obs_fleet_metrics_match_scheduler(m):
    c, responses = _coalescing(m, 3, 2, 1, 1500, ["alexnet", "alexnet"])
    sched = c.fleet.scheduler
    mx = c.metrics()
    assert mx.total("reload_bytes_total") == sched.reload_bytes
    assert mx.total("events_total") == len(c.sim.log.events)
    return _rec(c, responses), mx.dump()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_the_reference(v5e, name):
    run = SCENARIOS[name]
    want, got = run(REF), run(PORT)
    assert got == want


# ---------------------------------------------------------------------------
# The vectorized water-fill
# ---------------------------------------------------------------------------
# The case hypothesis recorded against the reference's own oracle test
# (tests/test_scale_core.py): the vectorized fill and the scalar loop differ
# by one ulp there.
RECORDED_MAX_MIN = dict(n_ports=1, specs=[[0.0, 0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 0.0],
                                          [0.0, 0.0, 0.0, 0.7853659043147847],
                                          [0.0, 0.0, 0.0, 2.530174499133588]])


def _batch(net, n_ports, specs, oracle=False):
    fabric = net.NetworkFabric(net.NetworkSpec(trunk_bandwidth=200e6))
    if oracle:
        fabric._max_min = types.MethodType(_scalar_max_min, fabric)
    ports = [fabric.tenant_port(i, bandwidth=50e6 * (1 + i % 3), weight=1.0 + (i % 2))
             for i in range(n_ports)]
    flows = [(ports[int(a) % n_ports], b, 1e4 + c * 5e7, 0.5 + d) for (a, b, c, d) in specs]
    return fabric.transfer_concurrent(flows)


@settings(max_examples=40, deadline=None)
@given(n_ports=st.integers(1, 5),
       specs=st.lists(st.lists(st.floats(0.0, 4.0), min_size=4, max_size=4),
                      min_size=1, max_size=10))
@example(**RECORDED_MAX_MIN)
def test_max_min_equals_the_references_bit_for_bit(n_ports, specs):
    assert _batch(tnet, n_ports, specs) == _batch(rnet, n_ports, specs)


def test_max_min_differs_from_the_scalar_oracle_by_one_ulp_where_the_reference_does():
    """The port keeps the reference's vectorized fill, not the scalar loop:
    at the recorded case each of the four finish times is one ulp off the
    oracle's, in both packages alike."""
    got = _batch(tnet, **RECORDED_MAX_MIN)
    oracle = _batch(tnet, **RECORDED_MAX_MIN, oracle=True)
    assert got == _batch(rnet, **RECORDED_MAX_MIN)
    assert oracle == _batch(rnet, **RECORDED_MAX_MIN, oracle=True)
    assert len(got) == 4
    for (s, e), (so, eo) in zip(got, oracle):
        assert s == so
        assert e != eo and abs(e - eo) == np.spacing(max(e, eo))


# ---------------------------------------------------------------------------
# Registries, defaults and the facade's own choices
# ---------------------------------------------------------------------------
def test_policy_registries_name_the_same_policies():
    for reg in ("ROUTING_POLICIES", "PLACEMENT_POLICIES", "SCALING_POLICIES",
                "SCHEDULER_POLICIES"):
        r, t = getattr(rapi, reg), getattr(tapi, reg)
        assert list(r) == list(t)
        assert [c.__name__ for c in r.values()] == [c.__name__ for c in t.values()]
        for cls in t.values():
            assert cls.__module__.startswith("repro_torch.")
    assert sorted(rapi.__all__) == sorted(tapi.__all__)
    assert set(twc.EVICTION_POLICIES) == set(rwc.EVICTION_POLICIES)


def test_the_lazy_cluster_exports_break_the_import_cycle():
    code = ("import sys\n"
            "import repro_torch.cos.fleet\n"
            "assert 'repro_torch.api.cluster' not in sys.modules\n"
            "import repro_torch.api as api\n"
            "assert api.HapiCluster.__module__ == 'repro_torch.api.cluster'\n"
            "try:\n    api.Nope\nexcept AttributeError as e:\n    print(e)\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "repro_torch.api" in r.stdout


def test_cluster_defaults_are_the_h100_and_profiles_need_no_card():
    assert tapi.TenantSpec(model="alexnet").client_flops == tconfig.HW.peak_flops_bf16
    c = tapi.HapiCluster(seed=0).with_servers(2).with_dataset("ds", n_samples=500,
                                                              object_size=500)
    assert [(a.flops, a.hbm) for s in c.fleet.servers for a in s.accels] == \
        [(989e12, 80e9)] * 4
    for name in tv.PAPER_MODELS:
        want = r_profile_layered(rv.PAPER_MODELS[name](1000))
        assert dataclasses.asdict(c.profile(name)) == dataclasses.asdict(want)
    h = c.tenant(tapi.TenantSpec(model="alexnet"))
    assert (h.client.accel.flops, h.client.accel.hbm) == (989e12, 80e9)


# ---------------------------------------------------------------------------
# The serving driver's fleet half
# ---------------------------------------------------------------------------
@pytest.fixture
def serve_hw(monkeypatch):
    """Patch the reference's figures into the port's HW for the serving
    driver (its replicas' and clients' rate and memory) and the server (the
    model-load rate). The reference's driver hard-codes 65e12 FLOP/s for a
    burst replica and 197e12 for a contended replica and client."""
    def patch(flops):
        monkeypatch.setattr(tserve, "HW", dataclasses.replace(
            tconfig.HW, peak_flops_bf16=flops, hbm_capacity=V5E.hbm_capacity))
        monkeypatch.setattr(tserver, "HW", V5E)
    return patch


FLEET_KW = [dict(), dict(coalesce=True, warm_window=5.0, routing="warm"),
            dict(coalesce=True, warm_window=2.0, warm_evict="demand", compress=True),
            dict(n_tenants=4, scheduler="fifo", placement="demand-aware", scaling="slo",
                 compute_weights=[4.0, 1.0]),
            dict(routing="hash", retention="compact", autoscale=False, seed=3)]


@pytest.mark.parametrize("kw", FLEET_KW, ids=lambda kw: ",".join(kw) or "defaults")
def test_serve_cos_fleet_matches_the_reference(serve_hw, kw):
    serve_hw(65e12)
    assert tserve.serve_cos_fleet(2, **kw) == rserve.serve_cos_fleet(2, **kw)


CONTENDED_KW = [dict(), dict(weights=[2.0, 1.0], compress=True),
                dict(n_tenants=3, compute_weights=[4.0, 1.0], coalesce=True,
                     routing="fabric-aware", scaling="fabric", resplit_every=1)]


@pytest.mark.parametrize("kw", CONTENDED_KW, ids=lambda kw: ",".join(kw) or "defaults")
def test_serve_cos_contended_matches_the_reference(serve_hw, kw):
    serve_hw(197e12)
    got, want = tserve.serve_cos_contended(2, **kw), rserve.serve_cos_contended(2, **kw)
    assert got["report"].as_dict() == want["report"].as_dict()
    assert {k: v for k, v in got.items() if k != "report"} == \
        {k: v for k, v in want.items() if k != "report"}


def _verdict(v):
    return {k: x for k, x in v.as_dict().items() if k not in ("wall_seconds", "events_per_sec")}


@pytest.mark.parametrize("policies", [{}, dict(routing="least-loaded", placement="learned",
                                               scaling="none", scheduler="fifo")],
                         ids=["defaults", "learned"])
def test_record_and_replay_cos_trace_match_the_reference(serve_hw, tmp_path, policies):
    serve_hw(65e12)
    paths = {}
    for side, mod in (("ref", rserve), ("port", tserve)):
        paths[side] = str(tmp_path / f"{side}.jsonl")
        mod.serve_cos_fleet(2, n_tenants=3, record=paths[side],
                            trace_out=str(tmp_path / f"{side}-fleet.json"))
    assert Path(paths["port"]).read_bytes() == Path(paths["ref"]).read_bytes()
    assert (tmp_path / "port-fleet.json").read_bytes() == \
        (tmp_path / "ref-fleet.json").read_bytes()
    out = {}
    for side, mod in (("ref", rserve), ("port", tserve)):
        trace, v = mod.replay_cos_trace(paths[side], trace_out=str(tmp_path / f"{side}-r.json"),
                                        **policies)
        out[side] = (trace.to_jsonl_bytes(), _verdict(v))
    assert out["port"] == out["ref"]
    assert (tmp_path / "port-r.json").read_bytes() == (tmp_path / "ref-r.json").read_bytes()


def _wall_free(text):
    """The replay line's wall time and rate are the host's own."""
    return [line.split(" in ")[0] + " under" + line.split(" under")[1]
            if line.startswith("replayed ") else line for line in text.splitlines()]


@pytest.mark.parametrize("argv", [
    ["--cos-fleet", "2", "--tenants", "3"],
    ["--cos-fleet", "2", "--tenants", "3", "--coalesce", "--warm-window", "5",
     "--routing", "warm"],
    ["--cos-fleet", "2", "--tenants", "2", "--network-trunk", "1.0",
     "--tenant-weight", "2,1"],
], ids=["burst", "warm", "trunk"])
def test_cli_prints_what_the_reference_prints(serve_hw, capsys, argv):
    serve_hw(197e12 if "--network-trunk" in argv else 65e12)
    rserve.main(argv)
    want = capsys.readouterr().out
    tserve.main(argv)
    assert capsys.readouterr().out == want and want


def test_cli_record_then_replay_prints_what_the_reference_prints(serve_hw, capsys, tmp_path):
    serve_hw(65e12)
    outs = {}
    for side, mod in (("ref", rserve), ("port", tserve)):
        path = str(tmp_path / f"{side}.jsonl")
        mod.main(["--cos-fleet", "2", "--tenants", "3", "--record", path])
        mod.main(["--replay", path, "--routing", "least-loaded"])
        outs[side] = _wall_free(capsys.readouterr().out.replace(path, "PATH"))
    assert outs["port"] == outs["ref"]
    assert any(line.startswith("replayed 24 requests") for line in outs["port"])


def test_cli_needs_an_arch_unless_a_fleet_or_a_replay_is_given(capsys):
    with pytest.raises(SystemExit):
        tserve.main([])
    assert "--arch is required unless --cos-fleet or --replay is given" in \
        capsys.readouterr().err


# ---------------------------------------------------------------------------
# A live run: the port's executor on the port's cluster
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("compress", [False, True])
def test_live_two_replica_cluster_with_the_ports_executor_matches_the_reference(v5e, compress):
    """Two replicas, least-loaded routing, two tenants' bursts of 4 objects
    of 4 images each: the port's make_vision_executor on the port's cluster
    against a JAX executor on the reference's. Every response's acts within
    1e-4 (float32) or one code step with scales to 1e-4 (int8); act_bytes,
    virtual times and digests equal."""
    jvm, params, tvm = _pair("alexnet", num_classes=10)
    x = _images(16, seed=6)
    out = {}
    for m, executor in ((REF, _jax_executor(jvm, params, compress)),
                        (PORT, tts.make_vision_executor(tvm, compress=compress, device="cpu"))):
        calls = []

        def timed(payload, split, cos_batch, executor=executor, calls=calls):
            calls.append((split, cos_batch))
            return executor(payload, split, cos_batch)

        c = (_cluster(m, 0, 2, n_accelerators=1)
             .with_routing(m.api.LeastLoadedRouting())
             .with_dataset("live", {"x": x}, object_size=4, img_bytes=None)
             .with_executor("alexnet", timed))
        hapi = _hapi(m, compress_transfer=compress)
        for t in (0, 1):
            c.submit_burst("live", "alexnet", tenant=t, train_batch=8, hapi=hapi,
                           n_classes=10, b_max=2)
        responses = c.drain()
        out[m.name] = (_rec(c, responses), [r.acts for r in responses], calls)
    (got, acts, calls), (want, wacts, wcalls) = out["port"], out["ref"]
    assert got == want and calls == wcalls
    assert len(acts) == 8 and len({r[8] for r in got["responses"]}) == 2
    for g, w in zip(acts, wacts):
        if not compress:
            assert g.dtype == np.float32 and g.shape == w.shape
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, rtol=0)
            continue
        (q, s), (qj, sj) = g, w
        assert q.dtype == np.int8 and s.dtype == np.float32 and q.shape == qj.shape
        assert np.abs(q.astype(np.int32) - qj.astype(np.int32)).max() <= 1
        np.testing.assert_allclose(s, sj, rtol=1e-4, atol=0)


# ---------------------------------------------------------------------------
# Imports
# ---------------------------------------------------------------------------
def test_fleet_modules_import_no_jax_and_nothing_of_repro():
    mods = ["repro_torch.cos.network", "repro_torch.cos.fleet", "repro_torch.api",
            "repro_torch.api.cluster", "repro_torch.api.policies", "repro_torch.launch.serve"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr


def test_port_records_only_kinds_the_trace_schema_knows():
    """tests/test_replay.py's schema-stability grep, over the port's sources."""
    import re

    from repro_torch.replay.schema import EVENT_KINDS

    pat = re.compile(r"(?:\.record|\.schedule|log\.add)\("
                     r"[^\"']{0,200}?[\"']([a-z][a-z0-9_.-]{1,30})[\"']", re.S)
    kinds = set()
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        kinds.update(pat.findall(path.read_text()))
    assert kinds and kinds <= EVENT_KINDS, sorted(kinds - EVENT_KINDS)
