"""Serving entry point: prefill a batch of prompts, then decode greedily.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral-nemo-12b --full \\
        --prompt-len 512 --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch moonshot-v1-16b-a3b --device cpu

Counterpart of the ``--arch`` path of ``repro/launch/serve.py``, for the LM
families the port has: dense (mistral-nemo-12b, gemma2-9b, qwen3-32b,
qwen1.5-110b), moe (moonshot-v1-16b-a3b, grok-1-314b), ssm (mamba2-1.3b) and
hybrid (jamba-v0.1-52b). The loop (``generate``) is the JAX launcher's: the
prompt is prefilled and that cache is discarded; a fixed-size cache of
``prompt_len + new_tokens`` positions is refilled by teacher-forcing the
prompt one token at a time; the first new token is the argmax of the last
teacher-forced step's logits, and ``new_tokens`` greedy steps follow.
``tok_per_s`` counts the greedy loop only. Weights and prompt tokens come
from one ``torch.Generator`` seeded with ``seed``: on the CPU for the smoke
config, so that a seed gives the same model and prompts on every device,
and on the device for the published config, whose weights are too large to
draw on the host. It runs on the card unless ``device="cpu"``; the smoke
config (f32, head dim 16) is the default, ``--full`` the published one.

The fleet half is the counterpart of the JAX launcher's ``--cos-fleet`` and
``--replay`` paths, with the same flags, branches and printouts. It runs the
HAPI control plane on the host (virtual time, no card):

    PYTHONPATH=src python -m repro_torch.launch.serve --cos-fleet 2 --tenants 3
    PYTHONPATH=src python -m repro_torch.launch.serve --cos-fleet 4 --tenants 4 \\
        --network-trunk 1.0
    PYTHONPATH=src python -m repro_torch.launch.serve --cos-fleet 2 --record t.jsonl
    PYTHONPATH=src python -m repro_torch.launch.serve --replay t.jsonl --routing hash

``--cos-fleet N`` stands up an N-replica deployment through
:class:`repro_torch.api.HapiCluster` (autoscaling up to ``--max-servers``;
``--routing``, ``--placement``, ``--scaling`` and ``--scheduler`` pick the
fleet policies by registry name) and drains a burst of one POST an object
for each tenant, printing per-replica and per-tenant throughput.
``--network-trunk GBPS`` instead puts every tenant on one shared WAN trunk
(:mod:`repro_torch.cos.network`) and runs their epochs concurrently with
contention-aware split re-decision (``--resplit-every``); ``--tenant-weight``
and ``--tenant-compute-weight`` give network and accelerator service
classes, cycled over the tenants. ``--coalesce``, ``--warm-window``,
``--warm-evict`` and ``--compress`` turn on batch coalescing, the warm-weight
cache and the int8 wire. ``--record PATH`` writes the fleet run as a
replayable JSONL trace; ``--replay PATH`` re-drives one through the selected
policies (decision path only); ``--trace-out PATH`` writes the span timeline
as Chrome-trace JSON. The simulated replicas and clients take the port's
``HW`` figures (one H100 each).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import HW
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.api import build_model
from repro_torch.models.transformer import LM
from repro_torch.train.steps import build_decode_step, build_prefill_step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32, new_tokens: int = 16,
          smoke: bool = True, seed: int = 0, device="cuda") -> dict:
    """``generate`` on the model of ``arch`` and a batch of random prompts."""
    device = torch.device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    init = torch.device("cpu") if smoke else device
    gen = torch.Generator(device=init).manual_seed(seed)
    model = build_model(cfg, device=init, generator=gen).to(device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len), generator=gen,
                           device=init).to(device)
    return generate(model, tokens, new_tokens)


def generate(model: LM, tokens: torch.Tensor, new_tokens: int) -> dict:
    """Serves the prompts ``tokens`` (B, prompt_len) on ``model``'s device.
    Returns the prompt and the greedy tokens (B, new_tokens + 1) as numpy,
    ``tok_per_s``, the wall times of the prefill and of the teacher-forced
    refill in ms, and the logits (B, 1, padded_vocab) of the prefill's last
    position and of the last teacher-forced step, which see the same
    prompt."""
    device = tokens.device
    batch, prompt_len = tokens.shape
    prefill, step = build_prefill_step(model), build_decode_step(model)

    _sync(device)
    t0 = time.perf_counter()
    prefill_logits, _ = prefill({"tokens": tokens})
    _sync(device)
    t1 = time.perf_counter()
    cache = model.init_cache(batch, prompt_len + new_tokens)
    logits = None
    for t in range(prompt_len):
        logits, cache = step(cache, tokens[:, t:t + 1], t)
    _sync(device)
    t2 = time.perf_counter()
    teacher_logits = logits

    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    for i in range(new_tokens):
        logits, cache = step(cache, tok, prompt_len + i)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    _sync(device)
    dt = time.perf_counter() - t2
    return {"prompt": tokens.cpu().numpy().astype(np.int32),
            "tokens": torch.cat(out, dim=1).cpu().numpy().astype(np.int32),
            "tok_per_s": batch * new_tokens / dt,
            "prefill_ms": 1e3 * (t1 - t0), "teacher_ms": 1e3 * (t2 - t1),
            "prefill_logits": prefill_logits, "teacher_logits": teacher_logits}


def serve_cos_fleet(n_servers: int, *, n_tenants: int = 3, seed: int = 0,
                    max_servers: int = 8, autoscale: bool = True,
                    routing: str = "replica-aware",
                    placement: str = "round-robin",
                    scaling: str = "queue-depth",
                    scheduler: str = "wdrr",
                    coalesce: bool = False,
                    compress: bool = False,
                    compute_weights=None,
                    record: str = None,
                    trace_out: str = None,
                    retention: str = "full",
                    warm_window: float = 0.0,
                    warm_evict: str = "lru"):
    """Drive a HAPI deployment through the :class:`repro_torch.api.HapiCluster`
    facade with a multi-tenant burst workload and report served
    throughput per replica and per tenant. ``routing``/``placement``/
    ``scaling``/``scheduler`` select fleet policies by registry name;
    ``compute_weights`` assigns accelerator service classes (cycled over
    tenants), ``coalesce`` turns on cross-server batch coalescing;
    ``warm_window`` > 0 enables the fleet-wide warm-weight cache
    (keep-warm seconds; ``warm_evict`` picks the eviction policy, and
    ``--routing warm`` routes on residency); ``record`` writes the run
    as a replayable JSONL trace (:mod:`repro_torch.replay`) for offline
    policy search. Each replica's accelerators take ``HW``'s rate and
    memory."""
    from repro_torch.api import (HapiCluster, PLACEMENT_POLICIES, ROUTING_POLICIES,
                                 SCALING_POLICIES, SCHEDULER_POLICIES)
    from repro_torch.config import HapiConfig
    from repro_torch.models.vision import PAPER_MODELS

    cluster = (HapiCluster(seed=seed)
               .with_servers(n_servers, n_accelerators=2,
                             flops_per_accel=HW.peak_flops_bf16,
                             hbm_per_accel=HW.hbm_capacity)
               .with_retention(retention)
               .with_dataset("serve", content_seed=seed)
               .with_routing(ROUTING_POLICIES[routing]())
               .with_placement(PLACEMENT_POLICIES[placement]())
               .with_scheduler(SCHEDULER_POLICIES[scheduler](),
                               coalescing=coalesce))
    if warm_window > 0:
        cluster.with_weight_cache(window=warm_window, policy=warm_evict)
    if autoscale:
        cluster.with_scaling(SCALING_POLICIES[scaling](
            min_servers=1, max_servers=max_servers))
    names = list(PAPER_MODELS)
    weights = compute_weights or [1.0]
    hapi = HapiConfig(compress_transfer=compress)
    for t in range(n_tenants):
        cluster.submit_burst("serve", names[t % len(names)], tenant=t,
                             train_batch=1000, hapi=hapi,
                             compute_weight=weights[t % len(weights)])
    responses = cluster.drain()
    if record:
        from repro_torch.replay import record_trace

        record_trace(cluster, responses).write(record)
    if trace_out:
        from repro_torch.obs import write_trace

        write_trace(cluster.tracer, trace_out)
    report = cluster.report()
    # Operational counters come from the structured metrics registry; the
    # event-log string path stays for the digest tests only.
    mx = cluster.metrics()
    out = {
        "served": len(responses),
        "trace": record,
        "trace_out": trace_out,
        "makespan": report.makespan,
        "n_alive": report.n_alive,
        "served_by_server": report.served_by_server,
        "tenant_throughput": report.tenant_throughput,
        "scale_events": report.scale_events,
        "reload_bytes": mx.total("reload_bytes_total"),
        "reload_saved_bytes": mx.total("reload_saved_bytes_total"),
        "queue_delay_p99": mx.percentile("queue_delay_seconds", 0.99),
        "slo_misses": int(mx.total("slo_miss_total")),
    }
    if warm_window > 0:
        wc = cluster.weight_cache
        out.update({
            "warm_hits": int(mx.total("warm_hit_total")),
            "cache_evictions": wc.evicted,
            "cache_evicted_bytes": wc.evicted_bytes,
            "cache_retained_bytes": wc.retained_bytes,
            "cache_resident_bytes": wc.resident_bytes(),
        })
    return out


def replay_cos_trace(path: str, *, routing: str = "replica-aware",
                     placement: str = "round-robin",
                     scaling: str = "queue-depth",
                     scheduler: str = "wdrr",
                     tick_interval: float = 30.0,
                     trace_out: str = None):
    """Re-drive a recorded/generated trace (``--record`` output or
    :func:`repro_torch.replay.workload.generate`) through the named policy
    combination without standing the fleet back up — only the decision
    path executes, so million-request traces replay in seconds.
    ``trace_out`` additionally renders the replayed requests to a
    Perfetto/Chrome-trace JSON timeline (one span per request — the
    replayer's 1-in-8 sampling is disabled when a timeline was
    explicitly asked for)."""
    from repro_torch.api import (PLACEMENT_POLICIES, ROUTING_POLICIES,
                                 SCALING_POLICIES, SCHEDULER_POLICIES)
    from repro_torch.obs import Tracer, write_trace
    from repro_torch.replay import Trace, TraceReplayer

    trace = Trace.read(path)
    tracer = Tracer() if trace_out else None
    verdict = TraceReplayer(
        trace,
        routing=ROUTING_POLICIES[routing](),
        placement=PLACEMENT_POLICIES[placement](),
        scaling=SCALING_POLICIES[scaling]() if scaling != "none" else None,
        scheduler=SCHEDULER_POLICIES[scheduler](),
        tick_interval=tick_interval,
        tracer=tracer,
        trace_sample=1,
    ).run()
    if trace_out:
        write_trace(tracer, trace_out)
    return trace, verdict


def serve_cos_contended(n_servers: int, *, n_tenants: int = 4, seed: int = 0,
                        trunk_gbps: float = 1.0, train_batch: int = 500,
                        resplit_every: int = 2, max_servers: int = 8,
                        autoscale: bool = True,
                        routing: str = "replica-aware",
                        placement: str = "round-robin",
                        scaling: str = "queue-depth",
                        scheduler: str = "wdrr", coalesce: bool = False,
                        compress: bool = False,
                        weights=None, compute_weights=None):
    """Co-scheduled tenant epochs on a shared WAN egress trunk: every
    tenant's activation pulls are flows contending under weighted
    max-min fair sharing, and each client re-decides its split from the
    measured bandwidth EWMA (``resplit_every`` iterations). Fleet
    policies are selected by registry name, exactly like
    :func:`serve_cos_fleet`; ``weights`` assigns per-tenant network
    service classes, ``compute_weights`` the accelerator classes (both
    cycled over tenants; compute follows network when None). Replicas and
    clients take ``HW``'s rate and memory."""
    from repro_torch.api import (HapiCluster, NetworkSpec, PLACEMENT_POLICIES,
                                 ROUTING_POLICIES, SCALING_POLICIES,
                                 SCHEDULER_POLICIES, TenantSpec)
    from repro_torch.config import HapiConfig

    bw = trunk_gbps * 1e9 / 8
    cluster = (HapiCluster(seed=seed)
               .with_servers(n_servers, n_accelerators=2,
                             flops_per_accel=HW.peak_flops_bf16,
                             hbm_per_accel=HW.hbm_capacity)
               .with_dataset("serve", n_samples=4000, object_size=500,
                             content_seed=seed)
               .with_network(NetworkSpec(trunk_bandwidth=bw))
               .with_routing(ROUTING_POLICIES[routing]())
               .with_placement(PLACEMENT_POLICIES[placement]())
               .with_scheduler(SCHEDULER_POLICIES[scheduler](),
                               coalescing=coalesce))
    if autoscale:
        cluster.with_scaling(SCALING_POLICIES[scaling](
            min_servers=1, max_servers=max_servers))
    weights = weights or [1.0]
    handles = [cluster.tenant(TenantSpec(
        model="alexnet",
        hapi=HapiConfig(network_bandwidth=bw, compress_transfer=compress),
        client_flops=HW.peak_flops_bf16, client_hbm=HW.hbm_capacity,
        resplit_every=resplit_every,
        network_weight=weights[i % len(weights)],
        compute_weight=(compute_weights[i % len(compute_weights)]
                        if compute_weights else None)))
        for i in range(n_tenants)]
    results = cluster.run_epochs([(h, "serve", train_batch) for h in handles])
    tenants = []
    for h, r in zip(handles, results):
        ewma = h.client.observed_bw
        tenants.append({
            "tenant": h.tenant_id,
            "weight": h.spec.network_weight,
            "split": r.split,
            "resplits": r.resplits,
            "jct": r.execution_time,
            "throughput": r.n_iterations * train_batch / r.execution_time,
            "effective_bandwidth": ewma,
        })
    return {"trunk_gbps": trunk_gbps, "tenants": tenants,
            "report": cluster.report()}


def main(argv=None) -> None:
    from repro_torch.api import (PLACEMENT_POLICIES, ROUTING_POLICIES,
                                 SCALING_POLICIES, SCHEDULER_POLICIES)

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="a dense, moe, ssm or hybrid arch, e.g. moonshot-v1-16b-a3b "
                         "(required unless --cos-fleet or --replay is given)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--full", action="store_true", help="the published config, not the smoke one")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cos-fleet", type=int, default=0, metavar="N",
                    help="serve a COS fleet of N replicas instead of decoding")
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--max-servers", type=int, default=8)
    ap.add_argument("--network-trunk", type=float, default=0.0, metavar="GBPS",
                    help="share one WAN egress trunk of GBPS across all "
                         "tenants (contention-aware split re-decision)")
    ap.add_argument("--resplit-every", type=int, default=2)
    ap.add_argument("--tenant-weight", default="", metavar="W[,W...]",
                    help="per-tenant QoS weights, cycled over tenants "
                         "(e.g. '2,1' = gold/bronze); only meaningful "
                         "with --network-trunk")
    ap.add_argument("--tenant-compute-weight", default="", metavar="W[,W...]",
                    help="per-tenant accelerator service classes, cycled "
                         "over tenants (defaults to --tenant-weight: one "
                         "class shapes both tiers)")
    ap.add_argument("--coalesce", action="store_true",
                    help="cross-server batch coalescing: ship queued "
                         "requests to replicas already holding their "
                         "model loaded (cuts stateless reload bytes)")
    ap.add_argument("--warm-window", type=float, default=0.0,
                    metavar="SECONDS",
                    help="keep-warm window of the fleet-wide weight "
                         "cache: expired leases transfer their model "
                         "bytes into per-accelerator cache entries that "
                         "stay HBM-charged for this long after the last "
                         "hit (0 = cache off); pair with --routing warm "
                         "for residency-aware dispatch")
    ap.add_argument("--warm-evict", default="lru",
                    choices=["lru", "demand"],
                    help="warm-weight cache eviction order under HBM "
                         "pressure: plain LRU or demand-weighted "
                         "(decayed hit count, then recency)")
    ap.add_argument("--compress", action="store_true",
                    help="int8(+per-tile scales) boundary compression on "
                         "the activation wire: Algorithm 1, the cost "
                         "model and the servers all charge the single "
                         "authoritative ratio (~0.516x for bf16)")
    ap.add_argument("--routing", default="replica-aware",
                    choices=sorted(ROUTING_POLICIES))
    ap.add_argument("--placement", default="round-robin",
                    choices=sorted(PLACEMENT_POLICIES))
    ap.add_argument("--scaling", default="queue-depth",
                    choices=sorted(SCALING_POLICIES) + ["none"])
    ap.add_argument("--scheduler", default="wdrr",
                    choices=sorted(SCHEDULER_POLICIES))
    ap.add_argument("--retention", default="full",
                    choices=["full", "compact"],
                    help="event-log retention: 'compact' keeps a bounded "
                         "tail plus streaming digest and O(1) counters "
                         "(the scale-out mode for large fleets); 'full' "
                         "materializes every event (replay recording)")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="with --cos-fleet: write the run as a replayable "
                         "JSONL trace (repro_torch.replay format)")
    ap.add_argument("--replay", default=None, metavar="PATH",
                    help="re-drive a recorded/generated trace through the "
                         "selected --routing/--placement/--scaling/"
                         "--scheduler combination (decision path only; "
                         "no fleet, no card)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's structured-span timeline as "
                         "Perfetto/Chrome-trace JSON (open at "
                         "ui.perfetto.dev); works with --cos-fleet and "
                         "--replay")
    args = ap.parse_args(argv)
    if args.replay:
        trace, v = replay_cos_trace(args.replay, routing=args.routing,
                                    placement=args.placement,
                                    scaling=args.scaling,
                                    scheduler=args.scheduler,
                                    trace_out=args.trace_out)
        print(f"replayed {v.n_requests:,} requests ({v.mode}) in "
              f"{v.wall_seconds:.2f}s ({v.events_per_sec:,.0f} req/s) "
              f"under {v.policies}")
        print(f"queue delay p50={v.queue_delay_p50:.4f}s "
              f"p95={v.queue_delay_p95:.4f}s p99={v.queue_delay_p99:.4f}s "
              f"mean={v.queue_delay_mean:.4f}s")
        print(f"makespan={v.makespan:.1f}s replicas +{v.replicas_added}/"
              f"-{v.replicas_dropped} scale +{v.scale_ups}/-{v.scale_downs} "
              f"decisions sha256={v.decision_hash[:16]}")
        if args.trace_out:
            print(f"timeline written to {args.trace_out}")
        return
    cweights = ([float(w) for w in args.tenant_compute_weight.split(",")]
                if args.tenant_compute_weight else None)
    if args.cos_fleet and args.network_trunk > 0:
        weights = ([float(w) for w in args.tenant_weight.split(",")]
                   if args.tenant_weight else None)
        out = serve_cos_contended(args.cos_fleet, n_tenants=args.tenants,
                                  seed=args.seed,
                                  trunk_gbps=args.network_trunk,
                                  resplit_every=args.resplit_every,
                                  max_servers=args.max_servers,
                                  autoscale=args.scaling != "none",
                                  routing=args.routing,
                                  placement=args.placement,
                                  scaling=args.scaling,
                                  scheduler=args.scheduler,
                                  coalesce=args.coalesce,
                                  compress=args.compress,
                                  weights=weights,
                                  compute_weights=cweights)
        print(f"shared trunk {args.network_trunk:.2f} Gbps, "
              f"{len(out['tenants'])} tenants:")
        for t in out["tenants"]:
            bw = t["effective_bandwidth"]
            print(f"tenant {t['tenant']} (w={t['weight']:g}): "
                  f"split={t['split']:2d} "
                  f"(resplits={t['resplits']}) jct={t['jct']:6.2f}s "
                  f"{t['throughput']:8.1f} samples/s "
                  f"ewma={bw / 1e6 if bw else 0:6.1f} MB/s")
        return
    if args.cos_fleet:
        out = serve_cos_fleet(args.cos_fleet, n_tenants=args.tenants,
                              seed=args.seed, max_servers=args.max_servers,
                              autoscale=args.scaling != "none",
                              routing=args.routing, placement=args.placement,
                              scaling=args.scaling, scheduler=args.scheduler,
                              coalesce=args.coalesce, compress=args.compress,
                              compute_weights=cweights, record=args.record,
                              trace_out=args.trace_out,
                              retention=args.retention,
                              warm_window=args.warm_window,
                              warm_evict=args.warm_evict)
        print(f"served {out['served']} POSTs in {out['makespan']:.3f}s "
              f"({out['n_alive']} replicas alive)")
        if args.record:
            print(f"trace recorded to {args.record}")
        if args.trace_out:
            print(f"timeline written to {args.trace_out}")
        if args.coalesce or args.warm_window > 0:
            print(f"stateless reloads: {out['reload_bytes'] / 1e9:.2f} GB "
                  f"charged, {out['reload_saved_bytes'] / 1e9:.2f} GB "
                  f"saved by warm hits")
        if args.warm_window > 0:
            print(f"warm-weight cache (window={args.warm_window:g}s, "
                  f"{args.warm_evict}): {out['warm_hits']} warm hits, "
                  f"{out['cache_retained_bytes'] / 1e9:.2f} GB retained, "
                  f"{out['cache_evictions']} evictions "
                  f"({out['cache_evicted_bytes'] / 1e9:.2f} GB), "
                  f"{out['cache_resident_bytes'] / 1e9:.2f} GB resident "
                  f"at drain")
        print(f"per-server: {out['served_by_server']}")
        for t, thr in out["tenant_throughput"].items():
            print(f"tenant {t}: {thr:10.1f} samples/s")
        for ev in out["scale_events"]:
            print(f"  scale event t={ev[0]:.3f} {ev[1]} {ev[2]}")
        return
    if not args.arch:
        ap.error("--arch is required unless --cos-fleet or --replay is given")
    out = serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                new_tokens=args.tokens, smoke=not args.full, seed=args.seed,
                device=args.device)
    print(f"prefill {out['prefill_ms']:.1f} ms, teacher-forced refill "
          f"{out['teacher_ms']:.1f} ms")
    print(f"decoded {out['tokens'].shape} @ {out['tok_per_s']:.1f} tok/s")
    print(out["tokens"][:, :12])


if __name__ == "__main__":
    main()
