"""`repro_torch.api` — *the* way to stand up and drive a HAPI deployment.

A copy of ``repro/api`` over the port's ``cos`` modules; it imports
nothing of ``repro``.

One facade, :class:`HapiCluster`, owns the shared discrete-event
simulator, the object store, the server fleet and the per-tenant
clients; :mod:`repro_torch.api.policies` holds the swappable routing /
placement / scaling strategies behind it::

    from repro_torch.api import HapiCluster, TenantSpec

    cluster = (HapiCluster(seed=0)
               .with_servers(4)
               .with_dataset("imagenet", n_samples=8000))
    result = cluster.tenant(TenantSpec(model="alexnet")).run_epoch(
        "imagenet", train_batch=1000)
    print(cluster.report())

Nothing outside this package should assemble ``Simulator`` +
``ObjectStore`` + ``HapiFleet`` wiring by hand.
"""
from repro_torch.api.policies import (
    ComputeScheduler,
    DemandAwarePlacement,
    FabricAwareRouting,
    FabricAwareScaling,
    FifoScheduling,
    HashRouting,
    LearnedPlacement,
    LeastLoadedRouting,
    PLACEMENT_POLICIES,
    PlacementPolicy,
    QueueDepthScaling,
    ROUTING_POLICIES,
    ReplicaAwareRouting,
    RoundRobinPlacement,
    RoutingPolicy,
    SCALING_POLICIES,
    SCHEDULER_POLICIES,
    ScalingPolicy,
    SchedulerPolicy,
    SloScaling,
    WarmAwareRouting,
    WdrrScheduling,
)
from repro_torch.cos.weightcache import (EVICTION_POLICIES, DemandWeightedEviction,
                                   LruEviction, WeightCache)
from repro_torch.cos.network import NetworkFabric, NetworkSpec
from repro_torch.obs import (MetricsRegistry, Tracer, chrome_trace,
                       validate_chrome_trace, write_trace)

_CLUSTER_EXPORTS = ("HapiCluster", "TenantSpec", "TenantHandle", "ClusterReport")

__all__ = list(_CLUSTER_EXPORTS) + [
    "RoutingPolicy", "ReplicaAwareRouting", "LeastLoadedRouting",
    "FabricAwareRouting", "WarmAwareRouting", "HashRouting",
    "WeightCache", "LruEviction", "DemandWeightedEviction",
    "EVICTION_POLICIES",
    "PlacementPolicy", "RoundRobinPlacement", "DemandAwarePlacement",
    "LearnedPlacement",
    "ScalingPolicy", "QueueDepthScaling", "SloScaling", "FabricAwareScaling",
    "SchedulerPolicy", "WdrrScheduling", "FifoScheduling", "ComputeScheduler",
    "ROUTING_POLICIES", "PLACEMENT_POLICIES", "SCALING_POLICIES",
    "SCHEDULER_POLICIES",
    "NetworkSpec", "NetworkFabric",
    "Tracer", "MetricsRegistry", "chrome_trace", "validate_chrome_trace",
    "write_trace",
]


def __getattr__(name):
    # Lazy so `repro_torch.cos.fleet` can import `repro_torch.api.policies` without
    # pulling in the cluster module (which imports the fleet back).
    if name in _CLUSTER_EXPORTS:
        from repro_torch.api import cluster

        return getattr(cluster, name)
    raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")
