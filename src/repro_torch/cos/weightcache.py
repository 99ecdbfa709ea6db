"""Fleet-wide warm-weight cache (warm-weight cache with scheduler-aware
routing).

A copy of ``repro/cos/weightcache.py``: the same entries, victim orders and
event records, so a cache of either package evicts alike.

The coalescer (PR 5) taught the fleet that a replica holding an *active
Eq. 4 lease* for a model effectively has the weights resident — but that
warmth dies with the lease: the moment the admission lease expires, the
bytes are freed and the next request for the same model pays a full
stateless reload, even if it arrives microseconds later. This module
promotes warmth to first-class state that **outlives leases**:

* **Per-accelerator resident-model entries.** When a lease whose request
  charged a model reload expires, the model-prefix bytes are *retained*
  in HBM instead of freed (ownership transfers from the lease to a
  :class:`CacheEntry`), for a configurable keep-warm ``window`` of
  virtual seconds past the last warm use.

* **HBM-charged, never double-counted.** Every cached byte stays charged
  against the owning accelerator (``accel.mem_used``), so Eq. 4
  admission automatically sees ``hbm_free = capacity − activations −
  warm_weights`` — the cache can *never* cause the no-OOM invariant to
  be violated, because batch adaptation plans around it. Requests whose
  model is already cache-resident on their accelerator are admitted with
  ``mem_model = 0`` (the bytes are charged once, by the entry) and *pin*
  the entry until their lease expires, so pressure eviction cannot pull
  the weights out from under a planned batch.

* **Eviction before batches shrink.** Under HBM pressure the scheduler
  releases warm bytes (:meth:`WeightCache.release`) *before* running
  Eq. 4, so batch adaptation only shrinks batches once the cache is out
  of sacrificial bytes. Victim order is pluggable
  (:data:`EVICTION_POLICIES`): ``"lru"`` evicts by oldest last-warm-hit;
  ``"demand"`` scores entries by decayed hit counts so a briefly-idle
  hot model outlives a cold one touched more recently.

Everything is deterministic: victim orders sort on virtual-time floats
and ids only, eviction history is recorded (``evictions``), and with the
cache disabled (``ComputeScheduler.cache is None`` — the default) no
code path changes, keeping the golden event-log digests byte-identical
(asserted by the JAX package's tests/test_weight_cache.py).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Set, Tuple

if TYPE_CHECKING:  # server imports this module via the scheduler; no cycle
    from repro_torch.cos.server import HapiServer, _Lease


@dataclass
class CacheEntry:
    """One model prefix resident on one accelerator past its lease."""

    server_id: int
    accel: int
    model_key: str
    split: int                  # deepest boundary the cached prefix covers
    charged: float              # bytes charged against the accel's HBM
    last_hit: float             # virtual time of the last warm use
    hits: float = 0.0           # decayed hit score (demand eviction)
    pins: int = 0               # active leases riding this entry

    @property
    def key(self) -> Tuple[int, int, str]:
        return (self.server_id, self.accel, self.model_key)


# ---------------------------------------------------------------------------
# Eviction policies (victim order under pressure / window expiry order)
# ---------------------------------------------------------------------------
@dataclass
class LruEviction:
    """Evict by oldest last-warm-hit first (ties: ids, for determinism)."""

    name: str = "lru"

    def order(self, entries: Iterable[CacheEntry],
              now: float) -> List[CacheEntry]:
        return sorted(entries, key=lambda e: (e.last_hit, e.server_id,
                                              e.accel, e.model_key))


@dataclass
class DemandWeightedEviction:
    """Evict the lowest *decayed demand* first: each warm hit adds one
    point, points halve every ``half_life`` virtual seconds since the
    entry's last hit. A hot model that paused briefly outscores a cold
    one touched once more recently; ties fall back to LRU order."""

    name: str = "demand"
    half_life: float = 2.0

    def score(self, e: CacheEntry, now: float) -> float:
        age = max(0.0, now - e.last_hit)
        return e.hits * 0.5 ** (age / self.half_life)

    def order(self, entries: Iterable[CacheEntry],
              now: float) -> List[CacheEntry]:
        return sorted(entries, key=lambda e: (self.score(e, now), e.last_hit,
                                              e.server_id, e.accel,
                                              e.model_key))


EVICTION_POLICIES = {
    "lru": LruEviction,
    "demand": DemandWeightedEviction,
}


class WeightCache:
    """Fleet-wide warm-weight cache (see module docstring).

    One instance is shared by a fleet's :class:`ComputeScheduler` across
    every replica; entries are keyed ``(server_id, accel, model_key)``.
    All byte accounting goes through the owning accelerator: retaining
    keeps already-leased bytes allocated, evicting frees them — the
    cache never allocates on its own, so ``mem_used <= hbm`` holds by
    construction (property-tested)."""

    def __init__(self, window: float = 2.0, policy="lru") -> None:
        if window <= 0.0:
            raise ValueError(f"keep-warm window must be > 0, got {window}")
        self.window = float(window)
        if isinstance(policy, str):
            if policy not in EVICTION_POLICIES:
                raise ValueError(
                    f"unknown eviction policy {policy!r}; "
                    f"known: {sorted(EVICTION_POLICIES)}")
            policy = EVICTION_POLICIES[policy]()
        self.policy = policy
        self.entries: Dict[Tuple[int, int, str], CacheEntry] = {}
        # Accounting the benchmarks/serve driver read.
        self.warm_hits = 0
        self.retained_bytes = 0.0            # lease->cache ownership transfers
        self.evicted = 0
        self.evicted_bytes = 0.0
        # Full eviction history ``(t, server, accel, model, bytes, reason)``
        # — the determinism test compares it across seed-identical runs.
        self.evictions: List[Tuple[float, int, int, str, float, str]] = []
        # High-water mark of resident bytes per (server, accel): the
        # no-HBM-overrun smoke asserts peak <= capacity.
        self.peak_resident: Dict[Tuple[int, int], float] = {}

    # -- queries ---------------------------------------------------------------
    def covers(self, server_id: int, accel: int, model_key: str,
               split: int) -> bool:
        """True if the accelerator holds this model cached at least as
        deep as ``split`` — the request's reload (and its Eq. 4 model
        charge) can be skipped."""
        e = self.entries.get((server_id, accel, model_key))
        return e is not None and e.split >= split

    def warm_accels(self, server_id: int, n_accels: int, model_key: str,
                    split: int) -> List[int]:
        return [ai for ai in range(n_accels)
                if self.covers(server_id, ai, model_key, split)]

    def is_warm_server(self, server_id: int, model_key: str,
                       split: int) -> bool:
        """Routing signal: does *any* accelerator of the replica hold the
        model cached deep enough? Entries are truthful — the bytes stay
        charged in HBM until evicted — so no window check is needed."""
        return any(e.split >= split for e in self.entries.values()
                   if e.server_id == server_id and e.model_key == model_key)

    def resident_bytes(self, server_id: Optional[int] = None,
                       accel: Optional[int] = None) -> float:
        return sum(e.charged for e in self.entries.values()
                   if (server_id is None or e.server_id == server_id)
                   and (accel is None or e.accel == accel))

    def _bump_peak(self, server_id: int, accel: int) -> None:
        key = (server_id, accel)
        r = self.resident_bytes(server_id, accel)
        if r > self.peak_resident.get(key, 0.0):
            self.peak_resident[key] = r

    # -- warm hits -------------------------------------------------------------
    def touch(self, server_id: int, accel: int, model_key: str,
              t: float) -> None:
        e = self.entries.get((server_id, accel, model_key))
        if e is not None:
            e.last_hit = max(e.last_hit, t)
            e.hits += 1.0
            self.warm_hits += 1

    def pin(self, server_id: int, accel: int, model_key: str) -> None:
        e = self.entries.get((server_id, accel, model_key))
        if e is not None:
            e.pins += 1

    # -- lease lifecycle -------------------------------------------------------
    def on_lease_expired(self, server: "HapiServer", lease: "_Lease",
                         t: float) -> float:
        """Called by :meth:`HapiServer._free_expired` for every expiring
        lease when the cache is enabled. Returns the bytes to *retain*
        in HBM (the caller frees ``lease.nbytes - retained``): ownership
        of the model-prefix bytes transfers from the lease to a cache
        entry. A lease with ``model_bytes == 0`` rode an existing entry
        (its request was admitted with ``mem_model = 0``) — it unpins
        the entry and retains nothing of its own."""
        key = (server.server_id, lease.accel, lease.model_key)
        e = self.entries.get(key)
        if lease.model_bytes <= 0.0:
            if e is not None:
                e.pins = max(0, e.pins - 1)
                # The model was certainly resident until the lease ended.
                e.last_hit = max(e.last_hit, lease.end)
            return 0.0
        if e is None:
            self.entries[key] = CacheEntry(
                server_id=server.server_id, accel=lease.accel,
                model_key=lease.model_key, split=lease.split,
                charged=lease.model_bytes, last_hit=lease.end, hits=1.0)
            self.retained_bytes += lease.model_bytes
            self._bump_peak(server.server_id, lease.accel)
            return lease.model_bytes
        e.last_hit = max(e.last_hit, lease.end)
        e.hits += 1.0
        if lease.split <= e.split:
            return 0.0                  # prefix already cached at least as deep
        extra = max(0.0, lease.model_bytes - e.charged)
        e.split = lease.split
        e.charged = max(e.charged, lease.model_bytes)
        self.retained_bytes += extra
        self._bump_peak(server.server_id, lease.accel)
        return extra

    # -- eviction --------------------------------------------------------------
    def _evict(self, server: "HapiServer", e: CacheEntry, t: float,
               reason: str) -> float:
        del self.entries[e.key]
        server.accels[e.accel].free(e.charged)
        self.evicted += 1
        self.evicted_bytes += e.charged
        self.evictions.append((t, e.server_id, e.accel, e.model_key,
                               e.charged, reason))
        if server.sim is not None:
            server.sim.record(t, "cache-evict",
                              f"s{e.server_id} a{e.accel} {e.model_key} "
                              f"{e.charged:.3e} {reason}")
            mx = server.sim.metrics
            mx.inc("evict_total", model=e.model_key, reason=reason)
        return e.charged

    def expire(self, server: "HapiServer", t: float) -> float:
        """Drop this server's entries idle past the keep-warm window
        (pinned entries wait for their leases). Returns bytes freed."""
        stale = [e for e in self.entries.values()
                 if e.server_id == server.server_id and e.pins == 0
                 and e.last_hit + self.window <= t]
        freed = 0.0
        for e in self.policy.order(stale, t):
            freed += self._evict(server, e, t, "expire")
        return freed

    def release(self, server: "HapiServer", accel: int, need: float,
                t: float, keep: Set[str]) -> float:
        """Pressure eviction: free at least ``need`` bytes on one
        accelerator *before* Eq. 4 would shrink batches, in policy
        victim order. Entries pinned by active leases or whose model is
        in ``keep`` (needed by the round being planned) are untouchable.
        Returns bytes actually freed (may fall short)."""
        if need <= 0.0:
            return 0.0
        victims = [e for e in self.entries.values()
                   if e.server_id == server.server_id and e.accel == accel
                   and e.pins == 0 and e.model_key not in keep]
        freed = 0.0
        for e in self.policy.order(victims, t):
            if freed >= need:
                break
            freed += self._evict(server, e, t, "pressure")
        return freed

    def drop_server(self, server: "HapiServer", t: float = 0.0) -> None:
        """Crash path: the replica's HBM is gone, and so is every entry
        on it (``kill()`` zeroes ``mem_used`` itself — no per-entry
        ``free``, the bytes no longer exist)."""
        dead = sorted((k for k in self.entries
                       if k[0] == server.server_id))
        for k in dead:
            e = self.entries.pop(k)
            self.evicted += 1
            self.evicted_bytes += e.charged
            self.evictions.append((t, e.server_id, e.accel, e.model_key,
                                   e.charged, "crash"))
            if server.sim is not None:
                mx = server.sim.metrics
                mx.inc("evict_total", model=e.model_key, reason="crash")


__all__ = ["WeightCache", "CacheEntry", "LruEviction",
           "DemandWeightedEviction", "EVICTION_POLICIES"]
