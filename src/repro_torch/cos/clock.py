"""Deterministic discrete-event simulator + resource timelines for the
COS runtime.

A copy of ``repro/cos/clock.py``, operation for operation, so event logs
and their digests come out bit-identical to the JAX package's for the same
inputs; only :class:`Accelerator`'s defaults differ: the port's ``HW`` (one
H100) in place of the TPU's.

Benchmarks must be reproducible and fast on CPU, so time is simulated:
every resource (network link, accelerator slice, storage node) is a
timeline that admits work intervals; transfers/compute advance the clock
by modeled durations instead of sleeping. The same server/client code
also executes the *real* computation on the card (live mode) — the clock
only decides what the wall would have shown on the modeled testbed.

The :class:`Simulator` is the single source of truth for virtual time in
a fleet run: one event queue, deterministic ordering (ties broken by
insertion sequence), a seedable RNG, and a trace log shared by the
object store, every server replica, and every client. Two runs with the
same seed produce byte-identical traces.

Retention modes (the fleet-scale knob): ``retention="full"`` (default)
keeps every event; ``digest()``, ``filter()`` and the per-kind index
see all of it. ``retention="compact"`` keeps only a bounded tail of
recent events plus per-kind counts and a *streaming* sha256 of
everything ever logged: memory stays O(tail) no matter how many events a
256-replica sweep records, and :meth:`EventLog.stream_digest` is
identical across modes for the same event stream (the determinism check
that replaces tuple equality at scale).
"""
from __future__ import annotations

import hashlib
import heapq
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.config import HW
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.span import Tracer

#: Default bounded-tail length (and streaming-digest fold granularity)
#: for compact retention. The digest folds events in chunks of this many
#: at a time, so two logs only compare equal when built with the same
#: ``tail`` — keep it a module constant unless a test needs otherwise.
DEFAULT_LOG_TAIL = 1024

_RETENTIONS = ("full", "compact")


class _SimMetrics(MetricsRegistry):
    """Simulator-attached registry with deferred event-kind counting.

    ``Simulator.record``/``run_until`` bump :attr:`pending_kinds` — a
    plain dict — once per event instead of walking the labeled-counter
    machinery; any read folds the pending counts in first, so even a
    long-held reference never observes a stale ``events_total``.
    Stage metrics (``inc``/``gauge_set``/``observe``) stay eager on
    purpose: deferring them would have to remember every distinct
    (key, labels) shape it ever saw, which is exactly the unbounded
    cardinality the registry's rollup mode exists to cap — and the
    eager path measures no slower at the 256-replica cell."""

    def __init__(self) -> None:
        # Rollup, not raise: at fleet scale the (tenant x server) cross
        # product legitimately exceeds the cardinality bound, and totals
        # must survive it.
        super().__init__(overflow="rollup")
        self.pending_kinds: Dict[str, int] = {}
        self._kind_ls: Dict[str, Tuple[Tuple[str, str], ...]] = {}

    def _flush(self) -> None:
        self._flush_kinds()

    def _flush_kinds(self) -> None:
        pend = self.pending_kinds
        if not pend:
            return
        ls_cache = self._kind_ls
        items = list(pend.items())
        pend.clear()
        series = self._counters.get("events_total")
        if series is None:
            # First flush: admit the key through the normal emission
            # path (schema + cross-family checks run there).
            mx = super()
            mx.inc("events_total", 0.0, kind=items[0][0])
            series = self._counters["events_total"]
        for kind, n in items:
            ls = ls_cache.get(kind)
            if ls is None:
                ls = ls_cache[kind] = (("kind", kind),)
            # Bitwise-identical to per-event inc(): integer-valued float
            # sums are exact, and kinds appear in first-seen order either
            # way. _bound is skipped deliberately — the kind vocabulary
            # is schema-bounded.
            series[ls] = series.get(ls, 0.0) + n

    # Every read replays buffered writes first.
    def total(self, key: str) -> float:
        self._flush()
        return super().total(key)

    def counter_value(self, key: str, **labels) -> float:
        self._flush()
        return super().counter_value(key, **labels)

    def counters(self, key: str):
        self._flush()
        return super().counters(key)

    def gauge_value(self, key: str, **labels) -> float:
        self._flush()
        return super().gauge_value(key, **labels)

    def histogram(self, key: str, **labels):
        self._flush()
        return super().histogram(key, **labels)

    def percentile(self, key: str, q: float, **labels) -> float:
        self._flush()
        return super().percentile(key, q, **labels)

    def label_set_count(self, key: str) -> int:
        self._flush()
        return super().label_set_count(key)

    def snapshot(self):
        self._flush()
        return super().snapshot()

    def dump(self) -> str:
        self._flush()
        return super().dump()


class EventLog:
    """Trace of ``(t, kind, detail)`` tuples with two retention modes.

    **full** (default): append-only, with a per-kind index maintained on
    :meth:`add` so :meth:`filter` (and cross-kind selections like
    ``HapiFleet.scale_events``) stay O(matches) instead of O(N)-scanning
    the ever-growing trace list. :meth:`digest` is byte-identical to the
    pre-index behavior.

    **compact**: ``events`` holds only the most recent ``tail``..2×
    ``tail`` entries; older events are folded into a streaming sha256 in
    ``tail``-sized chunks and dropped. Per-kind totals survive in
    :meth:`count`/:meth:`counts`; :meth:`filter`/:meth:`filter_many`
    see the retained tail only. :meth:`stream_digest` hashes the *whole*
    stream and is computed with the same chunking in full mode, so a
    same-seed full and compact run produce the identical hex digest.
    """

    def __init__(self, retention: str = "full",
                 tail: int = DEFAULT_LOG_TAIL) -> None:
        if retention not in _RETENTIONS:
            raise ValueError(
                f"retention must be one of {_RETENTIONS}, got {retention!r}")
        self.retention = retention
        self.tail = int(tail)
        self._compact = retention == "compact"
        self.events: List[Tuple[float, str, str]] = []
        # full mode: kind -> [(position_in_events, event), ...]; positions
        # let multi-kind selections merge back into log order cheaply.
        self._by_kind: Dict[str, List[Tuple[int, Tuple[float, str, str]]]] = {}
        # compact mode: per-kind totals + the streaming hash of the
        # folded prefix (always a multiple of `tail` events long).
        self._counts: Dict[str, int] = {}
        self._total = 0
        self._hash = hashlib.sha256()
        self._folded = 0

    def add(self, t: float, kind: str, detail: str = "") -> None:
        if self._compact:
            c = self._counts
            c[kind] = c.get(kind, 0) + 1
            self._total += 1
            ev = self.events
            ev.append((t, kind, detail))
            if len(ev) >= 2 * self.tail:
                self._hash.update(repr(tuple(ev[:self.tail])).encode())
                del ev[:self.tail]
                self._folded += self.tail
        else:
            e = (t, kind, detail)
            self._by_kind.setdefault(kind, []).append((len(self.events), e))
            self.events.append(e)

    def __len__(self) -> int:
        """Total events ever logged (compact mode keeps counting past
        the retained tail — use this, not ``len(log.events)``, for
        throughput accounting)."""
        return self._total if self._compact else len(self.events)

    @property
    def total(self) -> int:
        return len(self)

    def count(self, kind: str) -> int:
        """Total events of ``kind`` without materializing a hit list —
        what count-only callers should use instead of
        ``len(log.filter(kind))``. O(1) in both modes."""
        if self._compact:
            return self._counts.get(kind, 0)
        return len(self._by_kind.get(kind, ()))

    def counts(self) -> Dict[str, int]:
        """Per-kind totals (insertion order of first occurrence)."""
        if self._compact:
            return dict(self._counts)
        return {k: len(v) for k, v in self._by_kind.items()}

    def filter(self, kind: str) -> List[Tuple[float, str, str]]:
        if self._compact:
            return [e for e in self.events if e[1] == kind]
        return [e for _, e in self._by_kind.get(kind, ())]

    def filter_many(self, kinds) -> List[Tuple[float, str, str]]:
        """Events of any of ``kinds``, in log order (index-merged in
        full mode; a tail scan under compact retention)."""
        if self._compact:
            ks = frozenset(kinds)
            return [e for e in self.events if e[1] in ks]
        hits = [pe for k in kinds for pe in self._by_kind.get(k, ())]
        hits.sort(key=lambda pe: pe[0])
        return [e for _, e in hits]

    def kinds(self) -> List[str]:
        """Every event kind recorded so far (insertion order)."""
        return list(self._counts) if self._compact else list(self._by_kind)

    def digest(self) -> Tuple:
        """Hashable snapshot for determinism checks (same seed => equal).

        Full mode returns the historical tuple-of-events — byte-identical
        to the pre-refactor behavior the golden tests pin. Compact mode
        cannot (the prefix is gone), so it returns a compact fingerprint
        ``("compact", total, stream_digest())`` with the same equality
        semantics. Cross-mode comparisons should use
        :meth:`stream_digest`, which is mode-independent."""
        if self._compact:
            return ("compact", self._total, self.stream_digest())
        return tuple(self.events)

    def stream_digest(self) -> str:
        """sha256 hex digest over the *entire* event stream, identical
        across retention modes: events are hashed in ``tail``-sized
        ``repr(tuple(chunk))`` folds (plus a final partial chunk), which
        is exactly how compact mode folded its dropped prefix."""
        h = self._hash.copy() if self._compact else hashlib.sha256()
        ev, tail = self.events, self.tail
        for i in range(0, len(ev), tail):
            h.update(repr(tuple(ev[i:i + tail])).encode())
        return h.hexdigest()


class Simulator:
    """Single-queue discrete-event simulator.

    Two roles:

    * **Event queue** — control events (server kills/restarts, autoscaler
      ticks, request arrivals) are scheduled with :meth:`schedule` and
      fired in deterministic ``(time, insertion-seq)`` order by
      :meth:`run_until`.
    * **Shared trace** — components :meth:`record` every modeled action
      (reads, serves, routes, scale events) into one log, so a whole
      fleet run has a single totally-ordered, seed-reproducible history.

    ``retention="compact"`` bounds every growing side structure for
    fleet-scale sweeps: the event log keeps a tail + streaming digest
    (see :class:`EventLog`) and the tracer keeps a bounded span window.
    In *both* modes the per-event ``events_total`` metric increments are
    deferred into a plain dict that :attr:`metrics` folds into the
    registry on access — the hot loop pays one dict update instead of a
    labeled-counter path per event. ``metrics().total("events_total")``
    and per-kind totals are identical across modes (integer-valued float
    sums are exact), which the compaction-identity tests assert.
    """

    def __init__(self, seed: int = 0, retention: str = "full",
                 log_tail: int = DEFAULT_LOG_TAIL) -> None:
        import numpy as np

        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.now = 0.0
        self.retention = retention
        self._compact = retention == "compact"
        self.log = EventLog(retention=retention, tail=log_tail)
        # Observability sidecars: structured spans + metrics live NEXT TO
        # the event log, never inside it — log digests stay byte-identical
        # with tracing on (tests/test_torch_runtime.py asserts this). Compact
        # retention bounds the tracer too (spans otherwise dominate RSS
        # in traced sweeps).
        self.tracer = Tracer()
        if self._compact:
            self.tracer.max_spans = 4096
        self._metrics = _SimMetrics()
        # Hot-loop alias for the registry's deferred event-kind counts
        # (see _SimMetrics): record/run_until bump this dict; counter
        # reads on the registry fold it in.
        self._kind_counts = self._metrics.pending_kinds
        self._queue: List[Tuple[float, int, str, str, Optional[Callable]]] = []
        self._seq = 0

    @property
    def metrics(self) -> MetricsRegistry:
        return self._metrics

    # -- event queue ---------------------------------------------------------
    def schedule(self, t: float, kind: str, detail: str = "",
                 callback: Optional[Callable[[], None]] = None) -> None:
        """Enqueue a control event at absolute virtual time ``t``."""
        heapq.heappush(self._queue, (t, self._seq, kind, detail, callback))
        self._seq += 1

    def next_event_time(self) -> Optional[float]:
        return self._queue[0][0] if self._queue else None

    def run_until(self, t: float) -> int:
        """Fire every queued event with time <= t; returns #fired.

        Advances :attr:`now` monotonically (it never moves backwards even
        if ``t`` is in the past — resources may have reserved ahead).

        The loop is batched: bindings are hoisted out so a run of
        due events (the common same-timestamp dispatch bursts at fleet
        scale) drains with one dict update + one log append each instead
        of per-event attribute traversal and a labeled-counter call.
        """
        fired = 0
        q = self._queue
        now = self.now
        if q and q[0][0] <= t:
            pop = heapq.heappop
            log_add = self.log.add
            counts = self._kind_counts
            while q and q[0][0] <= t:
                et, _, kind, detail, cb = pop(q)
                if et > now:
                    now = et
                counts[kind] = counts.get(kind, 0) + 1
                log_add(et, kind, detail)
                fired += 1
                if cb is not None:
                    # Callbacks may read/advance the clock or schedule
                    # more events: publish `now` first, re-adopt after.
                    self.now = now
                    cb()
                    if self.now > now:
                        now = self.now
        self.now = now if now > t else t
        return fired

    def run(self) -> int:
        """Drain the entire event queue (clock ends at the last event)."""
        fired = 0
        while self._queue:
            fired += self.run_until(self._queue[0][0])
        return fired

    # -- shared trace --------------------------------------------------------
    def record(self, t: float, kind: str, detail: str = "") -> None:
        """The single choke point for trace accounting: one deferred
        ``events_total`` count + one log append. ``run_until`` inlines
        exactly this pair."""
        c = self._kind_counts
        c[kind] = c.get(kind, 0) + 1
        self.log.add(t, kind, detail)


@dataclass
class Timeline:
    """A serially-reusable resource (link, accelerator, disk)."""
    name: str
    busy_until: float = 0.0
    busy_time: float = 0.0
    sim: Optional[Simulator] = None

    def attach(self, sim: Simulator) -> "Timeline":
        self.sim = sim
        return self

    def reserve(self, start: float, duration: float) -> Tuple[float, float]:
        """Schedule work at >= start; returns (actual_start, end)."""
        s = max(start, self.busy_until)
        e = s + duration
        self.busy_until = e
        self.busy_time += duration
        if self.sim is not None:
            self.sim.record(s, "busy", f"{self.name} {duration:.3e}")
        return s, e

    def note(self, start: float, end: float) -> None:
        """Account an interval scheduled by an external scheduler (the
        network fabric computes contended transfer schedules itself and
        only reports the outcome back onto the timeline)."""
        self.busy_until = max(self.busy_until, end)
        self.busy_time += end - start
        if self.sim is not None:
            self.sim.record(start, "busy", f"{self.name} {end - start:.3e}")


@dataclass
class Link(Timeline):
    bandwidth: float = 125e6   # bytes/s (1 Gbps default, paper §7.1)
    latency: float = 1e-3

    def transfer(self, start: float, nbytes: float) -> Tuple[float, float]:
        return self.reserve(start, self.latency + nbytes / self.bandwidth)


@dataclass
class Accelerator(Timeline):
    """Storage- or client-side accelerator with an HBM budget.
    ``slowdown`` models a degraded/straggling device (unknown to the
    scheduler — stragglers are by definition unpredicted)."""
    flops: float = HW.peak_flops_bf16
    hbm: float = HW.hbm_capacity
    mem_used: float = 0.0
    slowdown: float = 1.0

    def compute(self, start: float, flops: float, efficiency: float = 0.4):
        return self.reserve(start, self.slowdown * flops / (self.flops * efficiency))

    def try_alloc(self, nbytes: float) -> bool:
        if self.mem_used + nbytes > self.hbm:
            return False
        self.mem_used += nbytes
        return True

    def free(self, nbytes: float) -> None:
        self.mem_used = max(0.0, self.mem_used - nbytes)
