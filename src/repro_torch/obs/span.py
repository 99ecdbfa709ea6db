"""Structured spans: the causal request tree across the tiers.

A :class:`Span` is one timed interval on one resource track (an
accelerator, a storage node, a WAN link, a client) with a parent link,
so every request carried through the fleet yields a tree::

    request (tenant track)
      |- storage.read   (storage node track)
      |- admission      (replica scheduler track)
      |- cos.compute    (accelerator track)       [+ model.load, quantize]
      |- wire.transfer  (tenant WAN link track)
      `- client.compute (client accelerator track)

Spans are emitted *alongside* the :class:`~repro_torch.cos.clock.EventLog`,
never into it — the golden event-log digests stay byte-identical with
tracing on (asserted by tests/test_obs.py). All times are virtual
seconds from the shared simulator clock, so a span trace is as
deterministic as the event log: same seed, same spans, same digest.

Emission-site convention (enforced by the schema-stability tests, which
grep for it): call through a local variable named ``tr`` —
``tr.emit("cos.compute", ...)`` — with the span name as a literal.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.schema import validate_span_name, validate_tier

Labels = Tuple[Tuple[str, str], ...]


class Span:
    """One timed interval on a resource track (mutable ``t1`` so open
    spans can be extended as a request progresses through the tiers)."""

    __slots__ = ("span_id", "parent_id", "name", "tier", "track",
                 "t0", "t1", "labels")

    def __init__(self, span_id: int, parent_id: int, name: str, tier: str,
                 track: str, t0: float, t1: float,
                 labels: Labels = ()) -> None:
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.tier = tier
        self.track = track
        self.t0 = t0
        self.t1 = t1
        self.labels = labels

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def as_tuple(self) -> tuple:
        return (self.span_id, self.parent_id, self.name, self.tier,
                self.track, self.t0, self.t1, self.labels)

    def __repr__(self) -> str:  # digest-stable
        return f"Span{self.as_tuple()!r}"


class Tracer:
    """Append-only span collector shared by every component of a
    deployment (lives on the :class:`~repro_torch.cos.clock.Simulator`).

    ``enabled=False`` turns every call into a no-op returning -1, so
    instrumented code needs no branching beyond the cheap flag check it
    already performs — and a disabled run's event log is trivially
    byte-identical to an enabled one's (nothing shares state).

    ``max_spans`` (None = unbounded, the default) caps retention for
    fleet-scale sweeps: once the window fills, the oldest spans are
    dropped (counted in ``dropped``), span ids keep increasing, and
    :meth:`extend` on an evicted span becomes a no-op — bounded memory
    in exchange for a window-local trace. The unbounded default is
    byte-identical to the historical behavior (``digest()`` included);
    compact-retention simulators set the cap."""

    def __init__(self, enabled: bool = True,
                 max_spans: Optional[int] = None) -> None:
        self.enabled = enabled
        self.max_spans = max_spans
        self.dropped = 0
        self._base = 0               # span_id of _spans[0]
        self._spans: List[Span] = []
        # Hot-loop buffer: raw (name, tier, track, t0, t1, parent, labels)
        # tuples from emit_fast, materialized (and validated) into Span
        # objects lazily on first query — replay emits ~100k spans/s and
        # must not pay object construction per request.
        self._raw: List[tuple] = []

    @property
    def spans(self) -> List[Span]:
        self._materialize()
        return self._spans

    def _materialize(self) -> None:
        if self._raw:
            spans = self._spans
            base = self._base
            for name, tier, track, t0, t1, parent, labels in self._raw:
                validate_span_name(name)
                validate_tier(tier)
                spans.append(Span(base + len(spans), parent, name, tier,
                                  track, t0, t1, labels))
            self._raw.clear()
            self._trim()

    def _trim(self) -> None:
        # Evict in batches (only once the window overshoots 2x the cap,
        # cutting back to the cap): a per-emit front-of-list delete would
        # memmove the whole window on every span past the cap.
        cap = self.max_spans
        if cap is not None and len(self._spans) >= 2 * cap:
            k = len(self._spans) - cap
            del self._spans[:k]
            self._base += k
            self.dropped += k

    # -- emission --------------------------------------------------------------
    def emit(self, name: str, t0: float, t1: float, *, tier: str,
             track: str, parent: int = -1, labels: Labels = ()) -> int:
        """Append one complete span; returns its id (-1 when disabled)."""
        if not self.enabled:
            return -1
        validate_span_name(name)
        validate_tier(tier)
        self._materialize()
        sid = self._base + len(self._spans)
        self._spans.append(Span(sid, parent, name, tier, track, t0, t1,
                                tuple(labels)))
        self._trim()
        return sid

    def emit_fast(self, name: str, t0: float, t1: float, tier: str,
                  track: str, parent: int = -1,
                  labels: Labels = ()) -> None:
        """Positional, deferred-validation emission for hot loops (the
        trace replayer's ~10 us/request path): appends one raw tuple,
        deferring Span construction and schema validation to the first
        query. No span id is returned — fast spans cannot parent."""
        if self.enabled:
            raw = self._raw
            raw.append((name, tier, track, t0, t1, parent, labels))
            cap = self.max_spans
            if cap is not None:
                spans = self._spans
                k = len(spans) + len(raw) - 2 * cap
                if k >= 0:
                    # Trim without materializing: ids are sequential, so
                    # every _spans entry precedes every raw tuple — evict
                    # oldest-first straight off the buffers (k + cap
                    # total retained, same batch-at-2x-cap policy as
                    # _trim) and never construct a Span that the window
                    # would immediately drop.
                    k += cap
                    ks = min(k, len(spans))
                    if ks:
                        del spans[:ks]
                    if k > ks:
                        del raw[:k - ks]
                    self._base += k
                    self.dropped += k

    def begin(self, name: str, t0: float, *, tier: str, track: str,
              parent: int = -1, labels: Labels = ()) -> int:
        """Open a span at ``t0`` (zero duration until extended)."""
        return self.emit(name, t0, t0, tier=tier, track=track,
                         parent=parent, labels=labels)

    def extend(self, span_id: int, t1: float) -> None:
        """Grow a span's end time (monotonic: ``max`` of old and new, so
        late observers — wire pulls after fleet accounting — compose).
        A no-op for spans already evicted from a bounded window."""
        if span_id >= 0 and self.enabled:
            idx = span_id - self._base
            if idx < 0:
                return
            # Ids are only handed out by emit/begin, which materialize at
            # call time — so the target is always already in _spans and a
            # pending raw buffer can be left untouched (no flush on the
            # per-request extend path).
            s = self._spans[idx]
            if t1 > s.t1:
                s.t1 = t1

    def clear(self) -> None:
        self._spans.clear()
        self._raw.clear()

    # -- queries ---------------------------------------------------------------
    def __len__(self) -> int:
        """Retained spans (the queryable window)."""
        return len(self._spans) + len(self._raw)

    @property
    def total(self) -> int:
        """Spans ever emitted, including any a bounded window dropped."""
        return self.dropped + len(self)

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def roots(self) -> List[Span]:
        return [s for s in self.spans if s.parent_id < 0]

    def children(self, span_id: int) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span_id]

    def tree(self, span_id: int) -> List[Span]:
        """The span and every transitive child, in emission order."""
        keep = {span_id}
        out = []
        for s in self.spans:
            if s.span_id in keep or s.parent_id in keep:
                keep.add(s.span_id)
                out.append(s)
        return out

    def tracks(self) -> Dict[str, List[Span]]:
        """Spans grouped by ``(tier, track)`` — the Perfetto row view."""
        out: Dict[str, List[Span]] = {}
        for s in self.spans:
            out.setdefault(f"{s.tier}/{s.track}", []).append(s)
        return out

    def digest(self) -> str:
        """sha256 over every span tuple — the determinism fingerprint
        (same seed => identical digest, asserted by tests/test_obs.py).
        A bounded window hashes its retained spans plus the drop count
        (still deterministic per seed, not comparable to unbounded)."""
        h = hashlib.sha256()
        if self.dropped:
            h.update(f"dropped:{self.dropped};".encode())
        for s in self.spans:
            h.update(repr(s.as_tuple()).encode())
        return h.hexdigest()
