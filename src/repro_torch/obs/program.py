"""The running program's spans and counters, on the host's real clock.

The simulator stamps :class:`~repro_torch.obs.span.Tracer` spans in virtual
seconds. This module holds one process-wide tracer of the same class in a
real-clock mode, :data:`TRACER`, and one :data:`METRICS` registry, for the
program itself: the data path, the tier split and train step, and the
storage tier's executor record a span at each layer boundary. It is **off**
by default (:func:`enable`, :func:`tracing`); a span site that is off reads
one attribute and creates no object::

    tr = TRACER
    with tr.span("train.tune", batch):      # a no-op context while off
        ...

A span records its name and parent (a per-thread stack of open spans), the
id of the step or extraction call it belongs to (``unit``: its root's id),
host start and end from ``time.time_ns()`` -- the clock ``torch.profiler``
stamps its events with -- and, while a profiler records, a
``record_function("repro_torch.<name>")`` range, so its trace shows the
span on the device timeline's clock. Where
its tensors are on a card, two ``torch.cuda.Event`` (from a reused pool) on
the current stream give its stream time; they are resolved lazily, when the
window is read or trimmed, never on the hot path, and none is recorded while
the stream is capturing a graph. Counts of rows, tokens and bytes are taken
at the same boundary from the span's ``data``.

:func:`summary` reads the window: per span name the median over units (a
step, an extraction call, a request) of host ms, stream ms and self ms (the
span less its children), and the counters. :func:`idle_gaps` names a
profiler trace's idle device time by the innermost ``repro_torch.*`` range,
and :func:`export_beside` writes the spans into a profiler's chrome trace.
A MoE call also keeps its experts' load imbalance (:func:`record_expert_loads`),
worked out on the card and read with the window.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import statistics
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.obs.export import chrome_trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.schema import PROGRAM_METRIC_KEYS, PROGRAM_SPAN_NAMES, validate_span_name
from repro_torch.obs.span import Span, Tracer

#: Retained spans before the window trims (down to this many, at twice it).
MAX_SPANS = 4096
#: Prefix of every span's ``record_function`` range.
RANGE_PREFIX = "repro_torch."
#: The export's tier of every program span; the track is the thread's name.
TIER = "compute"

_OFF = contextlib.nullcontext()
# Whether a profiler is recording: a span enters its range only then (a
# range costs about as much as the rest of the span). The range's two
# operators, as ``torch.profiler.record_function`` calls them, are looked up
# here: the first lookup takes about a millisecond.
_profiling = torch._C._autograd._profiler_enabled
_range_enter = torch.ops.profiler._record_function_enter_new
_range_exit = torch.ops.profiler._record_function_exit._RecordFunction


def _leaves(data) -> list:
    """The tensors or numpy arrays of ``data``: one, or a dict, tuple or
    list of them."""
    if data is None:
        return []
    if isinstance(data, dict):
        return list(data.values())
    return list(data) if isinstance(data, (tuple, list)) else [data]


def _counts(leaves: list) -> tuple:
    """Rows (the first leaf's leading size), tokens (rows times its second
    size) and bytes (every leaf)."""
    if not leaves:
        return ()
    shape = leaves[0].shape
    rows = int(shape[0]) if len(shape) else 1
    tokens = rows * int(shape[1]) if len(shape) > 1 else rows
    return (("rows", rows), ("tokens", tokens), ("bytes", sum(int(x.nbytes) for x in leaves)))


def _card(where) -> Optional[torch.device]:
    """The CUDA device ``where`` (a device, its name, or tensors) is on."""
    if isinstance(where, (str, torch.device)):
        dev = torch.device(where)
    else:
        leaves = where if isinstance(where, list) else _leaves(where)
        dev = getattr(leaves[0], "device", None) if leaves else None
    return dev if isinstance(dev, torch.device) and dev.type == "cuda" else None


class ProgramSpan(Span):
    """A span of the running program; a context manager, opened by
    :meth:`ProgramTracer.span`. ``t0``/``t1`` are seconds on the host's
    real clock; ``stream_ms`` is None until resolved, or without a card."""

    __slots__ = ("unit", "counts", "is_open", "_stream_ms", "_tracer", "_range", "_events",
                 "_stream")

    def __init__(self, tracer: "ProgramTracer", name: str, data, where) -> None:
        super().__init__(-1, -1, name, TIER, "", 0.0, 0.0)
        self._tracer = tracer
        leaves = _leaves(data)
        self.unit = -1
        self.counts = _counts(leaves)
        self.is_open = False
        self._stream_ms = None
        self._range = None
        self._events = None
        # The card until the span opens, then the stream it is timed on.
        self._stream = _card(leaves if where is None else where)

    def __enter__(self) -> "ProgramSpan":
        tr = self._tracer
        stack = tr._stack()
        parent = stack[-1] if stack else None
        self.track = threading.current_thread().name
        if _profiling():
            self._range = _range_enter(RANGE_PREFIX + self.name, None)
        self.t0 = self.t1 = time.time_ns() * 1e-9
        card = self._stream
        self._stream = None
        if card is not None and not torch.cuda.is_current_stream_capturing():
            self._stream = torch.cuda.current_stream(card)
            self._events = (tr._event(), tr._event())
            self._events[0].record(self._stream)
        self.is_open = True
        tr._append(self, parent)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> None:
        if self._events is not None:
            self._events[1].record(self._stream)
        self.t1 = time.time_ns() * 1e-9
        self.is_open = False
        if self._range is not None:
            _range_exit(self._range)
            self._range = None
        self._tracer._stack().pop()

    @property
    def stream_ms(self) -> Optional[float]:
        self.resolve(wait=True)
        return self._stream_ms

    def resolve(self, wait: bool) -> None:
        """The stream time out of the span's events, which go back to the
        pool; without ``wait`` only where the device has passed them."""
        ev = self._events
        if ev is None or self.is_open or not (wait or ev[1].query()):
            return
        ev[1].synchronize()
        self._stream_ms = ev[0].elapsed_time(ev[1])
        self.labels = self.labels + (("stream_ms", self._stream_ms),)
        self.release()

    def release(self) -> None:
        """The span's events back to the pool, unread (a closed span only)."""
        if self._events is not None and not self.is_open:
            self._tracer._pool.extend(self._events)
            self._events = None


class ProgramTracer(Tracer):
    """The :class:`Tracer` window in real-clock mode: spans opened by
    :meth:`span` on the host's clock, off until :attr:`enabled` is set,
    bounded at ``max_spans``. Thread-safe: the data path's producer thread
    records its own spans on its own track."""

    def __init__(self, max_spans: int = MAX_SPANS) -> None:
        super().__init__(enabled=False, max_spans=max_spans)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._pool: List = []

    def span(self, name: str, data=None, where=None):
        """A span of ``name`` around a ``with`` block (a shared no-op context
        while off). ``data``: tensors or numpy arrays whose rows, tokens and
        bytes it counts; its stream is timed where ``where`` (a device or
        tensors; by default ``data``) is on a card."""
        if not self.enabled:
            return _OFF
        return ProgramSpan(self, validate_span_name(name, PROGRAM_SPAN_NAMES), data, where)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self):
        try:
            return self._pool.pop()
        except IndexError:
            return torch.cuda.Event(enable_timing=True)

    def _append(self, s: ProgramSpan, parent: Optional[ProgramSpan]) -> None:
        with self._lock:
            s.span_id = self._base + len(self._spans)
            if parent is None:
                s.unit = s.span_id
            else:
                s.parent_id, s.unit = parent.span_id, parent.unit
            s.labels = (("unit", s.unit),) + s.counts
            self._spans.append(s)
            self._trim()

    def _trim(self) -> None:
        cap = self.max_spans
        if len(self._spans) >= 2 * cap:
            k = len(self._spans) - cap
            for s in self._spans[:k]:
                s.release()
            for s in self._spans[k:]:
                s.resolve(wait=False)
            super()._trim()

    @property
    def spans(self) -> List[Span]:
        """The window's spans, each closed one's stream time resolved (this
        waits for the device to pass their events)."""
        with self._lock:
            spans = list(self._spans)
        for s in spans:
            s.resolve(wait=True)
        return spans

    def clear(self) -> None:
        """Drops the window; ids go on from where they were, so a span still
        open (another thread's) keeps its own."""
        with self._lock:
            for s in self._spans:
                s.release()
            self._base += len(self._spans)
            self.dropped = 0
            super().clear()


#: The program's tracer and registry: one each per process.
TRACER = ProgramTracer()
METRICS = MetricsRegistry(keys=PROGRAM_METRIC_KEYS)
#: Each traced MoE call's expert-load imbalance (its busiest expert's rows
#: over the mean), a 0-d tensor on the card until :func:`summary` reads it.
EXPERT_LOADS: collections.deque = collections.deque(maxlen=MAX_SPANS)


def record_expert_loads(counts: torch.Tensor) -> None:
    """Keeps the imbalance of ``counts`` (rows routed to each expert), worked
    out on their device with no synchronise; it is read with the window."""
    if TRACER.enabled:
        c = counts.detach().to(torch.float32)
        EXPERT_LOADS.append(c.max() / c.mean().clamp(min=1e-30))


def enable(on: bool = True) -> None:
    """Turns the program's spans and counters on or off."""
    TRACER.enabled = on


@contextlib.contextmanager
def tracing():
    """The program traced inside the block, on a cleared window and
    registry; the tracer's state before it afterwards."""
    was = TRACER.enabled
    TRACER.clear()
    METRICS.clear()
    EXPERT_LOADS.clear()
    TRACER.enabled = True
    try:
        yield TRACER
    finally:
        TRACER.enabled = was


def count_copy(key: str, host) -> None:
    """Adds to counter ``key`` the bytes of ``host``, the host side of
    copies to or from a card (tensors or numpy arrays), labelled by whether
    each is pinned (a numpy array never is)."""
    for t in host:
        pinned = isinstance(t, torch.Tensor) and t.is_pinned()
        METRICS.inc(key, int(t.nbytes), memory="pinned" if pinned else "pageable")


def _median(values: list) -> Optional[float]:
    return statistics.median(values) if values else None


def summary(tracer: ProgramTracer = TRACER, metrics: MetricsRegistry = METRICS) -> dict:
    """Per span name, over the units (a root span and its tree) that hold it:
    ``units``, and the per-unit median of ``n`` (spans), ``host_ms``,
    ``stream_ms`` (None without a card), ``self_ms`` (host time less the
    children's) and each count; then the counters. Reading resolves the
    stream times, so it waits for the device."""
    closed = [s for s in tracer.spans if not s.is_open]
    inner: Dict[int, float] = {}
    for s in closed:
        if s.parent_id >= 0:
            inner[s.parent_id] = inner.get(s.parent_id, 0.0) + s.duration
    per: Dict[str, Dict[int, dict]] = {}
    for s in closed:
        u = per.setdefault(s.name, {}).setdefault(s.unit, {"n": 0, "host_ms": 0.0,
                                                           "self_ms": 0.0, "stream": []})
        u["n"] += 1
        u["host_ms"] += 1e3 * s.duration
        u["self_ms"] += 1e3 * (s.duration - inner.get(s.span_id, 0.0))
        u["stream"].append(s._stream_ms)
        for k, v in s.counts:
            u[k] = u.get(k, 0) + v
    spans = {}
    for name, units in per.items():
        rows = list(units.values())
        row = {"units": len(rows)}
        for k in ("n", "host_ms", "self_ms", "rows", "tokens", "bytes"):
            vals = [u[k] for u in rows if k in u]
            if vals:
                row[k] = _median(vals)
        row["stream_ms"] = _median([sum(u["stream"]) for u in rows
                                    if u["stream"] and None not in u["stream"]])
        spans[name] = row
    out = {"spans": spans, "counters": metrics.snapshot()["counters"],
           "dropped": tracer.dropped}
    if EXPERT_LOADS:
        # The later moe_imbalance metric's source: the median over MoE calls.
        out["moe_imbalance"] = _median([float(x) for x in EXPERT_LOADS])
    return out


def format_summary(s: dict) -> str:
    """One line per span name, then one of the counters."""
    def ms(x):
        return "-" if x is None else f"{x:.3f} ms"
    lines = [f"  {name:<17} host {ms(r['host_ms'])}  stream {ms(r['stream_ms'])}  self "
             f"{ms(r['self_ms'])}  x{r['n']:g} over {r['units']} units"
             + (f"  {r['tokens']:g} tokens {r['bytes']:g} bytes" if "bytes" in r else "")
             for name, r in s["spans"].items()]
    if s["counters"]:
        lines.append("  " + "  ".join(f"{k} {v:g}" for k, v in s["counters"].items()))
    return "\n".join(lines)


def profiler_events(prof) -> Tuple[List[tuple], List[tuple]]:
    """(name, start, end) of each device operation and of each host-side
    ``repro_torch.*`` range in ``prof`` (a ``torch.profiler.profile``), in
    microseconds from the profiler's start."""
    device, host = [], []
    for e in prof.events():
        on_device = "CUDA" in str(getattr(e, "device_type", ""))
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.name.startswith(RANGE_PREFIX):
            if not on_device:
                host.append(span)
        elif on_device:
            device.append(span)
    return device, host


def _union(intervals) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def idle_gaps(device: List[tuple], host: List[tuple], window: Tuple[float, float]
              ) -> Dict[str, float]:
    """Seconds of ``window`` in which no device operation ran, by the
    innermost ``repro_torch.*`` range open at each gap's midpoint ("other"
    where none is). ``device``, ``host``: (name, start, end) in
    microseconds, as :func:`profiler_events` gives them."""
    w0, w1 = window
    busy = _union((max(a, w0), min(b, w1)) for _, a, b in device if b > w0 and a < w1)
    ranges = sorted((a, b, n[len(RANGE_PREFIX):]) for n, a, b in host)
    starts = [r[0] for r in ranges]
    gaps: Dict[str, float] = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        what = "other"
        # The innermost range is the latest-starting one still open.
        for lo, hi, n in reversed(ranges[:bisect.bisect_right(starts, mid)]):
            if hi >= mid:
                what = n
                break
        gaps[what] = gaps.get(what, 0.0) + (b - a) * 1e-6
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def export_beside(profiler_trace: str, out: str, tracer: ProgramTracer = TRACER) -> dict:
    """Writes to ``out`` the chrome trace at ``profiler_trace`` (from
    ``prof.export_chrome_trace``) with the window's spans added as their
    own processes, on the profiler's time base, for one view in Perfetto."""
    with open(profiler_trace) as fh:
        doc = json.load(fh)
    base_us = doc.get("baseTimeNanoseconds", 0) * 1e-3
    pids = {e.get("pid") for e in doc["traceEvents"]}
    shift = 1 + max((p for p in pids if isinstance(p, int)), default=0)
    for e in chrome_trace(tracer)["traceEvents"]:
        e["pid"] += shift
        if e["ph"] == "X":
            e["ts"] = round(e["ts"] - base_us, 3)
        doc["traceEvents"].append(e)
    with open(out, "w") as fh:
        json.dump(doc, fh)
    return doc
