"""Label-set metrics registry: counters, gauges, fixed-bucket histograms.

The registry lives on the :class:`~repro_torch.cos.clock.Simulator` next to
the tracer and event log; every instrumented component increments the
same shared instance, so :meth:`HapiCluster.metrics` is a whole-cluster
snapshot. Histograms keep raw observations (a fleet run is at most a
few hundred thousand points) so their percentiles use the *exact* same
nearest-rank math as the replay verdict (:mod:`repro_torch.obs.hist`) —
the two can never drift on the same data.

Emission-site convention (enforced by the schema-stability tests, which
grep for it): call through a local variable named ``mx`` —
``mx.inc("requests_total", tenant=0)`` — with the key as a literal.

Label values are stringified and the per-key label-set cardinality is
bounded (default 4096 sets): a labels explosion (e.g. labelling by
request id) raises instead of silently eating memory. At fleet scale a
*structurally* bounded cross product (tenant x server) can legitimately
exceed the bound, so ``overflow="rollup"`` folds excess label sets into
one reserved ``{overflow="true"}`` series instead — per-key totals stay
exact, only the long tail loses per-label attribution (the simulator's
shared registry runs in this mode; see :class:`~repro_torch.cos.clock.Simulator`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.obs.hist import DEFAULT_TIME_BUCKETS, bucket_counts, percentile
from repro_torch.obs.schema import METRIC_KEYS, validate_metric_key

LabelSet = Tuple[Tuple[str, str], ...]

#: Reserved label set absorbing past-the-bound series under
#: ``overflow="rollup"``.
OVERFLOW_LABELSET: LabelSet = (("overflow", "true"),)


def _labelset(labels: Dict[str, object]) -> LabelSet:
    # Hot path: most emission sites use 0-1 labels, where sorting is a
    # no-op and the generator machinery dominates — unpack directly.
    if not labels:
        return ()
    if len(labels) == 1:
        [(k, v)] = labels.items()
        return ((k, str(v)),)
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt(key: str, ls: LabelSet) -> str:
    if not ls:
        return key
    inner = ",".join(f"{k}={v}" for k, v in ls)
    return f"{key}{{{inner}}}"


class Histogram:
    """Fixed-bucket histogram that also retains raw values for exact
    percentiles (sorted lazily on query)."""

    __slots__ = ("buckets", "values", "total", "count", "_sorted")

    def __init__(self, buckets: Sequence[float] = DEFAULT_TIME_BUCKETS) -> None:
        self.buckets = tuple(buckets)
        self.values: List[float] = []
        self.total = 0.0
        self.count = 0
        self._sorted = True

    def add(self, value: float) -> None:
        self.values.append(value)
        self.total += value
        self.count += 1
        self._sorted = False

    def _ensure_sorted(self) -> None:
        if not self._sorted:
            self.values.sort()
            self._sorted = True

    def percentile(self, q: float) -> float:
        self._ensure_sorted()
        return percentile(self.values, q)

    def bucket_counts(self) -> List[int]:
        return bucket_counts(self.values, self.buckets)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


class MetricsRegistry:
    """Counters / gauges / histograms keyed by ``(key, labelset)``.

    All three families share the key namespace pinned by
    :data:`repro_torch.obs.schema.METRIC_KEYS` (``keys``: the running program's
    registry takes ``PROGRAM_METRIC_KEYS``); a key may only ever be used as
    one family (mixing raises, catching copy-paste instrumentation)."""

    def __init__(self, max_label_sets: int = 4096,
                 overflow: str = "raise", keys: frozenset = METRIC_KEYS) -> None:
        if overflow not in ("raise", "rollup"):
            raise ValueError(f"overflow must be 'raise' or 'rollup', "
                             f"got {overflow!r}")
        self.max_label_sets = max_label_sets
        self.overflow = overflow
        self.keys = keys
        self.clear()

    def clear(self) -> None:
        """Drops every series."""
        self.rolled_up = 0
        self._counters: Dict[str, Dict[LabelSet, float]] = {}
        self._gauges: Dict[str, Dict[LabelSet, float]] = {}
        self._hists: Dict[str, Dict[LabelSet, Histogram]] = {}

    # -- family bookkeeping ----------------------------------------------------
    def _family(self, key: str, fam: Dict[str, Dict]) -> Dict:
        series = fam.get(key)
        if series is not None:
            # Key already admitted to this family: schema and cross-family
            # checks ran at creation and key sets only grow, so skip both.
            return series
        validate_metric_key(key, self.keys)
        for other in (self._counters, self._gauges, self._hists):
            if other is not fam and key in other:
                raise ValueError(
                    f"metric key {key!r} already used as a different "
                    f"instrument family")
        series = fam[key] = {}
        return series

    def _bound(self, key: str, series: Dict, ls: LabelSet) -> LabelSet:
        if ls not in series and len(series) >= self.max_label_sets:
            if self.overflow == "rollup":
                self.rolled_up += 1
                return OVERFLOW_LABELSET
            raise ValueError(
                f"metric {key!r} exceeded the label-cardinality bound "
                f"({self.max_label_sets} label sets); a label is "
                f"unbounded (request id? timestamp?)")
        return ls

    # -- emission --------------------------------------------------------------
    def inc(self, key: str, value: float = 1.0, **labels) -> None:
        series = self._family(key, self._counters)
        ls = self._bound(key, series, _labelset(labels))
        series[ls] = series.get(ls, 0.0) + value

    def gauge_set(self, key: str, value: float, **labels) -> None:
        series = self._family(key, self._gauges)
        ls = self._bound(key, series, _labelset(labels))
        series[ls] = value

    def observe(self, key: str, value: float, **labels) -> None:
        series = self._family(key, self._hists)
        ls = self._bound(key, series, _labelset(labels))
        h = series.get(ls)
        if h is None:
            h = series[ls] = Histogram()
        h.add(value)

    # -- queries ---------------------------------------------------------------
    def counter_value(self, key: str, **labels) -> float:
        return self._counters.get(key, {}).get(_labelset(labels), 0.0)

    def counters(self, key: str) -> Dict[LabelSet, float]:
        return dict(self._counters.get(key, {}))

    def gauge_value(self, key: str, **labels) -> float:
        return self._gauges.get(key, {}).get(_labelset(labels), 0.0)

    def total(self, key: str) -> float:
        """Sum of a counter across every label set (0.0 if never hit)."""
        return float(sum(self._counters.get(key, {}).values()))

    def histogram(self, key: str, **labels) -> Histogram:
        series = self._hists.get(key, {})
        ls = _labelset(labels)
        h = series.get(ls)
        if h is None:
            if labels or not series:
                return Histogram()
            # no labels requested: merge every series of the key
            h = Histogram()
            for sub in series.values():
                for v in sub.values:
                    h.add(v)
        return h

    def percentile(self, key: str, q: float, **labels) -> float:
        return self.histogram(key, **labels).percentile(q)

    def label_set_count(self, key: str) -> int:
        for fam in (self._counters, self._gauges, self._hists):
            if key in fam:
                return len(fam[key])
        return 0

    # -- snapshots -------------------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """Deterministic nested dict (sorted keys and label sets)."""
        out: Dict[str, Dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for key in sorted(self._counters):
            for ls in sorted(self._counters[key]):
                out["counters"][_fmt(key, ls)] = self._counters[key][ls]
        for key in sorted(self._gauges):
            for ls in sorted(self._gauges[key]):
                out["gauges"][_fmt(key, ls)] = self._gauges[key][ls]
        for key in sorted(self._hists):
            for ls in sorted(self._hists[key]):
                h = self._hists[key][ls]
                out["histograms"][_fmt(key, ls)] = {
                    "count": h.count,
                    "sum": h.total,
                    "p50": h.percentile(0.50),
                    "p99": h.percentile(0.99),
                    "buckets": dict(zip(
                        [str(b) for b in h.buckets], h.bucket_counts())),
                }
        return out

    def dump(self) -> str:
        """Deterministic text dump, one ``key{labels} value`` per line."""
        lines: List[str] = []
        for key in sorted(self._counters):
            for ls in sorted(self._counters[key]):
                lines.append(f"{_fmt(key, ls)} {self._counters[key][ls]:g}")
        for key in sorted(self._gauges):
            for ls in sorted(self._gauges[key]):
                lines.append(f"{_fmt(key, ls)} {self._gauges[key][ls]:g}")
        for key in sorted(self._hists):
            for ls in sorted(self._hists[key]):
                h = self._hists[key][ls]
                lines.append(
                    f"{_fmt(key, ls)} count={h.count} sum={h.total:g} "
                    f"p50={h.percentile(0.50):g} p99={h.percentile(0.99):g}")
        return "\n".join(lines)
