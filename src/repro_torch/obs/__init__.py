"""Cross-tier observability: structured spans, metrics, timeline export.

A copy of ``repro/obs`` (pure Python): the port imports nothing of ``repro``.

Three pieces, all deterministic under the simulator's virtual clock and
all strictly additive next to the golden-hashed :class:`EventLog`:

* :mod:`repro_torch.obs.span` — ``Span``/``Tracer`` causal request trees
  (storage read -> admission -> pushdown compute -> wire -> client).
* :mod:`repro_torch.obs.metrics` — ``MetricsRegistry`` counters / gauges /
  histograms with label sets and a deterministic text dump.
* :mod:`repro_torch.obs.export` — Chrome-trace / Perfetto JSON rendering
  (one process per tier, one thread per resource track).

Vocabulary is pinned by :mod:`repro_torch.obs.schema`; shared percentile math
lives in :mod:`repro_torch.obs.hist`.

:mod:`repro_torch.obs.program` holds the running program's own tracer and
registry: the same classes on the host's real clock, off by default, with
each span's stream time on the card (imported on its own: it needs torch).
"""
from repro_torch.obs.export import chrome_trace, validate_chrome_trace, write_trace
from repro_torch.obs.hist import DEFAULT_TIME_BUCKETS, bucket_counts, percentile
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.schema import METRIC_KEYS, SPAN_NAMES, TIERS
from repro_torch.obs.span import Span, Tracer

__all__ = [
    "Span", "Tracer", "Histogram", "MetricsRegistry",
    "chrome_trace", "validate_chrome_trace", "write_trace",
    "percentile", "bucket_counts", "DEFAULT_TIME_BUCKETS",
    "SPAN_NAMES", "METRIC_KEYS", "TIERS",
]
