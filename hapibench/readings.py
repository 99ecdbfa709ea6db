"""What a run hands the per-layer metrics' readers (``metrics/*.py``), and
the arithmetic they share. A reader returns None where its run has nothing
for it to read, and the metric is then left out of the line."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from hapibench import work
from hapibench.trace import Trace


@dataclasses.dataclass
class Readings:
    kind: str                         # "train" or "pushdown"
    window_s: float                   # host seconds of the measured window
    count: int                        # steps or POSTs completed in it
    flops: float                      # the model FLOPs of that work
    spans: Dict[str, List[float]]     # host seconds of each benchmark span, per call
    trace: Optional[Trace] = None     # the traced window's device trace
    bounds: Optional[Dict[str, float]] = None   # kernel family -> summed bound seconds


def per_unit_ms(r: Readings, kind: str, span: str) -> Optional[float]:
    """Host ms of ``span`` a step or POST of the window (a span may run
    more than once in one: the extraction once a microbatch)."""
    values = r.spans.get(span)
    if r.kind != kind or not values or r.count <= 0:
        return None
    return 1e3 * sum(values) / r.count


def mfu(r: Readings, kind: str) -> Optional[float]:
    """The model FLOPs of the window over its seconds, in percent of the
    card's dense bf16 peak."""
    if r.kind != kind or r.window_s <= 0:
        return None
    return 100.0 * r.flops / (r.window_s * work.PEAK_BF16)


def roofline(r: Readings, kind: str, fam: str) -> Optional[float]:
    """The family's launches' summed bounds over its kernels' device time in
    the traced window, in percent."""
    if r.kind != kind or r.trace is None or not r.bounds or fam not in r.bounds:
        return None
    spent = r.trace.family_s.get(fam, 0.0)
    return 100.0 * r.bounds[fam] / spent if spent > 0 else None


def idle(r: Readings, kind: str) -> Optional[float]:
    if r.kind != kind or r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
