"""What a ``torch.profiler`` trace of the traced window says: the device's
busy seconds (the union of its operations' intervals), the device seconds
of the port's kernels of each roofline (named as the cell's family and the
int8 boundary give them), the device operations that took most
time, and the idle gaps named by what the host was doing then (the
innermost of the benchmark's own ``hapibench.*`` ranges around the gap's
middle).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Tuple

# The int8 boundary's kernels by the names the profiler gives them; a
# family's mixer kernels are its ``TRACE_NAMES``.
INT8 = {"int8": ("quantize",)}
WINDOW = "hapibench.window"
TOP = 10


def family(name: str, names: Dict[str, Tuple[str, ...]]) -> Optional[str]:
    """The roofline in ``names`` (roofline -> name substrings) whose kernel
    ``name`` is, if any."""
    for fam, keys in names.items():
        if any(k in name for k in keys):
            return fam
    return None


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    family_s: Dict[str, float]
    family_names: Dict[str, List[str]]
    device_ops: List[list]
    idle_gaps: List[list]
    n_device_events: int


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summarize(device: List[Tuple[str, float, float]],
              host: List[Tuple[str, float, float]],
              names: Dict[str, Tuple[str, ...]]) -> Trace:
    """``device``: (name, start, end) of each device operation; ``host``:
    (name, start, end) of the benchmark's ranges, one of them the window;
    ``names``: each roofline's kernel name substrings. Times in
    microseconds on one clock."""
    win = next(((a, b) for n, a, b in host if n == WINDOW), None)
    if win is None:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = win
    inside = [(n, max(a, w0), min(b, w1)) for n, a, b in device if b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in inside])
    by_name: Dict[str, float] = {}
    fam_s: Dict[str, float] = {}
    fam_names: Dict[str, List[str]] = {}
    for n, a, b in inside:
        by_name[n] = by_name.get(n, 0.0) + (b - a) * 1e-6
        f = family(n, names)
        if f:
            fam_s[f] = fam_s.get(f, 0.0) + (b - a) * 1e-6
            if n not in fam_names.setdefault(f, []):
                fam_names[f].append(n)
    ranges = sorted((a, b, n[len("hapibench."):]) for n, a, b in host
                    if n != WINDOW and n.startswith("hapibench."))
    starts = [r[0] for r in ranges]
    gaps: Dict[str, float] = {}
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        what = "other"
        for lo, hi, n in reversed(ranges[:bisect.bisect_right(starts, mid)]):
            if hi >= mid:
                what = n
                break
        gaps[what] = gaps.get(what, 0.0) + (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=sum(b - a for a, b in busy) * 1e-6,
                 family_s=fam_s, family_names=fam_names,
                 device_ops=[[n[:160], s] for n, s in top],
                 idle_gaps=[[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
                 n_device_events=len(inside))


def from_profiler(prof, names: Dict[str, Tuple[str, ...]]) -> Trace:
    """The trace's device operations and host ranges out of ``prof``'s
    events (a ``record_function`` range also shows on the device's timeline
    under its name; only its host side counts)."""
    device, host = [], []
    for e in prof.events():
        on_device = "CUDA" in str(getattr(e, "device_type", ""))
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.name.startswith("hapibench."):
            if not on_device:
                host.append(span)
        elif on_device:
            device.append(span)
    return summarize(device, host, names)
