"""What every traffic kind's run shares: the log, freeing the card, its
memory peak, the nearest-rank percentile, and the profiled steps or POSTs of
a traced run."""
from __future__ import annotations

import gc
import math

import torch

from hapibench import families, launches

GIB = float(1 << 30)


def log(msg: str) -> None:
    print(f"hapibench: {msg}", flush=True)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def nearest_rank(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q * len(ordered)) - 1)]


def peak_reset(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)


def peak(device) -> int:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def _profile(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def traced(c, unit, n_units: int, device):
    """``unit(i)`` for ``i`` in ``range(n_units)`` under the profiler, with no
    synchronise but the last: the trace, and the kernels' summed bounds over
    the launches counted in it (None where those differ from the launches
    worked out from the cell)."""
    from hapibench import program as P
    from hapibench import trace as TR
    before = P.ops.launch_counts()
    with _profile(device) as prof:
        with torch.profiler.record_function(TR.WINDOW):
            for i in range(n_units):
                unit(i)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
    counted = {k: v - before[k] for k, v in P.ops.launch_counts().items() if v - before[k]}
    want = {k: v for k, v in launches.expected(c.config, c.traffic, n_units).items() if v}
    log(f"traced {n_units} units: launches {counted}, worked out from the cell {want}")
    fam = families.of(c.config)
    tr = TR.from_profiler(prof, {fam.ROOFLINE: fam.TRACE_NAMES, **TR.INT8})
    log(f"trace: window {tr.window_s} s, busy {tr.busy_s} s, {tr.n_device_events} device "
        f"operations; the port's kernels by roofline {tr.family_s}, named {tr.family_names}")
    return tr, (launches.bounds(c.config, c.traffic, counted) if counted == want else None)
