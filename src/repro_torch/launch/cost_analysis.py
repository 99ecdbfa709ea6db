"""Per-device cost of a program, counted while it runs.

The port's counterpart of ``repro/launch/hlo_analysis.py``. The JAX package
re-derives FLOPs, HBM bytes and collective bytes from the partitioned HLO of
a compiled program; the port has no HLO, so ``count_cost`` counts one
device's program while it runs, on meta tensors in the dry-run (DTensors on
a fake process group, ``launch/dryrun.py``) or on the card:

  * FLOPs — each aten op's count from ``torch.utils.flop_counter``'s
    formulas (those of ``FlopCounterMode``), plus each hand-written kernel's
    registered work (``kernels/work.py``). An op on DTensors is counted at
    its global shape and divided by the mesh dims its output is split over
    (sharded or partial): replicated work is done on every device;
  * HBM bytes — operand plus result bytes of each aten op that is not a
    view, at each device's local shapes, which is what eager PyTorch moves;
    the kernels' bytes by their formulas;
  * collective bytes by kind — each functional collective the program
    issues (a DTensor redistribution, a ``local_map``'s inputs), with the
    ring factors of ``hlo_analysis._collective_bytes``: all-reduce
    2 (g-1)/g of its bytes, all-gather (g-1)/g of the gathered result,
    reduce-scatter (g-1) x its shard, all-to-all (g-1)/g;
  * peak live bytes — the storages the program's ops create (and those it
    starts with, ``baseline_bytes``), each counted while a tensor holds it.

A Python loop is counted on every trip, and the backward as autograd runs
it (remat's second forward included), so the count is trip-count aware by
construction.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


# Ops that return an alias of their input without moving data, though the
# schema does not mark them as views.
_ALIASES = {"_unsafe_view", "detach", "lift_fresh", "alias"}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_by_kind: Dict[str, float] = field(default_factory=dict)
    # (bytes, ranks of the group) of each collective, for the link it crosses
    collectives: List[tuple] = field(default_factory=list)
    kernel_flops: Dict[str, float] = field(default_factory=dict)
    kernel_bytes: Dict[str, float] = field(default_factory=dict)
    peak_bytes: float = 0.0
    n_ops: int = 0
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    flops_by_op: Dict[str, float] = field(default_factory=dict)


def _nbytes(t: torch.Tensor) -> int:
    if isinstance(t, DTensor):
        t = t._local_tensor
    return t.numel() * t.element_size()


def _split_factor(out) -> int:
    """How many ways a DTensor op's work is split: the product of the mesh
    dims its output is not replicated over."""
    if not isinstance(out, DTensor):
        return 1
    n = 1
    for size, p in zip(out.device_mesh.shape, out.placements):
        if not isinstance(p, Replicate):
            n *= size
    return n


class _Live:
    """Bytes of the storages some tracked tensor holds, and their peak."""

    def __init__(self, baseline: float):
        self.refs: Dict[int, int] = {}
        self.live = self.peak = float(baseline)

    def track(self, t: torch.Tensor) -> None:
        if isinstance(t, DTensor):
            t = t._local_tensor
        try:
            storage = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = storage._cdata
        if key not in self.refs:
            self.refs[key] = 0
            self.live += storage.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._free, key, storage.nbytes())
        self.refs[key] += 1

    def _free(self, key: int, nbytes: int) -> None:
        if self.refs.pop(key, None) is not None:
            self.live -= nbytes


class _OpMode(TorchDispatchMode):
    """Sees each op at the level the program issues it: DTensor ops whole,
    plain ops (inside ``local_map`` bodies, or on plain tensors)."""

    def __init__(self, cost: Cost, live: _Live):
        super().__init__()
        self.cost, self.live = cost, live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "_c10d_functional":
            return out      # counted by _CollectiveMode
        c = self.cost
        c.n_ops += 1
        flat_out = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        name = func._overloadpacket.__name__
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            f = fn(*args, **kwargs, out_val=out) / _split_factor(flat_out[0] if flat_out else None)
            c.flops += f
            c.flops_by_op[name] = c.flops_by_op.get(name, 0.0) + f
        if not func.is_view and name not in _ALIASES:
            ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
            b = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in flat_out)
            c.bytes += b
            c.bytes_by_op[name] = c.bytes_by_op.get(name, 0.0) + b
        for t in flat_out:
            self.live.track(t)
        return out


class _CollectiveMode(TorchDispatchMode):
    """Below the DTensor layer: the functional collectives of every
    redistribution, on each rank's local tensors."""

    def __init__(self, cost: Cost, live: _Live):
        super().__init__()
        self.cost, self.live = cost, live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # Let DTensor run with this mode still on the stack, so that the
            # collectives it issues for the op come through here.
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        kind = _COLLECTIVES.get(name) if func.namespace == "_c10d_functional" else None
        if kind is None:
            return out
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        ranks = _group_ranks(args[-1] if isinstance(args[-1], str) else kwargs.get("group_name"))
        g = len(ranks)
        rbytes = sum(_nbytes(t) for t in outs)
        frac = (g - 1) / g if g else 0.0
        cb = {"all-reduce": 2 * rbytes * frac, "all-gather": rbytes * frac,
              "reduce-scatter": rbytes * g * frac, "all-to-all": rbytes * frac}[kind]
        c = self.cost
        c.coll_bytes += cb
        c.coll_by_kind[kind] = c.coll_by_kind.get(kind, 0.0) + cb
        c.collectives.append((cb, tuple(ranks)))
        ins = [t for t in tree_flatten(args)[0] if isinstance(t, torch.Tensor)]
        c.bytes += sum(_nbytes(t) for t in ins) + rbytes
        for t in outs:
            self.live.track(t)
        return out


def _group_ranks(group_name: Optional[str]) -> List[int]:
    from torch.distributed.distributed_c10d import _resolve_process_group
    pg = _resolve_process_group(group_name)
    return dist.get_process_group_ranks(pg)


class count_cost:
    """``with count_cost(baseline_bytes) as cost: run(...)``: ``cost`` is the
    per-device ``Cost`` of what ran inside."""

    def __init__(self, baseline_bytes: float = 0.0):
        self.cost = Cost()
        self.live = _Live(baseline_bytes)
        self.modes = (_CollectiveMode(self.cost, self.live), _OpMode(self.cost, self.live))

    def _kernel(self, name: str, nbytes: float, flops: float) -> None:
        c = self.cost
        c.flops += flops
        c.bytes += nbytes
        c.kernel_flops[name] = c.kernel_flops.get(name, 0.0) + flops
        c.kernel_bytes[name] = c.kernel_bytes.get(name, 0.0) + nbytes

    def __enter__(self) -> Cost:
        for m in self.modes:
            m.__enter__()
        work._COUNTERS.append(self._kernel)
        return self.cost

    def __exit__(self, *exc):
        work._COUNTERS.remove(self._kernel)
        for m in reversed(self.modes):
            m.__exit__(*exc)
        self.cost.peak_bytes = self.live.peak
        return False
