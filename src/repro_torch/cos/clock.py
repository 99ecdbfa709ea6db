"""Serially reusable resources on a virtual clock: ``Timeline`` and ``Link``.

Counterpart of the two classes of ``repro/cos/clock.py`` that the object
store uses. They book work on a virtual clock and account busy time; the
JAX package's ``Simulator`` (the fleet's shared event trace, with its
``obs/`` tracer and metrics) and the accelerators wait for the simulator
slice (ROADMAP Queue 1 item 4), so these record no trace.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class Timeline:
    """A serially-reusable resource (link, accelerator, disk)."""
    name: str
    busy_until: float = 0.0
    busy_time: float = 0.0

    def reserve(self, start: float, duration: float) -> Tuple[float, float]:
        """Schedule work at >= start; returns (actual_start, end)."""
        s = max(start, self.busy_until)
        e = s + duration
        self.busy_until = e
        self.busy_time += duration
        return s, e

    def note(self, start: float, end: float) -> None:
        """Account an interval scheduled by an external scheduler."""
        self.busy_until = max(self.busy_until, end)
        self.busy_time += end - start


@dataclass
class Link(Timeline):
    bandwidth: float = 125e6   # bytes/s (1 Gbps default, paper §7.1)
    latency: float = 1e-3

    def transfer(self, start: float, nbytes: float) -> Tuple[float, float]:
        return self.reserve(start, self.latency + nbytes / self.bandwidth)
