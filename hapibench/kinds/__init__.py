"""The traffic kinds of the benchmark's mixes, one module a kind
(``kinds/<kind>.py``), found by a mix file's ``kind`` key.

A kind module holds all of one closed loop that the harness drives:

  * ``run(c, seed, seconds, trace, device, fault, t_start)``: set-up, the
    measured window and the reference after it; returns the readings for
    the per-layer metrics, the end-to-end metrics, the numbers that decide
    ``correct``, the memory peak and the count of steps or POSTs;
  * ``control(c, seed, device)``: the control's numbers, the plain
    reference in float8 in the program's place;
  * ``FAULTS``: the faults (``faults.py``) the kind's timed path can have;
  * ``launches(kernels, config, traffic)``: the port's launches a unit
    makes, given the family's mixer ``KERNELS``;
  * ``unit_flops(config, traffic)``: the model FLOPs of a unit, by part.
"""
from __future__ import annotations

import importlib
from types import ModuleType


def of(traffic: dict) -> ModuleType:
    """The kind module of the mix ``traffic``."""
    return importlib.import_module(f"hapibench.kinds.{traffic['kind']}")
