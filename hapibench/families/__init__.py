"""The model families of the benchmark's configurations, one module a family
(``families/<family>.py``), found by a configuration file's ``family`` key.

A family module holds all that the harness knows of one kind of block, and
imports nothing of the program:

  * ``SOURCES``: the program's kernel libraries the family's cells build;
  * ``KERNELS``: the program's launch counters of its sequence mixer,
    ``{"forward": ..., "backward": ...}``;
  * ``ROOFLINE``: the name its mixer kernels' roofline goes by, and
    ``TRACE_NAMES``: substrings of those kernels' names in a device trace;
  * ``block_leaves(m, i)``: the seeded leaves of block ``i``, and
    ``f32_vector(kind, n, device)`` for leaves made as ``("f32", kind)``;
  * ``block(w, pre, h, m, prec)``: the plain reference of one block;
  * ``block_matmul_params(m)``, ``mixer_flops(m, rows, seq, backward)``: its
    model FLOPs;
  * ``kernel_work(m, rows, seq, kernel)``: one mixer launch's bytes and
    operations at a microbatch of ``rows`` sequences.

``m`` is a configuration's ``model`` group.
"""
from __future__ import annotations

import importlib
from types import ModuleType


def of(config: dict) -> ModuleType:
    """The family module of the configuration file ``config``."""
    return importlib.import_module(f"hapibench.families.{config['family']}")
