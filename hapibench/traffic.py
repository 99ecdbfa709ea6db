"""The one generator of the benchmark's traffic: token rows made from the
seed, laid out as the mix's file says.

Every seed gives the same sizes and the same number of rows, so two seeds do
the same work on other tokens. Tokens are uniform over the configuration's
vocabulary, and each sequence is its own labels (next-token prediction).

A mix's file gives ``distinct_batches`` batches of ``rows`` x ``seq``
tokens, each stored as ``objects_per_batch`` objects (one by default), read
in order and again from the start when the last is used: a fine-tune step
or a POST takes one batch.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

SEED_MASK = (1 << 63) - 1


def seed_of(seed: int) -> int:
    """The seed as a non-negative number numpy and torch both take."""
    return seed & SEED_MASK


def tokens(traffic: dict, vocab: int, seed: int) -> np.ndarray:
    """All of a run's token rows, int32 (n_rows, seq)."""
    n = traffic["rows"] * traffic["distinct_batches"]
    rng = np.random.default_rng(seed_of(seed))
    return rng.integers(0, vocab, (n, traffic["seq"])).astype(np.int32)


def object_rows(traffic: dict) -> int:
    """Rows in one stored object."""
    return traffic["rows"] // traffic.get("objects_per_batch", 1)


def columns(traffic: dict, vocab: int, seed: int) -> Dict[str, np.ndarray]:
    toks = tokens(traffic, vocab, seed)
    return {"tokens": toks, "labels": toks}


def batch_rows(traffic: dict, index: int, vocab: int, seed: int) -> np.ndarray:
    """The token rows of step or POST ``index`` (counting from 0, the mix
    read again from the start after its last batch)."""
    toks = tokens(traffic, vocab, seed)
    per = traffic["rows"]
    start = (index * per) % len(toks)
    return toks[start:start + per]
