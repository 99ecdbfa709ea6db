"""Sharded, atomic, resumable checkpoints in the JAX package's layout.

Counterpart of ``repro/checkpoint/ckpt.py``, with the same files:

    <dir>/step_<N>/
        manifest.json   — leaf index (shard, shape, dtype), step, extra
                          (the pipeline cursor), completeness marker
        shard_<i>.npz   — the leaves as raw bytes, split round-robin

so that a checkpoint of either package restores into the other. The leaves
are a ``TrainState``'s in JAX's flatten order of ``TrainState(frozen,
trainable, OptState(m, v, step))``: each part a parameter tree with its
dict keys sorted and the blocks stacked on a leading axis
(``convert.params_to_tree``), then the step as an int32 scalar. Writes go to
``step_<N>.tmp`` and are renamed atomically, so a crash mid-write never
corrupts the latest checkpoint; ``keep`` bounds the steps kept on disk.
bfloat16 leaves are stored and read as their raw 16-bit patterns, so no
bfloat16 numpy type (``ml_dtypes``) is needed.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.convert import params_from_jax, params_to_tree
from repro_torch.train.steps import TrainState

# Names of the dtypes a leaf may have, as numpy (and the manifest) spell them.
_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
           torch.int32: "int32"}


def _sorted_leaves(tree: Mapping[str, Any]) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_sorted_leaves(v) if isinstance(v, Mapping) else [v])
    return out


def _trees(state: TrainState) -> List[Dict[str, Any]]:
    return [params_to_tree(state.frozen.state_dict()), params_to_tree(state.trainable.state_dict()),
            params_to_tree(state.opt.m), params_to_tree(state.opt.v)]


def _leaves(state: TrainState) -> List[torch.Tensor]:
    """The state's leaves in JAX's flatten order."""
    return [t for tree in _trees(state) for t in _sorted_leaves(tree)] + [state.opt.step]


def _encode(t: torch.Tensor) -> np.ndarray:
    """The leaf's bytes, as npz stores leaves whose dtype numpy lacks."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return np.frombuffer(t.numpy().tobytes(), np.uint8)


def _decode(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.frombuffer(raw.tobytes(), np.uint16).view(np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw.tobytes(), np.dtype(dtype)).reshape(shape).copy())


def save_checkpoint(directory: str, step: int, state: TrainState, *,
                    extra: Optional[Dict] = None, n_shards: int = 4, keep: int = 3) -> str:
    leaves = _leaves(state)
    tmp = os.path.join(directory, f"step_{step:08d}.tmp")
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)

    shards: List[Dict[str, np.ndarray]] = [{} for _ in range(n_shards)]
    index = []
    for i, leaf in enumerate(leaves):
        s = i % n_shards
        shards[s][f"leaf_{i}"] = _encode(leaf)
        index.append({"leaf": i, "shard": s, "shape": list(leaf.shape),
                      "dtype": _DTYPES[leaf.dtype]})
    for s, payload in enumerate(shards):
        np.savez(os.path.join(tmp, f"shard_{s}.npz"), **payload)

    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "n_shards": n_shards,
        "index": index,
        "treedef": "TrainState(frozen, trainable, OptState(m, v, step)), "
                   "dict keys sorted, blocks stacked (repro_torch)",
        "extra": extra or {},
        "complete": True,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic on POSIX
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
    for d in os.listdir(directory):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    for d in sorted(os.listdir(directory), reverse=True):
        if not d.startswith("step_") or d.endswith(".tmp"):
            continue
        try:
            with open(os.path.join(directory, d, "manifest.json")) as f:
                m = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue  # incomplete/corrupt — skip to older
        if m.get("complete"):
            return m["step"]
    return None


def restore_checkpoint(directory: str, like: TrainState,
                       step: Optional[int] = None) -> Tuple[Optional[TrainState], Any, Any]:
    """Restore into ``like``'s tensors, in place, cast to their dtypes.
    Returns (state, extra, step) or (None, None, None) when nothing is
    restorable."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None, None, None
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    meta = {e["leaf"]: e for e in manifest["index"]}
    loaded: Dict[int, torch.Tensor] = {}
    for s in range(manifest["n_shards"]):
        with np.load(os.path.join(path, f"shard_{s}.npz")) as z:
            for k in z.files:
                i = int(k.split("_")[1])
                loaded[i] = _decode(z[k], meta[i]["dtype"], meta[i]["shape"])

    targets = _leaves(like)
    if len(targets) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(targets)}")
    for i, t in enumerate(targets):
        if tuple(t.shape) != tuple(loaded[i].shape):
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(loaded[i].shape)}, "
                             f"expected {tuple(t.shape)}")
    _write_back(like, [loaded[i] for i in range(len(targets))])
    return like, manifest.get("extra", {}), step


def _fill(tree: Mapping[str, Any], leaves) -> Dict[str, Any]:
    """``tree``'s structure with the next of ``leaves`` at each leaf, in
    sorted key order."""
    return {k: _fill(tree[k], leaves) if isinstance(tree[k], Mapping) else next(leaves)
            for k in sorted(tree)}


def _write_back(like: TrainState, loaded: List[torch.Tensor]) -> None:
    leaves = iter(loaded)
    frozen, trainable, m, v = (_fill(tree, leaves) for tree in _trees(like))
    step = next(leaves)
    with torch.no_grad():
        like.frozen.load_state_dict(params_from_jax(frozen))
        like.trainable.load_state_dict(params_from_jax(trainable))
        for dst, tree in ((like.opt.m, m), (like.opt.v, v)):
            for k, t in params_from_jax(tree).items():
                dst[k].copy_(t)
        like.opt.step.fill_(int(step))
