"""The JAX package's parameter trees as state_dicts of the port, and back.

A JAX parameter tree is a nested dict of arrays. Its path, joined with
".", is the state_dict key, except under ``blocks``, whose leaves are
stacked over a leading block axis (``repro/models/module.py``
``stack_init``); that axis is unstacked into the ``nn.ModuleList`` index:

    JAX path (leaf [i] of the block axis)      state_dict key
    embed                                      embed
    blocks/sub{j}/ln_mixer/scale [i]           blocks.{i}.sub{j}.ln_mixer.scale
    blocks/sub{j}/attn/{wq,wk,wv,wo} [i]       blocks.{i}.sub{j}.attn.{wq,wk,wv,wo}
    blocks/sub{j}/attn/{bq,bk,bv} [i]          blocks.{i}.sub{j}.attn.{bq,bk,bv}
    blocks/sub{j}/attn/q_norm/scale [i]        blocks.{i}.sub{j}.attn.q_norm.scale
    blocks/sub{j}/attn/k_norm/scale [i]        blocks.{i}.sub{j}.attn.k_norm.scale
    blocks/sub{j}/ln_ffn/scale [i]             blocks.{i}.sub{j}.ln_ffn.scale
    blocks/sub{j}/mlp/{w_gate,w_up,w_down} [i] blocks.{i}.sub{j}.mlp.{w_gate,w_up,w_down}
    final_norm/scale                           final_norm.scale
    unembed                                    unembed

Shapes are unchanged, and so are the words a name-based weight-decay mask
reads ("norm", "scale", "bias", "ln"; ``repro/optim/adamw.py``
``_decay_mask``). bfloat16 arrays go through float32, which is exact, so
the port needs no bfloat16 support in numpy; ``params_to_jax`` returns
bfloat16 tensors as float32 arrays for the same reason.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

BLOCKS = "blocks"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().copy()


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A state_dict (CPU tensors) from a JAX parameter tree of numpy arrays."""
    sd: Dict[str, torch.Tensor] = {}
    for key, node in tree.items():
        if key == BLOCKS:
            flat = _flatten(node)
            n = len(next(iter(flat.values())))
            for i in range(n):
                for path, a in flat.items():
                    sd[f"{BLOCKS}.{i}.{path}"] = _to_torch(np.asarray(a)[i])
        elif isinstance(node, Mapping):
            sd.update({k: _to_torch(a) for k, a in _flatten(node, key).items()})
        else:
            sd[key] = _to_torch(node)
    return sd


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: a nested dict of numpy arrays with
    the blocks restacked on a leading axis."""
    tree: Dict[str, Any] = {}
    per_block: Dict[int, Dict[str, np.ndarray]] = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        if parts[0] == BLOCKS:
            per_block.setdefault(int(parts[1]), {})[".".join(parts[2:])] = _to_numpy(t)
            continue
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_numpy(t)
    if per_block:
        blocks: Dict[str, Any] = {}
        for path in per_block[0]:
            stacked = np.stack([per_block[i][path] for i in range(len(per_block))])
            node = blocks
            parts = path.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = stacked
        tree[BLOCKS] = blocks
    return tree
