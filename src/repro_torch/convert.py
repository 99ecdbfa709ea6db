"""The JAX package's parameter trees as state_dicts of the port, and back.

A JAX parameter tree is a nested dict of arrays. Its path, joined with
".", is the state_dict key, except under ``blocks`` (and the encoder-decoder's
``enc_blocks`` and ``dec_blocks``), whose leaves are stacked over a leading
block axis (``repro/models/module.py`` ``stack_init``); that axis is
unstacked into the ``nn.ModuleList`` index:

    JAX path (leaf [i] of the block axis)      state_dict key
    embed                                      embed
    blocks/sub{j}/ln_mixer/scale [i]           blocks.{i}.sub{j}.ln_mixer.scale
    blocks/sub{j}/attn/{wq,wk,wv,wo} [i]       blocks.{i}.sub{j}.attn.{wq,wk,wv,wo}
    blocks/sub{j}/attn/{bq,bk,bv} [i]          blocks.{i}.sub{j}.attn.{bq,bk,bv}
    blocks/sub{j}/attn/q_norm/scale [i]        blocks.{i}.sub{j}.attn.q_norm.scale
    blocks/sub{j}/attn/k_norm/scale [i]        blocks.{i}.sub{j}.attn.k_norm.scale
    blocks/sub{j}/ln_ffn/scale [i]             blocks.{i}.sub{j}.ln_ffn.scale
    blocks/sub{j}/mlp/{w_gate,w_up,w_down} [i] blocks.{i}.sub{j}.mlp.{w_gate,w_up,w_down}
    blocks/sub{j}/moe/router [i]               blocks.{i}.sub{j}.moe.router
    blocks/sub{j}/moe/{w_gate,w_up,w_down} [i] blocks.{i}.sub{j}.moe.{w_gate,w_up,w_down}
    blocks/sub{j}/mamba/{name} [i]             blocks.{i}.sub{j}.mamba.{name}
    final_norm/scale                           final_norm.scale
    unembed                                    unembed

and for the encoder-decoder (``models/encdec.py``)

    enc_blocks/{ln1,ln2}/{scale,bias} [i]      enc_blocks.{i}.{ln1,ln2}.{scale,bias}
    enc_blocks/attn/{wq,wk,wv,wo} [i]          enc_blocks.{i}.attn.{wq,wk,wv,wo}
    enc_blocks/mlp/{w_gate,w_up,w_down} [i]    enc_blocks.{i}.mlp.{w_gate,w_up,w_down}
    enc_norm/{scale,bias}                      enc_norm.{scale,bias}
    dec_embed, dec_pos                         dec_embed, dec_pos
    dec_blocks/{ln1,ln2,ln3}/... [i]           dec_blocks.{i}.{ln1,ln2,ln3}...
    dec_blocks/{self_attn,cross_attn}/... [i]  dec_blocks.{i}.{self_attn,cross_attn}...
    dec_blocks/mlp/... [i]                     dec_blocks.{i}.mlp...
    dec_norm/{scale,bias}                      dec_norm.{scale,bias}

where a mamba ``{name}`` is one of ``w_z``, ``w_x``, ``w_B``, ``w_C``,
``w_dt``, ``conv_x``, ``conv_x_b``, ``conv_B``, ``conv_B_b``, ``conv_C``,
``conv_C_b``, ``A_log``, ``D``, ``dt_bias``, ``norm_scale``, ``w_out``. A
MoE's experts stack as (n_blocks, E, d, f) in the JAX tree (``w_down``
(n_blocks, E, f, d)) and as (E, d, f) in a block of the port; its router,
(n_blocks, d, E) there, is f32 in a bf16 model on both sides, as are
mamba's ``A_log``, ``D`` and ``dt_bias``, and goes across exactly.

Shapes are unchanged, and so are the words a name-based weight-decay mask
reads ("norm", "scale", "bias", "ln"; ``repro/optim/adamw.py``
``_decay_mask``). bfloat16 arrays go through float32, which is exact, so
the port needs no bfloat16 support in numpy; ``params_to_jax`` returns
bfloat16 tensors as float32 arrays for the same reason. ``params_to_tree``
gives the same nested dict with torch tensors as leaves (the checkpoints
write it), and ``params_from_jax`` also takes such a tree.

``train_state_from_jax`` and ``train_state_to_jax`` carry a whole train
state, ``TrainState(frozen, trainable, OptState(m, v, step))`` of the JAX
package, across: the moments are trees of the trainable part's structure.

``vision_params_from_jax`` and ``vision_params_to_jax`` carry the weights of
a paper vision model (``models/vision.py``): the reference's list of
per-layer dicts, one per layer, against the port's ``layers[i]``. The keys
are the same (``w``, ``b``; a ResNet block's ``c1``, ``b1``, ``c2``, ``b2``,
``down``; BatchNorm's ``scale``, ``bias`` and the ``mean``, ``var``
buffers; the ViT's ``ln1s`` ... ``w2``, ``pos``). Conv kernels go from HWIO
to OIHW, and the ViT's ``wq``, ``wk``, ``wv`` (d, heads, hd) and ``wo``
(heads, hd, d) merge their head axes. Both ways are exact.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from repro_torch.models.api import build_model
from repro_torch.models.vision import EncoderBlock
from repro_torch.optim.adamw import STACKED, OptState
from repro_torch.train.steps import TrainState


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
    if isinstance(a, torch.Tensor):
        return a.detach().clone()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy().copy()


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = tree
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return tree


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A state_dict (CPU tensors) from a JAX parameter tree of numpy (or
    torch) arrays."""
    sd: Dict[str, torch.Tensor] = {}
    for key, node in tree.items():
        if key in STACKED:
            flat = _flatten(node)
            n = len(next(iter(flat.values())))
            for i in range(n):
                for path, a in flat.items():
                    leaf = a[i] if isinstance(a, torch.Tensor) else np.asarray(a)[i]
                    sd[f"{key}.{i}.{path}"] = _to_torch(leaf)
        elif isinstance(node, Mapping):
            sd.update({k: _to_torch(a) for k, a in _flatten(node, key).items()})
        else:
            sd[key] = _to_torch(node)
    return sd


def params_to_tree(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The JAX parameter tree of a state_dict, with the blocks restacked on
    a leading axis; the leaves are torch tensors on the state_dict's device."""
    flat: Dict[str, torch.Tensor] = {}
    stacks: Dict[str, Dict[int, Dict[str, torch.Tensor]]] = {}
    for key, t in state_dict.items():
        parts = key.split(".")
        if parts[0] in STACKED:
            per_block = stacks.setdefault(parts[0], {})
            per_block.setdefault(int(parts[1]), {})[".".join(parts[2:])] = t.detach()
        else:
            flat[key] = t.detach()
    tree = _nest(flat)
    for name, per_block in stacks.items():
        tree[name] = _nest({path: torch.stack([per_block[i][path]
                                               for i in range(len(per_block))])
                            for path in per_block[0]})
    return tree


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: a nested dict of numpy arrays with
    the blocks restacked on a leading axis."""
    return _tree_map(_to_numpy, params_to_tree(state_dict))


def train_state_from_jax(state, cfg, *, device="cpu"):
    """The port's ``TrainState`` from a JAX one (or any ``(frozen, trainable,
    (m, v, step))`` of parameter trees). The model is built on ``device`` and
    its weights replaced by the state's; the split is the frozen part's
    number of blocks (encoder blocks for the encoder-decoder)."""
    frozen_tree, trainable_tree, (m, v, step) = state
    stacked = next(k for k in STACKED if k in frozen_tree)
    split = len(next(iter(_flatten(frozen_tree[stacked]).values())))
    lm = build_model(cfg, device=device, generator=torch.Generator(device).manual_seed(0))
    frozen, trainable = lm.split_params(split)
    frozen.load_state_dict(params_from_jax(frozen_tree))
    trainable.load_state_dict(params_from_jax(trainable_tree))
    frozen.requires_grad_(False)
    opt = OptState({k: t.to(device) for k, t in params_from_jax(m).items()},
                   {k: t.to(device) for k, t in params_from_jax(v).items()},
                   torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=device))
    return TrainState(frozen, trainable, opt)


def train_state_to_jax(state) -> Tuple[Dict[str, Any], Dict[str, Any], Tuple]:
    """``(frozen, trainable, (m, v, step))`` as numpy trees of the JAX
    package's structure (bfloat16 as float32), for
    ``TrainState(frozen, trainable, OptState(m, v, step))`` there."""
    frozen, trainable, opt = state
    return (params_to_jax(frozen.state_dict()), params_to_jax(trainable.state_dict()),
            (params_to_jax(opt.m), params_to_jax(opt.v), np.int32(int(opt.step))))


def vision_params_from_jax(vm, params_list) -> None:
    """Load the reference's per-layer parameter dicts (numpy or JAX arrays)
    into the port's ``VisionModel`` ``vm``, in place, on its device."""
    if len(params_list) != len(vm.layers):
        raise ValueError(f"{len(params_list)} parameter dicts for {len(vm.layers)} layers")
    for layer, p in zip(vm.layers, params_list):
        target = layer.state_dict()
        sd = {}
        for key, a in _flatten(p).items():
            a = np.asarray(a, dtype=np.float32)
            if a.ndim == 4:                       # HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 3:                     # the ViT's per-head projections
                a = a.reshape(target[key].shape)
            sd[key] = torch.from_numpy(np.array(a, copy=True))
        layer.load_state_dict(sd)


def vision_params_to_jax(vm) -> list:
    """The reference's list of per-layer parameter dicts (numpy, float32) of
    the port's ``VisionModel`` ``vm``."""
    out = []
    for layer in vm.layers:
        flat = {}
        for key, t in layer.state_dict().items():
            a = _to_numpy(t)
            if a.ndim == 4:                       # OIHW -> HWIO
                a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
            elif isinstance(layer, EncoderBlock) and key in ("wq", "wk", "wv", "wo"):
                h, d = layer.heads, a.shape[0]
                a = a.reshape((d, h, d // h) if key != "wo" else (h, d // h, d))
            flat[key] = a
        out.append(_nest(flat))
    return out
