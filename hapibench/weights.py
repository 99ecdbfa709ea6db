"""Seeded weights of a configuration, made by the benchmark on the device.

The same seed gives the same tensors. Both sides take them: the program's
model is built on the meta device and these are assigned to it, and the
plain reference makes them again from the seed after the window. Every
normal draw of one dtype comes from one call into a flat buffer, scaled
group by group (each group one standard deviation), and the leaves are
views of it, named as the program's ``state_dict`` names them. A block's
leaves are its family's (``families/<family>.py``).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from hapibench import families

# (name, shape, init): init is ("normal", std), ("ones",), ("zeros",) or
# ("f32", kind), a vector the family makes in f32 and stores in f32.
Leaf = Tuple[str, tuple, tuple]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def padded_vocab(m: dict) -> int:
    pad = m.get("vocab_pad_to", 512)
    return -(-m["vocab_size"] // pad) * pad


def leaves(config: dict, blocks: range = None) -> List[Leaf]:
    """Every leaf of the configuration file ``config``'s model, or of the
    embedding and ``blocks`` alone when given (the storage tier's prefix)."""
    m, fam = config["model"], families.of(config)
    vp, d = padded_vocab(m), m["d_model"]
    out: List[Leaf] = [("embed", (vp, d), ("normal", 0.02))]
    for i in (range(m["n_layers"]) if blocks is None else blocks):
        out += fam.block_leaves(m, i)
    if blocks is None:
        out.append(("final_norm.scale", (d,), ("ones",)))
        if not m.get("tie_embeddings", False):
            out.append(("unembed", (vp, d), ("normal", 0.02)))
    return out


def make(config: dict, seed: int, device, blocks: range = None) -> Dict[str, torch.Tensor]:
    """The leaves of ``leaves(config, blocks)`` from ``seed`` on ``device``,
    in the configuration's parameter dtype (the family's f32 vectors in f32)."""
    m = config["model"]
    dt = DTYPES[m.get("param_dtype", "bfloat16")]
    spec = leaves(config, blocks)
    normal = [(name, shape, init[1]) for name, shape, init in spec if init[0] == "normal"]
    total = sum(math.prod(shape) for _, shape, _ in normal)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, dtype=dt, device=device)
    out: Dict[str, torch.Tensor] = {}
    # Leaves of one standard deviation sit side by side, so one multiply
    # scales each group.
    lo = 0
    for std in sorted({s for _, _, s in normal}):
        group = [(n, sh) for n, sh, s in normal if s == std]
        size = sum(math.prod(sh) for _, sh in group)
        flat[lo:lo + size].mul_(std)
        for name, shape in group:
            out[name] = flat[lo:lo + math.prod(shape)].view(shape)
            lo += math.prod(shape)
    for name, shape, init in spec:
        if init[0] == "ones":
            out[name] = torch.ones(shape, dtype=dt, device=device)
        elif init[0] == "zeros":
            out[name] = torch.zeros(shape, dtype=dt, device=device)
        elif init[0] == "f32":
            out[name] = families.of(config).f32_vector(init[1], shape[0], device)
    return {name: out[name] for name, _, _ in spec}


def stored_dtypes(config: dict) -> Dict[str, torch.dtype]:
    """The dtype the configuration stores each leaf in."""
    dt = DTYPES[config["model"].get("param_dtype", "bfloat16")]
    return {name: torch.float32 if init[0] == "f32" else dt
            for name, _, init in leaves(config)}
