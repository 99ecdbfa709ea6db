"""The plain reference of a HAPI fine-tune: a decoder LM split at a block
boundary, its frozen prefix's forward, the int8 boundary, the trainable
suffix's loss and gradients, and AdamW, in float32 with TF32 off.

A block is its configuration's family's (``families/<family>.py``). Token
embeddings are scaled by sqrt(d_model) (see the configurations'
departures). A tied embedding is untied at the split: the trainable head
starts as a copy of it. Frozen weights stay in the dtype they were made in
and are read as f32 by each product; trainable ones are f32 tensors holding
values of their configured dtype, rounded to it after each update. Blocks
run one at a time under ``checkpoint`` when gradients are taken, so only
their inputs are kept.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from hapibench import families
from hapibench import traffic as T
from hapibench import weights as W
from hapibench.reference import common
from hapibench.reference.common import AdamW, Precision


class Reference:
    def __init__(self, config: dict, seed: int, device, prec: Precision, blocks=None):
        """``config`` is a configuration file; its weights are made from
        ``seed``, all of them, or the embedding and ``blocks`` alone."""
        self.config = config
        self.m = config["model"]
        self.split = config["split"]
        self.block_fn = families.of(config).block
        self.prec = prec
        self.w = W.make(config, seed, device, blocks)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.w["embed"][tokens.long()].float() * math.sqrt(self.m["d_model"])

    def run_blocks(self, h: torch.Tensor, lo: int, hi: int, w: Dict[str, torch.Tensor]):
        for i in range(lo, hi):
            args = (w, f"blocks.{i}.sub0.", h, self.m, self.prec)
            if torch.is_grad_enabled():
                h = checkpoint(self.block_fn, *args, use_reentrant=False)
            else:
                h = self.block_fn(*args)
        return h

    @torch.no_grad()
    def prefix(self, tokens: torch.Tensor) -> torch.Tensor:
        """The boundary activations (B, S, D) of blocks [0, split), f32."""
        return self.run_blocks(self.embed(tokens), 0, self.split, self.w)

    def trainable(self) -> Dict[str, torch.Tensor]:
        names = common.blocks_of(self.w, self.split, self.m["n_layers"]) + ["final_norm.scale"]
        out = {k: self.w[k].float().clone() for k in names}
        out["unembed"] = self.w["unembed" if "unembed" in self.w else "embed"].float().clone()
        return out

    def suffix_loss(self, acts: torch.Tensor, tokens: torch.Tensor,
                    params: Dict[str, torch.Tensor]) -> torch.Tensor:
        h = self.run_blocks(acts, self.split, self.m["n_layers"], params)
        return common.lm_loss(h, params["final_norm.scale"], params["unembed"], tokens,
                              self.m["vocab_size"], self.m["norm_eps"], self.prec)


def boundary(ref: Reference, tokens: torch.Tensor) -> torch.Tensor:
    """The prefix's output through the int8 wire, back in f32."""
    return common.dequantize_int8(*common.quantize_int8(ref.prefix(tokens)))


def train(ref: Reference, batches: List[torch.Tensor], cos_batch: int, tc: dict) -> dict:
    """The fine-tune's first ``len(batches)`` steps, each over its batch of
    token rows in chunks of ``cos_batch`` rows (the extraction's
    microbatch, which is also the gradient-accumulation chunk): each step's
    mean loss, the first step's gradient norm of each leaf before clipping,
    and each leaf's change after the last step."""
    params = ref.trainable()
    start = {k: p.clone() for k, p in params.items()}
    dtypes = W.stored_dtypes(ref.config)
    stored = {k: dtypes.get(k, dtypes["embed"]) for k in params}
    opt = AdamW(params, stored, tc)
    losses, first_grads = [], None
    for tokens in batches:
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        loss_sum, chunks = 0.0, 0
        for lo in range(0, tokens.shape[0], cos_batch):
            rows = tokens[lo:lo + cos_batch]
            acts = boundary(ref, rows)
            live = {k: p.detach().requires_grad_() for k, p in params.items()}
            loss = ref.suffix_loss(acts, rows, live)
            for k, g in zip(live, torch.autograd.grad(loss, list(live.values()))):
                grads[k].add_(g)
            loss_sum += float(loss.detach())
            chunks += 1
        for g in grads.values():
            g.div_(chunks)
        if first_grads is None:
            first_grads = common.leaf_norms(grads)
        opt.update(params, grads)
        losses.append(loss_sum / chunks)
    change = common.leaf_norms({k: params[k] - start[k] for k in params})
    return {"losses": losses, "grad_norms": first_grads, "change_norms": change}


def follow_train(config: dict, traffic: dict, seed: int, device, prec: Precision):
    """The reference of a fine-tune cell from ``seed``: ``train`` over the
    mix's checked steps, and the boundary of the first step's first
    microbatch (f32, before the int8 wire)."""
    common.no_tf32()
    ref = Reference(config, seed, device, prec)
    vocab, cos = config["model"]["vocab_size"], traffic["hapi"]["cos_batch"]
    batches = [torch.from_numpy(T.batch_rows(traffic, i, vocab, seed)).to(device)
               for i in range(traffic["checked_steps"])]
    first = ref.prefix(batches[0][:cos])
    return train(ref, batches, cos, traffic["train"]), first


def follow_posts(config: dict, traffic: dict, seed: int, device, prec: Precision, indices):
    """The reference's boundary (f32, before the int8 wire) of each POST in
    ``indices``."""
    common.no_tf32()
    ref = Reference(config, seed, device, prec, blocks=range(config["split"]))
    vocab = config["model"]["vocab_size"]
    return [ref.prefix(torch.from_numpy(T.batch_rows(traffic, i, vocab, seed)).to(device))
            for i in indices]
