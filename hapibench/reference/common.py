"""Pieces of the plain reference shared by its model families: the
arithmetic precision, RMSNorm, the int8 boundary, the LM head and loss, and
AdamW.

Everything computes in float32 with TF32 off (``Precision("f32")``). The
control, ``Precision("fp8")``, is the same code with every product's
operands rounded to float8 e4m3 under a per-tensor scale (the gradients
flowing back through a product to e5m2), the step below bf16 that a faster
program might take. Nothing here imports the program.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _to_fp8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(torch.float32) / scale


class _FP8Round(torch.autograd.Function):
    """Rounds to e4m3 going forward and the incoming gradient to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _to_fp8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2, E5M2_MAX)


class Precision:
    """How the reference rounds the operands of its products: "f32" leaves
    them, "fp8" is the control."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"no precision {kind!r}")
        self.kind = kind

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        return _FP8Round.apply(x) if self.kind == "fp8" else x

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.operand(a), self.operand(b))

    def einsum(self, eq: str, *xs: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.operand(x) for x in xs))


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.to(torch.float32)
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------------
# The int8 boundary: symmetric per-tile codes over the last axis
# ---------------------------------------------------------------------------
def quantize_int8(x: torch.Tensor, tile: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """Codes round(x / s) in [-127, 127] and f32 scales s = max|x| / 127 of
    each tile of ``tile`` lanes (at least 1e-8 / 127)."""
    *lead, d = x.shape
    tile = math.gcd(d, tile)
    xt = x.to(torch.float32).reshape(*lead, d // tile, tile)
    scale = xt.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    q = torch.clamp(torch.round(xt / scale), -127, 127)
    return q.to(torch.int8).reshape(*lead, d), scale[..., 0]


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    *lead, d = q.shape
    tile = d // scales.shape[-1]
    x = q.to(torch.float32).reshape(*lead, d // tile, tile) * scales.float()[..., None]
    return x.reshape(*lead, d)


# ---------------------------------------------------------------------------
# Head and loss
# ---------------------------------------------------------------------------
def _rows_nll(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor, vocab: int,
              prec: Precision) -> torch.Tensor:
    logits = prec.mm(h, w.t())[..., :vocab]
    return torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]


def lm_loss(h: torch.Tensor, norm_scale: torch.Tensor, w: torch.Tensor, tokens: torch.Tensor,
            vocab: int, eps: float, prec: Precision, rows: int = 1024) -> torch.Tensor:
    """Mean next-token cross entropy of f32 logits over the vocabulary's
    first ``vocab`` columns (the rest is padding), from the last block's
    output ``h`` (B, S, D). Computed ``rows`` positions at a time, each
    piece recomputed in the backward, so the logits never all live."""
    x = rmsnorm(norm_scale, h[:, :-1], eps).reshape(-1, h.shape[-1])
    labels = tokens[:, 1:].reshape(-1).long()
    total = x.new_zeros(())
    for lo in range(0, x.shape[0], rows):
        part = (x[lo:lo + rows], w, labels[lo:lo + rows])
        if torch.is_grad_enabled():
            nll = checkpoint(_rows_nll, *part, vocab, prec, use_reentrant=False)
        else:
            nll = _rows_nll(*part, vocab, prec)
        total = total + nll.sum()
    return total / x.shape[0]


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def decays(name: str) -> bool:
    """Weight decay on every weight but the norms' scales and the SSM's dt
    bias."""
    last = name.rsplit(".", 1)[-1]
    return not (last in ("scale", "norm_scale", "dt_bias"))


def lr_at(step: int, tc: dict) -> float:
    """Linear warmup over ``warmup_steps``, then cosine to a tenth of the peak."""
    warm = min(step / max(tc["warmup_steps"], 1), 1.0)
    prog = min(max((step - tc["warmup_steps"]) / max(tc["total_steps"] - tc["warmup_steps"], 1),
                   0.0), 1.0)
    return tc["learning_rate"] * warm * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


class AdamW:
    """AdamW with global-norm clipping, decoupled weight decay scaled by the
    learning rate, both moments and the update in f32; each parameter is
    stored back in its configured dtype after the update."""

    def __init__(self, params: Dict[str, torch.Tensor], stored: Dict[str, torch.dtype],
                 tc: dict):
        self.tc = {"beta1": 0.9, "beta2": 0.95, "eps": 1e-8, "weight_decay": 0.01,
                   "grad_clip": 1.0, **tc}
        self.stored = stored
        self.m = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        self.step = 0

    def update(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> float:
        """One step in place; returns the gradients' global norm."""
        tc = self.tc
        self.step += 1
        lr = lr_at(self.step, tc)
        gnorm = math.sqrt(sum(float(g.float().square().sum()) for g in grads.values()))
        clip = min(tc["grad_clip"] / max(gnorm, 1e-9), 1.0) if tc["grad_clip"] else 1.0
        b1, b2 = tc["beta1"], tc["beta2"]
        bc1, bc2 = 1 - b1 ** self.step, 1 - b2 ** self.step
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k].float() * clip
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                delta = (self.m[k] / bc1) / ((self.v[k] / bc2).sqrt() + tc["eps"])
                if decays(k):
                    delta = delta + tc["weight_decay"] * p
                p.copy_((p - lr * delta).to(self.stored[k]).float())
        return gnorm


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.float().norm()) for k, t in tensors.items()}


def blocks_of(names: Iterable[str], lo: int, hi: int) -> list:
    return [n for n in names if n.startswith("blocks.") and lo <= int(n.split(".")[1]) < hi]
