"""Plain reference of a Mamba-2 layer (arXiv:2405.21060): a pre-norm SSD
mixer added to the residual stream, with no MLP.

The mixer projects the normed input to z, x (heads of P), B, C (one group
of N) and dt; x, B and C pass a depthwise causal convolution with a bias
and SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log); the scan
h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t)^T, y_t = C_t h_t + D x_t; then
y * silu(z) is RMS-normed per head (the program's grouping: see the
configuration's departures) and projected out. The scan is computed chunk
by chunk in its matrix form, each chunk's within-chunk part as a masked
(C B^T * L) product and the carried state added, which is the same sum
as the recurrence. Weights are named as ``hapibench/weights.py`` names them.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from hapibench.reference.common import Precision, rmsnorm, silu


def causal_conv(w: torch.Tensor, bias: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """out_t = sum_i w[i] x_{t - (W - 1) + i} + bias, zeros before the start;
    w (W, ...) over x (B, S, ...)."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0) * (x.dim() - 2) + (width - 1, 0))
    out = bias.float().expand_as(x).clone()
    for i in range(width):
        out = out + xp[:, i:i + s] * w[i].float()
    return out


def ssd(x: torch.Tensor, dtA: torch.Tensor, dt: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int, prec: Precision) -> torch.Tensor:
    """y (B, S, H, P) of the scan from a zero state: x (B, S, H, P), dtA and
    dt (B, S, H), B and C (B, S, N)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    state = x.new_zeros((b, h, n, p))
    ys = []
    for lo in range(0, s, chunk):
        xs = x[:, lo:lo + chunk] * dt[:, lo:lo + chunk, :, None]
        cum = torch.cumsum(dtA[:, lo:lo + chunk], dim=1)                  # (B, Q, H)
        q = cum.shape[1]
        seg = cum[:, :, None, :] - cum[:, None, :, :]                     # (B, Qt, Qj, H)
        decay = torch.exp(seg.masked_fill(~tri[:q, :q, None], float("-inf")))
        cb = prec.einsum("btn,bjn->btj", C[:, lo:lo + chunk], B[:, lo:lo + chunk])
        y = prec.einsum("btjh,bjhp->bthp", cb[..., None] * decay, xs)
        y = y + prec.einsum("btn,bhnp->bthp", C[:, lo:lo + chunk], state) \
            * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[:, -1:] - cum)                             # (B, Q, H)
        state = state * torch.exp(cum[:, -1])[:, :, None, None] + prec.einsum(
            "bjn,bjhp->bhnp", B[:, lo:lo + chunk], xs * to_end[..., None])
        ys.append(y)
    return torch.cat(ys, dim=1)


def block(w: Dict[str, torch.Tensor], pre: str, h: torch.Tensor, m: dict,
          prec: Precision) -> torch.Tensor:
    eps = m["norm_eps"]
    mx = pre + "mamba."
    u = rmsnorm(w[pre + "ln_mixer.scale"], h, eps)
    z = prec.einsum("bsd,dhp->bshp", u, w[mx + "w_z"])
    x = prec.einsum("bsd,dhp->bshp", u, w[mx + "w_x"])
    B = prec.mm(u, w[mx + "w_B"])
    C = prec.mm(u, w[mx + "w_C"])
    dt = F.softplus(prec.mm(u, w[mx + "w_dt"]) + w[mx + "dt_bias"].float())
    x = silu(causal_conv(w[mx + "conv_x"], w[mx + "conv_x_b"], x))
    B = silu(causal_conv(w[mx + "conv_B"], w[mx + "conv_B_b"], B))
    C = silu(causal_conv(w[mx + "conv_C"], w[mx + "conv_C_b"], C))
    A = -torch.exp(w[mx + "A_log"].float())
    y = ssd(x, dt * A, dt, B, C, m["ssm_chunk"], prec) + w[mx + "D"].float()[:, None] * x
    y = rmsnorm(w[mx + "norm_scale"], y * silu(z), eps)
    return h + prec.einsum("bshp,hpd->bsd", y, w[mx + "w_out"])
