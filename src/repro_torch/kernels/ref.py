"""Plain PyTorch versions of the port's kernels.

Counterpart of ``repro/kernels/ref.py``. ``ops`` takes them for tensors on
the CPU, and the card's checks hold each CUDA kernel against them on the
same inputs. The plain version of the SSD kernel is ``ssd_chunked``, the
chunked form of ``repro/models/ssm.py`` (which ``models.ssm`` exports under
that name); ``ssd_reference`` is the recurrence both are held to.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def flash_attention(
    q: torch.Tensor,  # (B, S, H, hd)
    k: torch.Tensor,  # (B, S, H, hd) — KV already repeated to H
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    scores, _, _ = _scores(q, k, causal, window, softcap)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, window: Optional[int],
            softcap: Optional[float]):
    """Scaled, soft-capped, masked f32 scores (B, H, S, S) of q (B, S, H, hd)
    against k with H heads, the live mask, and the soft-cap's tanh (or None)."""
    s, hd = q.shape[1], q.shape[3]
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    th = None
    if softcap is not None:
        th = torch.tanh(scores / softcap)
        scores = softcap * th
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window - 1
    return scores.masked_fill(~mask, -1e30), mask, th


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """``flash_attention`` (k, v repeated to H heads) and each row's
    log-sum-exp of the scores in base 2, (B, H, S) f32: the kernel's
    ``lse``, with which P = exp2(score * log2(e) - lse)."""
    scores, _, _ = _scores(q, k, causal, window, softcap)
    lse = torch.logsumexp(scores, dim=-1) * math.log2(math.e)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype), lse


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None, softcap: Optional[float] = None):
    """(dq, dk, dv) of ``flash_attention`` from the explicit formulas, in
    f32, returned in the inputs' dtype. v may have a head dim of its own (the
    output's), the scale is q's. k and v have Hkv heads dividing H
    (query head h reads KV head h // (H // Hkv)); dk and dv sum over each
    group. P = softmax(scores); dV = P^T dO; dP = dO V^T; D = rowsum(P * dP);
    dS = P * (dP - D), times 1 - tanh^2 under a soft-cap;
    dQ = dS K * scale; dK = dS^T Q * scale."""
    b, s, h, hd = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    kr, vr = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    scores, mask, th = _scores(q, kr, causal, window, softcap)
    p = torch.softmax(scores, dim=-1)
    g = dout.float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, vr.float())
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if th is not None:
        ds = ds * (1 - th * th)
    ds = ds * mask
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dk = dk.reshape(b, s, hkv, rep, hd).sum(3)
    dv = dv.reshape(b, s, hkv, rep, v.shape[3]).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention(
    q: torch.Tensor,        # (B, Hq, hd) — one token
    k_cache: torch.Tensor,  # (B, S, Hkv, hd)
    v_cache: torch.Tensor,
    length: int,            # valid cache length (positions < length)
    *,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """GQA decode of one query token. ``window`` admits only
    ``kpos >= length - 1 - window``, the mask of ``attention_decode``'s
    sliding-window layers. The result has the cache's dtype."""
    b, hq, hd = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, hq // hkv, hd)
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32, device=q.device))
    scores = torch.einsum("bhrd,bshd->bhrs", qg.float(), k_cache.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    kpos = torch.arange(s, device=q.device)
    valid = kpos < length
    if window is not None:
        valid &= kpos >= length - 1 - window
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bhrs,bshd->bhrd", probs.float(), v_cache.float())
    return out.to(v_cache.dtype).reshape(b, hq, hd)


def ssd_reference(
    x: torch.Tensor,     # (B, S, H, P)
    dtA: torch.Tensor,   # (B, S, H) log decay
    dt: torch.Tensor,    # (B, S, H) input scale
    B_: torch.Tensor,    # (B, S, N)
    C_: torch.Tensor,    # (B, S, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD as its sequential recurrence from a zero state, one step at
    a time: the ground truth the chunked forms are held to. Returns
    (y f32, state f32)."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    x, dtA, dt, B_, C_ = (t.float() for t in (x, dtA, dt, B_, C_))
    ys = []
    for t in range(s):
        upd = torch.einsum("bn,bhp->bhnp", B_[:, t], x[:, t] * dt[:, t, :, None])
        state = state * torch.exp(dtA[:, t])[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", C_[:, t], state))
    return torch.stack(ys, dim=1), state


def ssd_chunked(
    x: torch.Tensor,     # (B, S, H, P)
    dtA: torch.Tensor,   # (B, S, H) log decay (= dt * A, A < 0)
    dt: torch.Tensor,    # (B, S, H) input scale
    B_: torch.Tensor,    # (B, S, N)
    C_: torch.Tensor,    # (B, S, N)
    chunk: int = 256,
    states: bool = False,
):
    """Mamba2 SSD in its chunked matrix form, from a zero state, one chunk
    at a time: the within-chunk term ``(C.B^T * L).(x dt)`` with
    ``L[i, j] = exp(cum_i - cum_j)`` for ``i >= j``, the carried-state term
    and the state update. Returns (y f32 (B, S, H, P), state f32 (B, H, N, P));
    given ``states=True`` also the state entering each chunk, f32
    (B, S / chunk, H, N, P), which the backward reads."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    ys, entering = [], []
    for s0 in range(0, s, q):
        entering.append(state)
        xk = x[:, s0:s0 + q].float()
        ak, dk = dtA[:, s0:s0 + q].float(), dt[:, s0:s0 + q].float()
        bk, ck = B_[:, s0:s0 + q].float(), C_[:, s0:s0 + q].float()
        cum = torch.cumsum(ak, dim=1)                                    # (B, Q, H)
        decay = torch.exp(cum[:, :, None, :] - cum[:, None, :, :])       # (B, Q, Q, H)
        decay = torch.where(tri[None, :, :, None], decay, torch.zeros((), device=x.device))
        scores = torch.einsum("bqn,bkn->bqk", ck, bk)[..., None] * decay
        xs = xk * dk[..., None]                                          # dt-scaled inputs
        y_diag = torch.einsum("bqkh,bkhp->bqhp", scores, xs)
        y_off = torch.einsum("bqn,bhnp,bqh->bqhp", ck, state, torch.exp(cum))
        to_end = torch.exp(cum[:, -1:, :] - cum)                         # (B, Q, H)
        s_chunk = torch.einsum("bqn,bqh,bqhp->bhnp", bk, to_end, xs)
        state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + s_chunk
        ys.append(y_diag + y_off)
    if states:
        return torch.cat(ys, dim=1), state, torch.stack(entering, dim=1)
    return torch.cat(ys, dim=1), state


def ssd_chunked_bwd(
    x: torch.Tensor,      # (B, S, H, P)
    dtA: torch.Tensor,    # (B, S, H)
    dt: torch.Tensor,     # (B, S, H)
    B_: torch.Tensor,     # (B, S, N)
    C_: torch.Tensor,     # (B, S, N)
    dy: torch.Tensor,     # (B, S, H, P), the gradient of y
    dstate: Optional[torch.Tensor] = None,   # (B, H, N, P), of the final state
    chunk: int = 256,
    states: Optional[torch.Tensor] = None,   # (B, S / chunk, H, N, P), entering each chunk
):
    """(dx, d dtA, d dt, dB, dC) of ``ssd_chunked`` from the explicit
    formulas, in f32, chunk by chunk from the last, each returned in its
    input's dtype. Per chunk, with ``cum`` the cumsum of dtA, ``xs = x dt``,
    ``L[i, j] = exp(cum_i - cum_j)`` (i >= j, else 0), ``S = C.B^T``,
    ``M[i, j] = dy_i . xs_j``, ``W = S * M * L``, ``e_i = exp(cum_i)``,
    ``t_j = exp(cum_end - cum_j)``, ``h`` the state entering the chunk and
    ``dh`` the gradient of the state leaving it:

      dxs_j   = sum_{i>=j} S_ij L_ij dy_i + t_j (B_j . dh);  dx = dxs dt,
                d dt_j = dxs_j . x_j
      dC_i    = sum_h [ sum_j (M L)_ij B_j + e_i (h . dy_i) ]
      dB_j    = sum_h [ sum_i (M L)_ij C_i + t_j (dh . xs_j) ]
      d cum_i = sum_j W_ij - sum_k W_ki + e_i (C_i h) . dy_i
                - t_i (B_i dh) . xs_i, the last step also
                + sum_j t_j (B_j dh) . xs_j + e_end sum(h * dh);
                d dtA is its reverse cumsum within the chunk
      dh     <- e_end dh + sum_i e_i C_i^T dy_i   (for the chunk before)

    ``dstate`` None is a zero gradient; ``states`` None recomputes them."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    nc = s // q
    if states is None:
        states = ssd_chunked(x, dtA, dt, B_, C_, chunk=chunk, states=True)[2]

    def chunks(t: torch.Tensor) -> torch.Tensor:
        return t.float().reshape(b, nc, q, *t.shape[2:])

    xk, ak, dk, bk, ck, gk = (chunks(t) for t in (x, dtA, dt, B_, C_, dy))
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[None, :, :, None]
    zero = torch.zeros((), device=x.device)
    dh = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device) if dstate is None \
        else dstate.float()
    out = {k: [None] * nc for k in ("dx", "ddtA", "ddt", "dB", "dC")}
    for c in reversed(range(nc)):
        xc, dtc, bc, cc, gc = xk[:, c], dk[:, c], bk[:, c], ck[:, c], gk[:, c]
        hc = states[:, c].float()
        cum = torch.cumsum(ak[:, c], dim=1)                               # (B, Q, H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]                    # (B, i, j, H)
        L = torch.where(tri, torch.exp(torch.where(tri, diff, zero)), zero)
        e = torch.exp(cum)
        e_end = e[:, -1]                                                  # (B, H)
        t = torch.exp(cum[:, -1:, :] - cum)
        xs = xc * dtc[..., None]
        S = torch.einsum("bin,bjn->bij", cc, bc)
        M = torch.einsum("bihp,bjhp->bijh", gc, xs)
        SL, ML = S[..., None] * L, M * L
        W = SL * M
        Bdh = torch.einsum("bjn,bhnp->bjhp", bc, dh)
        dxs = torch.einsum("bijh,bihp->bjhp", SL, gc) + t[..., None] * Bdh
        out["dx"][c] = dxs * dtc[..., None]
        out["ddt"][c] = (dxs * xc).sum(-1)
        out["dC"][c] = torch.einsum("bijh,bjn->bin", ML, bc) \
            + torch.einsum("bih,bhnp,bihp->bin", e, hc, gc)
        out["dB"][c] = torch.einsum("bijh,bin->bjn", ML, cc) \
            + torch.einsum("bjh,bhnp,bjhp->bjn", t, dh, xs)
        tail = t * (Bdh * xs).sum(-1)                                     # (B, Q, H)
        dcum = W.sum(2) - W.sum(1) + e * (torch.einsum("bin,bhnp->bihp", cc, hc) * gc).sum(-1) \
            - tail
        dcum[:, -1] += tail.sum(1) + e_end * (hc * dh).sum((-1, -2))
        out["ddtA"][c] = torch.flip(torch.cumsum(torch.flip(dcum, (1,)), 1), (1,))
        dh = dh * e_end[..., None, None] + torch.einsum("bih,bin,bihp->bhnp", e, cc, gc)
    return tuple(torch.cat(out[k], dim=1).to(like.dtype)
                 for k, like in (("dx", x), ("ddtA", dtA), ("ddt", dt), ("dB", B_), ("dC", C_)))


def ssd_bwd_chunk_dstates(
    x: torch.Tensor,      # (B, S, H, P)
    dtA: torch.Tensor,    # (B, S, H)
    dt: torch.Tensor,     # (B, S, H)
    B_: torch.Tensor,     # (B, S, N)
    C_: torch.Tensor,     # (B, S, N)
    dy: torch.Tensor,     # (B, S, H, P), the gradient of y
    dstate: Optional[torch.Tensor] = None,   # (B, H, N, P), of the final state
    chunk: int = 256,
) -> torch.Tensor:
    """The gradient of the state leaving each chunk, (B, S / chunk, H, N, P)
    f32: ``dstate`` (None is zero) for the last chunk, then, chunk by chunk
    from the last, ``dh_{c-1} = e_end,c dh_c + sum_i e_i C_i^T dy_i`` with
    ``e_i = exp(cum_i)`` over chunk c. The plain version of the tensor-core
    backward's first two launches (``csrc/ssd_scan_bwd.cu`` (a), (b)); ``x``
    and ``dt`` do not enter it."""
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {q}")
    nc = s // q
    cum = torch.cumsum(dtA.float().reshape(b, nc, q, h), dim=2)
    e = torch.exp(cum)
    ck, gk = C_.float().reshape(b, nc, q, n), dy.float().reshape(b, nc, q, h, p)
    dh = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device) if dstate is None \
        else dstate.float()
    out = [None] * nc
    for c in reversed(range(nc)):
        out[c] = dh
        dh = dh * e[:, c, -1][..., None, None] + torch.einsum("bih,bin,bihp->bhnp", e[:, c],
                                                              ck[:, c], gk[:, c])
    return torch.stack(out, dim=1)


def ssd_chunked_bwd_telescoped(
    x: torch.Tensor,      # (B, S, H, P)
    dtA: torch.Tensor,    # (B, S, H)
    dt: torch.Tensor,     # (B, S, H)
    B_: torch.Tensor,     # (B, S, N)
    C_: torch.Tensor,     # (B, S, N)
    dy: torch.Tensor,     # (B, S, H, P)
    dstate: Optional[torch.Tensor] = None,
    chunk: int = 256,
    states: Optional[torch.Tensor] = None,
):
    """``ssd_chunked_bwd`` with d dtA taken from the telescoped form of its
    reverse cumsum, in which no term is subtracted (the form the tensor-core
    backward computes): for step k of a chunk,

      d dtA_k = sum_{i>=k} sum_{j<k} W_ij + sum_{i>=k} e_i (C_i h) . dy_i
                + sum_{j<k} t_j (B_j dh) . xs_j + e_end sum(h * dh)

    with W, e, t, h and dh as in ``ssd_chunked_bwd``. The other four
    gradients are ``ssd_chunked_bwd``'s. Exclusive sums are inclusive sums
    shifted by one step, so that nothing is subtracted there either."""
    grads = ssd_chunked_bwd(x, dtA, dt, B_, C_, dy, dstate, chunk=chunk, states=states)
    b, s, h, p = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    nc = s // q
    if states is None:
        states = ssd_chunked(x, dtA, dt, B_, C_, chunk=chunk, states=True)[2]
    dhs = ssd_bwd_chunk_dstates(x, dtA, dt, B_, C_, dy, dstate, chunk=chunk)

    def chunks(t: torch.Tensor) -> torch.Tensor:
        return t.float().reshape(b, nc, q, *t.shape[2:])

    def shift(t: torch.Tensor) -> torch.Tensor:   # t[:, k] <- t[:, k - 1], 0 at k = 0
        return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)

    xk, ak, dk, bk, ck, gk = (chunks(t) for t in (x, dtA, dt, B_, C_, dy))
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))[None, :, :, None]
    zero = torch.zeros((), device=x.device)
    out = []
    for c in range(nc):
        xc, dtc, bc, cc, gc = xk[:, c], dk[:, c], bk[:, c], ck[:, c], gk[:, c]
        hc, dh = states[:, c].float(), dhs[:, c]
        cum = torch.cumsum(ak[:, c], dim=1)
        diff = cum[:, :, None, :] - cum[:, None, :, :]
        L = torch.where(tri, torch.exp(torch.where(tri, diff, zero)), zero)
        e, t = torch.exp(cum), torch.exp(cum[:, -1:, :] - cum)
        xs = xc * dtc[..., None]
        W = torch.einsum("bin,bjn->bij", cc, bc)[..., None] * L \
            * torch.einsum("bihp,bjhp->bijh", gc, xs)                    # (B, i, j, H)
        pre = shift(torch.cumsum(W.transpose(1, 2), dim=1)).transpose(1, 2)  # sum_{j<k} W_ik
        rect = (pre * tri).sum(1)                     # sum over i >= k of pre[i, k]
        eq = e * (torch.einsum("bin,bhnp->bihp", cc, hc) * gc).sum(-1)
        tail = t * (torch.einsum("bjn,bhnp->bjhp", bc, dh) * xs).sum(-1)
        r_eq = torch.flip(torch.cumsum(torch.flip(eq, (1,)), 1), (1,))
        p_tail = shift(torch.cumsum(tail, 1))
        z = (hc * dh).sum((-1, -2))
        out.append(rect + r_eq + p_tail + (torch.exp(cum[:, -1]) * z)[:, None])
    ddtA = torch.cat(out, dim=1).to(dtA.dtype)
    return grads[0], ddtA, grads[2], grads[3], grads[4]


def quantize_int8(x: torch.Tensor, tile: int = 128):
    """Per-tile symmetric int8 quantization over the last dim.
    Returns (q int8 (..., D), scales f32 (..., D/tile))."""
    *lead, d = x.shape
    tile = math.gcd(d, tile)  # clamp for narrow (smoke) widths
    xt = x.reshape(*lead, d // tile, tile).to(torch.float32)
    amax = xt.abs().amax(dim=-1, keepdim=True)
    # Divide by a tensor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its rounded reciprocal, one ulp off IEEE division.
    scale = torch.clamp(amax, min=1e-8) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(xt / scale), -127, 127).to(torch.int8)
    return q.reshape(*lead, d), scale[..., 0]


def split3_bf16(g: torch.Tensor) -> torch.Tensor:
    """The (3, ...) bf16 terms of an f32 ``g``: ``g1 = bf16(g)``,
    ``g2 = bf16(g - g1)``, ``g3 = bf16(g - g1 - g2)``, each rounded to
    nearest even; ``g1 + g2 + g3 == g`` exactly for ``|g| >= 2**-110``
    (``csrc/head_split.cu``)."""
    g1 = g.to(torch.bfloat16)
    r = g - g1.to(torch.float32)
    g2 = r.to(torch.bfloat16)
    g3 = (r - g2.to(torch.float32)).to(torch.bfloat16)
    return torch.stack([g1, g2, g3])


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    *lead, d = q.shape
    tile = d // scales.shape[-1]
    qt = q.reshape(*lead, d // tile, tile).to(torch.float32)
    x = qt * scales[..., None]
    return x.reshape(*lead, d).to(dtype)
