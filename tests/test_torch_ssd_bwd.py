"""The backward of the port's SSD scan against autograd and the JAX package, on the CPU.

``ref.ssd_chunked_bwd`` is the plain version of the backward kernel
(``csrc/ssd_scan_bwd.cu``): the explicit gradients of the chunked scan,
chunk by chunk from the last. It is held to ``torch.autograd.grad`` of the
plain forward ``ref.ssd_chunked`` and to ``jax.vjp`` of the JAX model's
``ssd_chunked`` on the same numpy inputs. Both sides compute in f32 in
another order, so each gradient agrees to 1e-5 relative L2 (observed about
1e-6). ``SSDScanFn``, which the model trains through, runs these plain
versions on CPU tensors. The tensor-core route's pieces have plain versions
too: ``ref.ssd_bwd_chunk_dstates`` (the gradient of the state leaving each
chunk) is held to autograd of the recurrence from that state and to
``jax.vjp`` with respect to the JAX scan's initial state, and
``ref.ssd_chunked_bwd_telescoped`` (d dtA with nothing subtracted) to
``ref.ssd_chunked_bwd``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tsk

GRAD_TOL = 1e-5
NAMES = ("dx", "ddtA", "ddt", "dB", "dC")

# b, s, h, p, n, chunk, a_log (None: rates -exp(0.3 z)), a final-state gradient
CASES = [
    (2, 64, 3, 16, 16, 64, None, False),    # one chunk
    (2, 48, 3, 16, 16, 16, None, False),    # the smoke model's widths, 3 chunks
    (1, 128, 2, 8, 8, 16, None, True),      # 8 chunks, the final state's gradient
    (2, 96, 3, 8, 8, 32, -4.0, True),       # slow decay: the state carries far
    (1, 40, 2, 16, 32, 8, -1.0, False),     # a chunk off 16
    (1, 60, 2, 8, 4, 256, None, True),      # a sequence shorter than the chunk
]


def _inputs(b, s, h, p, n, a_log, dstate, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    rate = rng.standard_normal(h) * 0.3 if a_log is None else np.full(h, a_log)
    a = -np.exp(rate).astype(np.float32)
    B_ = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    C_ = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    ds = rng.standard_normal((b, h, n, p)).astype(np.float32) if dstate else None
    return (x, (dt * a).astype(np.float32), dt, B_, C_), dy, ds


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _autograd(args, dy, ds, chunk):
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, st = tref.ssd_chunked(*leaves, chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if ds is not None:
        loss = loss + (st * torch.from_numpy(ds)).sum()
    return torch.autograd.grad(loss, leaves)


def _plain_bwd(args, dy, ds, chunk):
    return tref.ssd_chunked_bwd(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
                                None if ds is None else torch.from_numpy(ds), chunk=chunk)


@pytest.mark.parametrize("b,s,h,p,n,chunk,a_log,dstate", CASES)
def test_plain_bwd_matches_autograd(b, s, h, p, n, chunk, a_log, dstate):
    args, dy, ds = _inputs(b, s, h, p, n, a_log, dstate)
    got = _plain_bwd(args, dy, ds, chunk)
    want = _autograd(args, dy, ds, chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel(g, w) <= GRAD_TOL, (name, _rel(g, w))


@pytest.mark.parametrize("b,s,h,p,n,chunk,a_log,dstate", CASES)
def test_plain_bwd_matches_jax_vjp(b, s, h, p, n, chunk, a_log, dstate):
    args, dy, ds = _inputs(b, s, h, p, n, a_log, dstate)
    got = _plain_bwd(args, dy, ds, chunk)
    (y, st), vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, None, chunk=chunk),
                           *(jnp.asarray(a) for a in args))
    want = vjp((jnp.asarray(dy), jnp.zeros_like(st) if ds is None else jnp.asarray(ds)))
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= GRAD_TOL, (name, _rel(g.numpy(), w))


def test_plain_bwd_returns_the_inputs_dtypes():
    """bf16 x, B and C get bf16 gradients; dtA and dt keep f32."""
    args, dy, _ = _inputs(1, 32, 2, 16, 16, None, False)
    targs = [torch.from_numpy(a) for a in args]
    for i in (0, 3, 4):
        targs[i] = targs[i].to(torch.bfloat16)
    got = tref.ssd_chunked_bwd(*targs, torch.from_numpy(dy), chunk=16)
    assert [g.dtype for g in got] == [t.dtype for t in targs]
    want = tref.ssd_chunked_bwd(*(t.float() for t in targs), torch.from_numpy(dy), chunk=16)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.to(g.dtype).float(), atol=0, rtol=0)


@pytest.mark.parametrize("s,chunk", [(48, 16), (64, 64), (40, 8)])
def test_states_are_the_recurrence_state_entering_each_chunk(s, chunk):
    """``ssd_chunked(states=True)``'s third output: zeros for the first chunk,
    then the sequential recurrence's state after the chunks before."""
    args, _, _ = _inputs(2, s, 3, 16, 16, None, False)
    targs = [torch.from_numpy(a) for a in args]
    y, st, states = tref.ssd_chunked(*targs, chunk=chunk, states=True)
    y0, st0 = tref.ssd_chunked(*targs, chunk=chunk)
    assert torch.equal(y, y0) and torch.equal(st, st0)
    assert states.shape == (2, s // chunk, 3, 16, 16) and not states[:, 0].any()
    for c in range(1, s // chunk):
        _, want = tref.ssd_reference(*(t[:, :c * chunk] for t in targs))
        np.testing.assert_allclose(states[:, c].numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("dstate", [False, True])
def test_ssd_fn_on_cpu_matches_autograd_of_the_plain_forward(dstate):
    """ops.ssd_scan under autograd runs SSDScanFn (the plain forward with its
    states, then the plain backward): the gradients of every input match
    autograd through ref.ssd_chunked, and no kernel launches."""
    args, dy, ds = _inputs(2, 96, 3, 16, 16, -1.0, dstate)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    tops.reset_launch_counts()
    y, st = tops.ssd_scan(*leaves, chunk=32)
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward"
    loss = (y * torch.from_numpy(dy)).sum()
    if dstate:
        loss = loss + (st * torch.from_numpy(ds)).sum()
    got = torch.autograd.grad(loss, leaves)
    want = _autograd(args, dy, ds, 32)
    for name, g, w in zip(NAMES, got, want):
        assert _rel(g, w) <= GRAD_TOL, (name, _rel(g, w))
    assert sum(tops.launch_counts().values()) == 0
    # Without grad the plain forward runs as before.
    with torch.no_grad():
        y2, _ = tops.ssd_scan(*leaves, chunk=32)
    assert y2.grad_fn is None and torch.equal(y2, y.detach())


def test_ssd_fn_state_alone_and_remat():
    """A loss on the final state alone reaches every input; under
    torch.utils.checkpoint the forward reruns and the gradients are the same
    bits."""
    args, _, ds = _inputs(1, 64, 2, 16, 16, None, True)
    results = []
    for remat in (False, True):
        leaves = [torch.from_numpy(a).requires_grad_() for a in args]
        fn = (lambda *a: tops.ssd_scan(*a, chunk=16))
        _, st = torch.utils.checkpoint.checkpoint(fn, *leaves, use_reentrant=False) if remat \
            else fn(*leaves)
        results.append(torch.autograd.grad((st * torch.from_numpy(ds)).sum(), leaves))
    for a, b in zip(*results):
        assert torch.equal(a, b)
    want = _plain_bwd(args, np.zeros((1, 64, 2, 16), np.float32), ds, 16)
    for a, w in zip(results[0], want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("s,chunk", [(8, 256), (100, 256), (64, 8), (72, 24)])
def test_padded_chunks_give_the_unpadded_gradients(s, chunk):
    """The bf16 forward kernel pads each chunk off 16 with zero steps
    (``pad_chunks``); the states it writes at the chunk boundaries are the
    unpadded scan's. The gradients through the padded scan, cut back with
    ``unpad_chunks``, are the unpadded scan's gradients."""
    args, dy, ds = _inputs(2, s, 3, 16, 16, -1.0, True)
    q = min(chunk, s)
    targs = [torch.from_numpy(a) for a in args]
    padded, q16 = tsk.pad_chunks(*targs, q)
    dyp = tsk.pad_chunks(torch.from_numpy(dy), *targs[1:], q)[0][0]
    assert q16 > q and dyp.shape == padded[0].shape
    _, _, states = tref.ssd_chunked(*targs, chunk=q, states=True)
    _, _, states_p = tref.ssd_chunked(*padded, chunk=q16, states=True)
    np.testing.assert_allclose(states_p.numpy(), states.numpy(), atol=1e-6, rtol=1e-6)
    got = tref.ssd_chunked_bwd(*padded, dyp, torch.from_numpy(ds), chunk=q16)
    want = _plain_bwd(args, dy, ds, q)
    for name, g, w in zip(NAMES, got, want):
        g = tsk.unpad_chunks(g, q, q16)
        assert g.shape == w.shape, name
        assert _rel(g, w) <= GRAD_TOL, (name, _rel(g, w))


_BWD_SHAPES = [
    # b, h, p, n, chunk
    (2, 64, 64, 128, 256),   # mamba2-1.3b's training microbatch
    (4, 8, 16, 16, 16),      # the smoke model's widths
    (1, 3, 48, 80, 100),     # widths off 64 and a chunk off 16: padded to tiles of 64
    (1, 2, 64, 128, 640),    # the longest chunk at the largest widths
]


@pytest.mark.parametrize("b,h,p,n,q", _BWD_SHAPES)
def test_bwd_launch_config_fits_the_card(b, h, p, n, q):
    """Every launch of a bf16 call fits a block's shared memory. Chunks up to
    256 steps take the tensor-core route: six launches, the chunk padded to
    tiles of 64, the main and state kernels one block of 8 warps per (key
    tile and row, chunk, head group); the longest chunk takes the FMA route,
    one block of 256 threads per (head, batch row) and the head reduction."""
    cfg = tsk.bwd_launch_config(b, h, p, n, q)
    assert all(smem <= tsk.SMEM_LIMIT == 232_448 for _, _, smem in cfg.values())
    assert tsk.BWD_TILE == 64 and tsk.BWD_THREADS == 256
    if q <= 256:
        assert tuple(cfg) == tsk.BWD_KERNELS
        nt, grp = -(-q // 64), h // tsk.heads_per_group(h)
        assert cfg["main"][:2] == ((1, grp, nt * b), 256)
        assert cfg["state"][:2] == ((nt, 1, grp * b), 256)
        assert cfg["dbdc"][0] == (1, nt, b) and cfg["ddta"] == ((1, h, b), 64 * nt, 0)
        # G^T tiles of the group (nT x 8 warps x 512 f32), a ring of three dy
        # tiles and dh as hi/lo bf16 halves.
        assert cfg["main"][2] >= nt * 8 * 512 * 4 + 3 * 2 * 64 * p * 2 + 2 * n * p * 2
    else:
        assert tuple(cfg) == tsk.BWD_FMA_KERNELS
        assert cfg["fma"][:2] == ((h, b, 1), 256)
        assert cfg["fma"][2] >= 4 * (2 * n * p + 2 * n * 64 + 2 * p * 64 + 3 * 64 * 64 + 6 * q)
    if (b, h, p, n, q) == (2, 64, 64, 128, 256):
        full = tsk.bwd_launch_config(b, h, p, n, q, s=4096)
        assert full["main"] == ((16, 8, 8), 256, 215_552)
        assert full["state"] == ((4, 16, 16), 256, 224_768)
        assert full["dchunk"][0] == (16, 64, 2) and full["pass"][0] == (8, 64, 2)
    # f32 keeps the FMA kernel at every shape.
    f32 = tsk.bwd_launch_config(b, h, p, n, q, dtype=torch.float32)
    assert tuple(f32) == tsk.BWD_FMA_KERNELS and f32["fma"][0] == (h, b, 1)
    if (b, h, p, n, q) == (2, 64, 64, 128, 256):
        assert f32["fma"][2] == 222_528 and 2 * f32["fma"][2] > tsk.SMEM_LIMIT


@pytest.mark.parametrize("dtype,n,p,q,route", [
    (torch.bfloat16, 128, 64, 256, "mma"), (torch.bfloat16, 16, 16, 8, "mma"),
    (torch.bfloat16, 80, 48, 100, "mma"), (torch.bfloat16, 128, 64, 640, "fma"),
    (torch.bfloat16, 120, 64, 256, "fma"), (torch.bfloat16, 128, 40, 256, "fma"),
    (torch.float32, 128, 64, 256, "fma")])
def test_bwd_route(dtype, n, p, q, route):
    assert tsk.bwd_route(dtype, n, p, q) == route


@pytest.mark.parametrize("h,g", [(64, 8), (24, 8), (12, 4), (6, 2), (3, 1), (1, 1)])
def test_heads_per_group(h, g):
    assert tsk.heads_per_group(h) == g


@pytest.mark.parametrize("p,n,q", [(80, 64, 64), (64, 144, 64), (64, 128, 700), (0, 64, 64),
                                   (64, 0, 64), (64, 64, 0)])
def test_bwd_launch_config_refuses_shapes(p, n, q):
    with pytest.raises(ValueError):
        tsk.bwd_launch_config(1, 1, p, n, q)


def test_bwd_wrapper_checks_before_the_device():
    """Shapes and the chunk are checked on CPU tensors too, before the device
    check, which a CPU tensor then fails."""
    args, dy, _ = _inputs(1, 64, 2, 16, 16, None, False)
    targs = [torch.from_numpy(a) for a in args]
    states = torch.zeros(1, 4, 2, 16, 16)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tsk.ssd_scan_bwd_cuda(*targs, states, torch.from_numpy(dy), chunk=24)
    with pytest.raises(ValueError, match="do not match"):
        tsk.ssd_scan_bwd_cuda(*targs, states[:, :2], torch.from_numpy(dy), chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.ssd_scan_bwd_cuda(*targs, states, torch.from_numpy(dy), chunk=16)


def _suffix_state_grad(args, dy, ds, chunk, c):
    """Autograd of the loss (y . dy over the steps after chunk c, plus
    state . ds at the end) through the sequential recurrence started from the
    state leaving chunk c: the gradient of that state."""
    x, dtA, dt, B_, C_ = (torch.from_numpy(a).double() for a in args)
    b, s, h, p = x.shape
    q = min(chunk, s)
    st0 = torch.zeros((b, h, B_.shape[-1], p), dtype=torch.float64, requires_grad=True)
    st, loss = st0, st0.sum() * 0
    for t in range((c + 1) * q, s):
        st = st * torch.exp(dtA[:, t])[..., None, None] \
            + torch.einsum("bn,bhp->bhnp", B_[:, t], x[:, t] * dt[:, t, :, None])
        loss = loss + (torch.einsum("bn,bhnp->bhp", C_[:, t], st)
                       * torch.from_numpy(dy[:, t]).double()).sum()
    if ds is not None:
        loss = loss + (st * torch.from_numpy(ds).double()).sum()
    return torch.autograd.grad(loss, st0)[0]


@pytest.mark.parametrize("b,s,h,p,n,chunk,a_log,dstate", CASES)
def test_chunk_dstates_match_autograd(b, s, h, p, n, chunk, a_log, dstate):
    """``ref.ssd_bwd_chunk_dstates`` (the tensor-core backward's launches (a)
    and (b)) is, for each chunk, the gradient of the state leaving it."""
    args, dy, ds = _inputs(b, s, h, p, n, a_log, dstate)
    got = tref.ssd_bwd_chunk_dstates(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
                                     None if ds is None else torch.from_numpy(ds), chunk=chunk)
    q = min(chunk, s)
    assert got.dtype == torch.float32 and got.shape == (b, s // q, h, n, p)
    for c in range(s // q):
        want = _suffix_state_grad(args, dy, ds, chunk, c)
        if not want.any():   # nothing after the last chunk and no final-state gradient
            assert not got[:, c].any()
            continue
        assert _rel(got[:, c], want) <= GRAD_TOL, (c, _rel(got[:, c], want))


@pytest.mark.parametrize("b,s,h,p,n,chunk,a_log,dstate", CASES)
def test_chunk_dstates_match_jax_vjp(b, s, h, p, n, chunk, a_log, dstate):
    """The same against jax.vjp of the JAX scan over the chunks after c,
    with respect to its initial state."""
    args, dy, ds = _inputs(b, s, h, p, n, a_log, dstate)
    got = tref.ssd_bwd_chunk_dstates(*(torch.from_numpy(a) for a in args), torch.from_numpy(dy),
                                     None if ds is None else torch.from_numpy(ds), chunk=chunk)
    q = min(chunk, s)
    for c in range(s // q - 1):
        tail = [jnp.asarray(a[:, (c + 1) * q:]) for a in args]
        init = jnp.zeros((b, h, n, p), jnp.float32)
        (y, st), vjp = jax.vjp(lambda s0: jax_ssd_chunked(*tail, s0, chunk=chunk), init)
        (want,) = vjp((jnp.asarray(dy[:, (c + 1) * q:]),
                       jnp.zeros_like(st) if ds is None else jnp.asarray(ds)))
        assert _rel(got[:, c].numpy(), np.asarray(want)) <= GRAD_TOL, c
    last = got[:, -1].numpy()
    np.testing.assert_array_equal(last, np.zeros_like(last) if ds is None else ds)


@pytest.mark.parametrize("b,s,h,p,n,chunk,a_log,dstate", CASES)
def test_telescoped_ddtA_matches_plain_bwd(b, s, h, p, n, chunk, a_log, dstate):
    """d dtA from its telescoped, cancellation-free form (the tensor-core
    backward's) against ``ref.ssd_chunked_bwd``'s reverse cumsum; the other
    four gradients are the same tensors."""
    args, dy, ds = _inputs(b, s, h, p, n, a_log, dstate)
    targs = [torch.from_numpy(a) for a in args]
    tdy, tds = torch.from_numpy(dy), None if ds is None else torch.from_numpy(ds)
    got = tref.ssd_chunked_bwd_telescoped(*targs, tdy, tds, chunk=chunk)
    want = tref.ssd_chunked_bwd(*targs, tdy, tds, chunk=chunk)
    for name, g, w in zip(NAMES, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "ddtA":
            assert _rel(g, w) <= GRAD_TOL, _rel(g, w)
        else:
            assert torch.equal(g, w), name
    auto = _autograd(args, dy, ds, chunk)
    assert _rel(got[1], auto[1]) <= GRAD_TOL


@pytest.mark.parametrize("s,chunk", [(8, 256), (100, 256), (64, 8), (300, 100), (256, 256)])
def test_chunks_padded_to_tiles_give_the_unpadded_gradients(s, chunk):
    """The tensor-core backward pads each chunk to a multiple of 64 steps
    (``pad_chunks(..., multiple=64)``): the padded scan's gradients, cut back,
    are the unpadded scan's, and a chunk already a multiple of 64 is left
    as it is."""
    args, dy, ds = _inputs(1, s, 2, 16, 16, -1.0, True)
    q = min(chunk, s)
    targs = [torch.from_numpy(a) for a in args]
    padded, qp = tsk.pad_chunks(*targs, q, multiple=tsk.BWD_TILE)
    assert qp == tsk.padded_chunk(q, 64) and qp % 64 == 0 and qp - q < 64
    if qp == q:
        assert all(torch.equal(a, b_) for a, b_ in zip(padded, targs))
    dyp = tsk._pad_steps(torch.from_numpy(dy), q, qp)
    got = tref.ssd_chunked_bwd(*padded, dyp, torch.from_numpy(ds), chunk=qp)
    want = _plain_bwd(args, dy, ds, q)
    for name, g, w in zip(NAMES, got, want):
        g = tsk.unpad_chunks(g, q, qp)
        assert g.shape == w.shape, name
        assert _rel(g, w) <= GRAD_TOL, (name, _rel(g, w))


def test_dstates_wrapper_checks_before_the_device():
    """``ssd_bwd_chunk_dstates_cuda`` checks shapes and the route on CPU
    tensors, then refuses them: the kernel runs only on the card."""
    args, dy, _ = _inputs(1, 64, 2, 16, 16, None, False)
    _, dtA, _, _, C_ = (torch.from_numpy(a) for a in args)
    tdy, cb = torch.from_numpy(dy), C_.to(torch.bfloat16)
    with pytest.raises(ValueError, match="do not match"):
        tsk.ssd_bwd_chunk_dstates_cuda(dtA, cb, tdy, chunk=24)
    with pytest.raises(ValueError, match="tensor-core"):
        tsk.ssd_bwd_chunk_dstates_cuda(dtA, C_, tdy, chunk=16)
    with pytest.raises(ValueError, match="CUDA"):
        tsk.ssd_bwd_chunk_dstates_cuda(dtA, cb, tdy, chunk=16)
