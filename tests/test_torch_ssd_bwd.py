"""The backward of the port's SSD scan against autograd and the JAX package, on the CPU.

``ref.ssd_chunked_bwd`` is the plain version of the backward kernel
(``csrc/ssd_scan_bwd.cu``): the explicit gradients of the chunked scan,
chunk by chunk from the last. It is held to ``torch.autograd.grad`` of the
plain forward ``ref.ssd_chunked`` and to ``jax.vjp`` of the JAX model's
``ssd_chunked`` on the same numpy inputs. Both sides compute in f32 in
another order, so each gradient agrees to 1e-5 relative L2 (observed about
1e-6). ``SSDScanFn``, which the model trains through, runs these plain
versions on CPU tensors.
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
    (1, 3, 48, 80, 100),     # widths and a chunk off 16: the kernel masks its tiles
    (1, 2, 64, 128, 640),    # the longest chunk at the largest widths
]


@pytest.mark.parametrize("b,h,p,n,q", _BWD_SHAPES)
def test_bwd_launch_config_fits_the_card(b, h, p, n, q):
    """One block of 256 threads per (head, batch row), every (head, row) once;
    the shared memory fits a block (one block an SM at mamba2's shape)."""
    (gx, gy, gz), threads, smem = tsk.bwd_launch_config(b, h, p, n, q)
    assert (gx, gy, gz, threads) == (h, b, 1, 256) and tsk.BWD_TILE == 64
    assert smem <= tsk.SMEM_LIMIT == 232_448
    # h_c and dh, the C and B tiles, the dy and xs tiles, three 64 x 64 tiles
    # and the per-step vectors, all f32.
    assert smem >= 4 * (2 * n * p + 2 * n * 64 + 2 * p * 64 + 3 * 64 * 64 + 6 * q)
    if (b, h, p, n, q) == (2, 64, 64, 128, 256):
        assert smem == 222_528 and 2 * smem > tsk.SMEM_LIMIT


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
