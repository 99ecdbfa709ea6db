"""The port's collectives against the JAX package's, on the CPU.

``repro_torch.distributed.collectives`` on gloo process groups: one rank in
this process (a ``FileStore`` under ``tmp_path``), and 2 and 4 ranks spawned
as processes of their own, each with a process-group timeout and joined
within ``JOIN_S`` so that a hung rank fails the test instead of holding the
suite. The port is held to its own plain composition (``ref.quantize_int8``,
``ref.dequantize_int8`` into bf16) bit for bit, and to the JAX
``compressed_psum`` under ``shard_map`` on one device within one code step:
the JAX quantize runs compiled, which multiplies by the rounded reciprocal
of 127 (ROADMAP Queue 3 notes), so a code next to a rounding boundary may be
one off.
"""
import datetime
import functools
import multiprocessing as mp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro.compat import shard_map
from repro.distributed import collectives as jcoll
from repro_torch.distributed import collectives as tcoll
from repro_torch.kernels import ops, ref

JOIN_S = 60
PG_TIMEOUT = datetime.timedelta(seconds=30)


def _plain(x, error=None):
    """compressed_psum's composition on one rank's x from the plain
    versions: (carry, that rank's dequantized row (1, D) in bf16)."""
    carry = x if error is None else x + error
    flat = F.pad(carry.reshape(-1), (0, (-carry.numel()) % 128))
    return carry, ref.dequantize_int8(*ref.quantize_int8(flat[None, :]))


def _unflat(row, like):
    return row[0, :like.numel()].reshape(like.shape)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1, timeout=PG_TIMEOUT)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_compressed_psum_raises_without_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        tcoll.compressed_psum(torch.ones(8))


@pytest.mark.parametrize("shape,dtype", [((64, 128), torch.float32), ((37, 50), torch.float32),
                                         ((300,), torch.bfloat16)])
def test_compressed_psum_one_rank_matches_plain_and_jax(one_rank, shape, dtype):
    """One rank: the total is the rank's own dequantized codes and the
    residual what they miss, bit for bit against the plain composition
    (shapes off 128 are padded); the JAX function on the same input agrees
    within one code step of each tile (1.5 x its scale: the step, and bf16's
    rounding of values up to 127 steps)."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(np.float32))
    x = x.to(dtype)
    e = (0.01 * x).to(dtype)
    ops.reset_launch_counts()
    total, err = tcoll.compressed_psum(x, error=e)
    carry, row = _plain(x, e)
    local = _unflat(row, carry)
    assert total.dtype == err.dtype == dtype and total.shape == err.shape == x.shape
    assert torch.equal(total, local.to(dtype))
    assert torch.equal(err, (carry.float() - local.float()).to(dtype))
    assert sum(ops.launch_counts().values()) == 0      # the plain versions on the CPU

    mesh = jax.make_mesh((1,), ("pod",))
    spec = jax.sharding.PartitionSpec()

    @functools.partial(shard_map, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec),
                       check_vma=False)
    def f(v, ev):
        return jcoll.compressed_psum(v, "pod", ev)

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jt, je = f(jnp.asarray(x.float().numpy(), jdt), jnp.asarray(e.float().numpy(), jdt))
    scales = ref.quantize_int8(F.pad(carry.reshape(-1), (0, (-carry.numel()) % 128))[None])[1]
    step = _unflat(scales.repeat_interleave(128, -1), carry).float().numpy()
    for got, want in ((total, jt), (err, je)):
        diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
        assert np.all(diff <= 1.5 * step), float((diff / step).max())
        assert np.mean(diff > 0) < 0.02


def test_tier_transfer_bytes_and_boundary():
    """tests/test_collectives.py's check, and the wire bytes equal to the
    JAX function's; the payload moves to the target device."""
    acts = torch.ones((4, 16, 256), dtype=torch.bfloat16)
    plain, wire_p = tcoll.tier_transfer(acts)
    comp, wire_c = tcoll.tier_transfer(acts, device=torch.device("cpu"), compress=True)
    jacts = jnp.ones((4, 16, 256), jnp.bfloat16)
    assert wire_p == jcoll.tier_transfer(jacts)[1] == 4 * 16 * 256 * 2
    assert wire_c == jcoll.tier_transfer(jacts, compress=True)[1] == 4 * 16 * 256 + 4 * 16 * 2 * 4
    assert wire_c < 0.6 * wire_p and plain is acts
    assert comp[0].dtype == torch.int8 and comp[1].dtype == torch.float32
    rec = tcoll.decompress_boundary(comp)
    assert rec.dtype == torch.bfloat16
    torch.testing.assert_close(rec.float(), acts.float(), atol=0.05, rtol=0)
    assert tcoll.decompress_boundary(acts) is acts
    again, wire_again = tcoll.tier_transfer(comp)       # a payload is not quantized twice
    assert again is comp and wire_again == wire_c


def test_error_feedback_reduces_bias(one_rank):
    """tests/test_collectives.py's 50 rounds through compressed_psum: the
    running sum with the residual carried tracks the true sum better than
    without, and stays within one round's residual of it."""
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=(256,)) * 0.01).float() for _ in range(50)]
    true = torch.stack(xs).sum(0)
    plain = torch.stack([tcoll.compressed_psum(x)[0] for x in xs]).sum(0)
    e, acc = torch.zeros(256), torch.zeros(256)
    for x in xs:
        total, e = tcoll.compressed_psum(x, error=e)
        acc += total
    err_ef, err_plain = (acc - true).abs(), (plain - true).abs()
    assert float(err_ef.max()) <= float(err_plain.max()) + 1e-6
    assert float(err_ef.mean()) < 0.5 * float(err_plain.mean())
    torch.testing.assert_close(acc + e, true, atol=1e-6, rtol=0)


def _rank_main(rank, world, store_path, out_path):
    """One gloo rank: compressed_psum of its own seeded x and residual."""
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=PG_TIMEOUT)
    try:
        g = torch.Generator().manual_seed(100 + rank)
        x = torch.randn((33, 70), generator=g) * (rank + 1)
        e = torch.randn((33, 70), generator=g) * 0.01
        total, new_error = tcoll.compressed_psum(x, error=e)
        torch.save({"x": x, "e": e, "total": total, "new_error": new_error}, out_path)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_gloo_ranks(tmp_path, world):
    """Every rank's total is the sum of every rank's dequantized codes (in
    bf16, as the plain composition gives them), bit for bit, and its residual
    its own."""
    ctx = mp.get_context("spawn")
    outs = [str(tmp_path / f"rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(tmp_path / "store"), outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"{len(hung)} of {world} ranks did not finish within {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * world
    res = [torch.load(o) for o in outs]
    rows = [_plain(r["x"], r["e"]) for r in res]
    want = _unflat(torch.stack([row for _, row in rows]).sum(0), res[0]["x"]).float()
    for r, (carry, row) in zip(res, rows):
        assert torch.equal(r["total"], want)
        assert torch.equal(r["new_error"], carry - _unflat(row, carry).float())
    exact = sum(r["x"] for r in res)
    assert float((want - exact).abs().max()) < 0.05 * float(exact.abs().max())


def test_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "import repro_torch.distributed.collectives, repro_torch.train.steps, "
            "repro_torch.launch.train; "
            "assert not [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
