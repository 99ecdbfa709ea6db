"""The benchmark's arithmetic against numbers worked out by hand: model
FLOPs of each cell, kernel bounds at the cells' shapes, and the launches a
step or a POST makes."""
from __future__ import annotations

import pytest

from hapibench import bench, families, kinds, launches, work

NEMO = bench.cell("nemo12b-train-4x4k")
MAMBA = bench.cell("mamba2-train-4x4k")
PUSH = bench.cell("nemo12b-pushdown-2x4k")


def step_flops(cell, split, rows, seq):
    config = dict(cell.config, split=split)
    return kinds.of(cell.traffic).unit_flops(config, dict(cell.traffic, rows=rows, seq=seq))


def test_block_parameters():
    # mistral-nemo: q 5120 x 4096, k and v 5120 x 1024 each, o 4096 x 5120,
    # the SwiGLU's three 5120 x 14336.
    assert families.of(NEMO.config).block_matmul_params(NEMO.config["model"]) == \
        20_971_520 + 2 * 5_242_880 + 20_971_520 + 3 * 73_400_320
    # mamba2: in-projection 2048 x (2 * 4096 + 2 * 128 + 64), out 4096 x 2048.
    assert families.of(MAMBA.config).block_matmul_params(MAMBA.config["model"]) == \
        2048 * 8512 + 4096 * 2048


def test_nemo_train_step_flops():
    f = step_flops(NEMO, 6, 4, 4096)
    n, t = 272_629_760, 16_384
    assert f["frozen"] == pytest.approx(2 * 6 * n * t)          # 5.36e13
    assert f["trainable"] == pytest.approx(6 * 2 * n * t)       # 5.36e13
    assert f["head"] == pytest.approx(6 * 131_072 * 5120 * t)   # 6.60e13
    pairs = 4 * 4096 * 4097 // 2
    assert f["mixer"] == pytest.approx((6 * 4 + 2 * 14) * 128 * 32 * pairs)   # 7.2e12
    assert sum(f.values()) == pytest.approx(1.80e14, rel=0.01)


def test_mamba2_train_step_flops():
    f = step_flops(MAMBA, 36, 4, 4096)
    n, t = 25_821_184, 16_384
    assert f["frozen"] == pytest.approx(2 * 36 * n * t)
    assert f["trainable"] == pytest.approx(6 * 12 * n * t)
    assert f["head"] == pytest.approx(6 * 50_277 * 2048 * t)
    # SSD forward a chunk and row: 2 tri N + H (2 tri P + 4 Q N P), tri =
    # 256 * 257 / 2; 16 chunks, 4 rows.
    tri = 32_896
    fwd = 2 * tri * 128 + 64 * (2 * tri * 64 + 4 * 256 * 128 * 64)
    bwd = 2 * tri * 128 + 64 * (2 * tri * (2 * 64 + 2 * 128) + 10 * 256 * 128 * 64)
    assert f["mixer"] == pytest.approx(64 * (36 * fwd + 12 * (fwd + bwd)))
    assert sum(f.values()) == pytest.approx(7.6e13, rel=0.02)


def test_pushdown_flops():
    f = step_flops(PUSH, 6, 2, 4096)
    assert sum(f.values()) == pytest.approx(2.85e13, rel=0.01)


def test_kernel_bounds_at_the_cells_shapes():
    c, tr = NEMO.config, NEMO.traffic
    pairs = 4096 * 4097 // 2
    # Flash forward at (2, 4096, 32 heads, 8 KV heads, 128): operations bound.
    assert launches.launch_bound_s(c, tr, "flash_attention") == \
        pytest.approx(4 * 128 * 2 * 32 * pairs / 989e12)        # 0.278 ms
    assert launches.launch_bound_s(c, tr, "flash_attention_bwd") == \
        pytest.approx(10 * 128 * 2 * 32 * pairs / 989e12)       # 0.695 ms
    n = 2 * 4096 * 5120
    # Quantize: bf16 read, int8 and a scale every 128 lanes written; bytes bound.
    assert launches.launch_bound_s(c, tr, "quantize_int8") == \
        pytest.approx((3 * n + n // 128 * 4) / 3.35e12)         # 0.038 ms
    m = MAMBA.config
    b, s, h, p, nn = 2, 4096, 64, 64, 128
    nbytes = (b * s * h * p + 2 * b * s * nn) * 2 + 2 * b * s * h * 4 \
        + (b * s * h * p + b * h * nn * p) * 4
    assert launches.launch_bound_s(m, MAMBA.traffic, "ssd_scan") == \
        pytest.approx(nbytes / 3.35e12)


def test_bound_is_the_larger_term():
    assert work.bound_s((3.35e12, 1.0), 989e12) == pytest.approx(1.0)
    assert work.bound_s((1.0, 989e12), 989e12) == pytest.approx(1.0)


@pytest.mark.parametrize("cell,want", [
    # chip_smoke.TRAIN_LAUNCHES, worked out by hand there.
    ("nemo12b-train-4x4k", {"flash_attention": 20, "flash_attention_bwd": 4,
                            "quantize_int8": 2, "dequantize_int8": 2}),
    ("mamba2-train-4x4k", {"ssd_scan": 120, "ssd_scan_bwd": 24, "quantize_int8": 2,
                           "dequantize_int8": 2}),
    ("nemo12b-pushdown-2x4k", {"flash_attention": 6, "quantize_int8": 1}),
    ("mamba2-pushdown-2x4k", {"ssd_scan": 36, "quantize_int8": 1}),
])
def test_launches_a_unit(cell, want):
    c = bench.cell(cell)
    assert launches.per_unit(c.config, c.traffic) == want
    assert launches.expected(c.config, c.traffic, 3) == {k: 3 * v for k, v in want.items()}


def test_family_bounds_sum_over_launches():
    c, tr = NEMO.config, NEMO.traffic
    got = launches.bounds(c, tr, {"flash_attention": 20, "flash_attention_bwd": 4,
                                  "quantize_int8": 2, "dequantize_int8": 0})
    one = launches.launch_bound_s
    assert got["flash"] == pytest.approx(20 * one(c, tr, "flash_attention")
                                         + 4 * one(c, tr, "flash_attention_bwd"))
    assert got["int8"] == pytest.approx(2 * one(c, tr, "quantize_int8"))
