"""Each cell at its configuration's and mix's smoke sizes on the CPU: the
whole run but the look for a card, the program's plain kernel versions in
float32 against the plain reference, held to the cell's own limits; the
control (the reference in float8 in the program's place) fails them."""
from __future__ import annotations

import pytest

from hapibench import bench, check, kinds, run

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]
SEED = 2**31 + 11


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_at_smoke_size_agrees_with_the_reference(cell, trace):
    c = bench.smoke(bench.cell(cell))
    line = run.run_cell(c, SEED, 0.2, trace, "cpu")
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] >= 1 and line["failed"] == 0
    want = c.per_layer if trace else c.end_to_end
    if trace:
        # On the CPU the trace holds no device operation: no roofline.
        assert set(line["metrics"]) <= {m["name"] for m in want}
        assert "breakdown" in line and line["device"]["window_s"] > 0
    else:
        assert set(line["metrics"]) == {m["name"] for m in want}
    # The program's float32 smoke path is the reference's arithmetic to
    # rounding: codes within half a step, the loss to 1e-5.
    numbers = {k: v["value"] for k, v in line["checks"].items()}
    assert numbers["code_gap"] <= 0.5 + 1e-3
    if "loss_gap" in numbers:
        assert numbers["loss_gap"] < 1e-5


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limits(cell):
    c = bench.smoke(bench.cell(cell))
    ok, shown = check.verdict(kinds.of(c.traffic).control(c, SEED, "cpu"), c.limits["limits"])
    assert not ok, shown


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_work(cell):
    from hapibench import traffic as T
    c = bench.cell(cell)
    a = T.tokens(dict(c.traffic, seq=16), 1000, 2**31 + 5)
    b = T.tokens(dict(c.traffic, seq=16), 1000, 2**31 + 5)
    other = T.tokens(dict(c.traffic, seq=16), 1000, 2**31 + 6)
    assert (a == b).all() and a.shape == other.shape and not (a == other).all()
    assert len({r.tobytes() for r in a}) == len(a), "rows must all differ"
