"""The rest of a run, with the timed path broken underneath, comes out
not correct: once for each fault a cell can have (its traffic kind's
``FAULTS``; a cell on one card has no exchange between chips to leave
out)."""
from __future__ import annotations

import pytest

from hapibench import bench, kinds, run

CASES = [(w["name"], f) for w in bench.benchmark()["workloads"]
         for f in kinds.of(bench.cell(w["name"]).traffic).FAULTS]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_makes_the_run_not_correct(cell, fault):
    c = bench.smoke(bench.cell(cell))
    line = run.run_cell(c, 2**31 + 23, 0.1, False, "cpu", fault=fault)
    assert not line["correct"], line["checks"]


def test_unknown_fault_is_refused():
    c = bench.smoke(bench.cell("nemo12b-pushdown-2x4k"))
    with pytest.raises(ValueError):
        run.run_cell(c, 1, 0.1, False, "cpu", fault="no-such-fault")
