"""BENCHMARK.json against the contract it is written to, and the files it
names found by name: configurations, traffic mixes, limits and each
per-layer metric's reader."""
from __future__ import annotations

import dataclasses
import re

import pytest

from hapibench import bench, families, kinds
from hapibench.readings import Readings
from hapibench.trace import Trace

BENCH = bench.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "hapibench/run.py"]
    assert BENCH["paths"] == ["hapibench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (bench.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_keys():
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in E2E
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    c = bench.cell(cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer and c.chips == 1
    for m in c.per_layer:
        assert m["moves"] in names, (m["name"], m["moves"])
    assert c.limits["limits"], "a cell without limits cannot be correct"


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configuration_file_matches_the_program_registry_but_for_reduced_keys(entry):
    from repro_torch.configs import get_config
    conf = bench.load_json(bench.ROOT / entry["file"])
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert sorted(conf["reduced"]) == sorted(entry["reduced"])
    registry = dataclasses.asdict(get_config(conf["model"]["name"]))
    changed = {k for k, v in conf["model"].items() if registry[k] != v}
    # The file holds the published values; where the program's registry
    # holds another, the file says so under registry_differs.
    assert changed <= set(entry["reduced"]) | set(conf["registry_differs"]), changed
    assert not set(entry["reduced"]) & set(conf["registry_differs"])
    assert 0 < conf["split"] < conf["model"]["n_layers"]


@pytest.mark.parametrize("cell", CELLS)
def test_files_are_found_by_name(cell):
    c = bench.cell(cell)
    assert callable(kinds.of(c.traffic).run) and kinds.of(c.traffic).FAULTS
    assert families.of(c.config).KERNELS["forward"]
    for m in c.per_layer:
        assert callable(bench.reader(m["name"]))
    small = bench.smoke(c)
    assert small.config["model"]["d_model"] < c.config["model"]["d_model"]
    assert small.traffic["seq"] < c.traffic["seq"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        bench.cell("no-such-cell")


def _readings(kind):
    trace = Trace(window_s=2.0, busy_s=1.5, family_s={"flash": 0.5, "int8": 0.1},
                  family_names={}, device_ops=[], idle_gaps=[], n_device_events=10)
    return Readings(kind, 10.0, 5, 5 * 1.978e14, {"data": [0.001, 0.003], "extract": [0.1],
                                                   "adamw": [0.05], "copy_out": [0.004]},
                    trace=trace, bounds={"flash": 0.2, "int8": 0.08})


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_reader_reads_its_own_kind_and_nothing_else(metric):
    kind = metric["name"].rsplit(".", 1)[1]
    other = "pushdown" if kind == "train" else "train"
    read = bench.reader(metric["name"])
    assert read(_readings(other)) is None
    value = read(_readings(kind))
    if metric["name"].startswith("ssd_roofline"):
        assert value is None         # no SSD launch in these readings
    else:
        assert value is not None and value > 0


def test_reader_arithmetic():
    r = _readings("train")
    got = {m["name"]: bench.reader(m["name"])(r) for m in BENCH["per_layer"]}
    assert got["data_wait_ms.train"] == pytest.approx(0.8)      # 4 ms over 5 steps
    assert got["step_mfu.train"] == pytest.approx(10.0)
    assert got["flash_roofline.train"] == pytest.approx(40.0)
    assert got["int8_roofline.train"] == pytest.approx(80.0)
    assert got["idle_share.train"] == pytest.approx(25.0)
