"""What ``BENCHMARK.json`` names, found by name: a cell's configuration
(``configs/<config>.json``), its traffic mix (``traffic/<mix>.json``), the
limits of its correctness check (``limits/<cell>.json``), its metrics and
each per-layer metric's reader (``metrics/<metric>.py``, a function
``read(readings)`` that returns a number or None).

A later cell, configuration, mix or metric is a new file and a new entry;
no file here changes for it.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: Optional[dict] = None) -> Cell:
    """The cell ``name`` of ``bench`` (BENCHMARK.json by default), with its
    files read and the metrics it reports."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(name=name, chips=entry["chips"], config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str) -> Callable:
    """``read`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "hapibench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def smoke(c: Cell) -> Cell:
    """``c`` at the small sizes its configuration and mix give under
    ``smoke``, for the CPU tests."""
    config = json.loads(json.dumps(c.config))
    over = dict(config.pop("smoke"))
    config["split"] = over.pop("split")
    config["model"].update(over)
    traffic = dict(c.traffic, **c.traffic["smoke"])
    return dataclasses.replace(c, config=config, traffic=traffic)


def read_all(metrics: List[dict], readings) -> Dict[str, dict]:
    """Each metric's reading, those whose reader finds nothing left out."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
