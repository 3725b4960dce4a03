"""A cell as `BENCHMARK.json` and the files under `torch_bench/` define it:
its configuration (`configs/<config>.json` and the plain reference beside
it, `configs/<config>.py`), its traffic mix (`traffic/<mix>.json`), the
limits of its comparison (`limits/<cell>.json`) and the metrics it
reports, each read by `metrics/<name>.py` or, failing that, by the reader
of the part of its name before the first dot."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    config: dict
    reference: object  # the configuration's plain reference module
    mix: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list
    chips: int


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def make(name: str, config: str, traffic: str, chips: int = 1, bench: dict | None = None) -> Cell:
    """The cell `name` of configuration `config` under mix `traffic`, with
    the metrics BENCHMARK.json gives it (none, for a cell it does not
    hold)."""
    bench = bench or benchmark()
    ref = _module(os.path.join(HERE, "configs", f"{config}.py"), f"reference_{config}")
    return Cell(name, _json("configs", f"{config}.json"), ref, _json("traffic", f"{traffic}.json"),
                _json("limits", f"{name}.json"),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)], int(chips))


def load(name: str) -> Cell:
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    return make(name, w["config"], w["traffic"], w["chips"], bench)


def reader(metric: str):
    """(the reader module of `metric`, the part of the name after the reader's)."""
    for stem in (metric, metric.split(".", 1)[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return _module(path, f"metric_{stem.replace('.', '_')}"), metric[len(stem) + 1:]
    raise SystemExit(f"no reader for metric {metric!r} under torch_bench/metrics/")
