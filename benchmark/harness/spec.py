"""What a cell is made of, found by name from `BENCHMARK.json`: the cell's
configuration (`configs/<config>.json`), traffic mix
(`traffic/<traffic>.json`) and limits (`limits/<cell>.json`), the reader of
each per-layer metric (`metrics/<metric>.py`) and the operation count of
each kernel (`counts/<kernel>.py`). A new cell, configuration, mix, metric
or count is a new file; nothing here changes."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str


def _json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = HERE) -> Cell:
    """The cell `name` of the BENCHMARK.json beside `root` (the
    benchmark's directory), with its files read."""
    bj = _json(os.path.join(os.path.dirname(root), "BENCHMARK.json"))
    cells = {w["name"]: w for w in bj["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(os.path.join(root, "configs", w["config"] + ".json")),
        traffic=_json(os.path.join(root, "traffic", w["traffic"] + ".json")),
        limits=_json(os.path.join(root, "limits", name + ".json")),
        end_to_end=[m for m in bj["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bj["per_layer"] if _applies(m, name)],
        root=root)


def _module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_{tag}_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: str = HERE):
    """`read(record) -> value or None` of per-layer metric `name`."""
    return _module(os.path.join(root, "metrics", name + ".py"), "metric").read


def count(name: str, root: str = HERE):
    """The operation and byte count module of kernel or step `name`."""
    return _module(os.path.join(root, "counts", name + ".py"), "count")


def read_per_layer(cell: Cell, record: dict) -> Dict[str, dict]:
    """{metric: {"value", "unit"}} of the cell's per-layer metrics that
    found something to read."""
    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"], cell.root)(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
