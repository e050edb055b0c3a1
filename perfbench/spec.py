"""``BENCHMARK.json`` and the files it names, found by name."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"unknown workload {name!r}; cells: "
                     f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file as it is run, with its entry's ``name``."""
    for c in bench["configs"]:
        if c["name"] == name:
            return dict(_read_json(root / c["file"]), name=name)
    raise SystemExit(f"unknown config {name!r}")


def traffic(name: str) -> dict:
    return dict(_read_json(HERE / "traffic" / f"{name}.json"), name=name)


def limits(cell_name: str) -> dict:
    """The limits of the cell's correctness check, ``checks/<cell>.json``."""
    return _read_json(HERE / "checks" / f"{cell_name}.json")["limits"]


def driver(name: str):
    return importlib.import_module(f"perfbench.drivers.{name}")


def reader(metric: str) -> Callable[[dict], Optional[float]]:
    """``metrics/<metric>.py``'s ``read``; a metric's name may hold dots,
    so the file is loaded by its path."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on; a metric with a
    ``workloads`` key only in the cells it lists."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if cell_name in m.get("workloads", [cell_name])]


def read_metrics(bench: dict, cell_name: str, trace: bool,
                 record: dict) -> Dict[str, dict]:
    """Each metric's reading, ``{"value", "unit"}``; one whose reader finds
    nothing is left out."""
    out = {}
    for m in metrics_of(bench, cell_name, trace):
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
