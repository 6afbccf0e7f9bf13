"""The benchmark's description: ``BENCHMARK.json`` at the root of the
checkout, and the files it names, found by name: a configuration in
``configs/<config>.json``, a traffic mix in ``traffic/<traffic>.json``, a
per-layer metric's reader in ``metrics/<metric>.py``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # the benchmark's folder
ROOT = HERE.parent                                  # the checkout


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    end_to_end: list      # the entries of BENCHMARK.json that this cell reports
    per_layer: list


def dtype_name(config: dict) -> str:
    """The configuration's precision, "float64" unless its ``f64`` is false
    (the program's default, driver/standalone.py::mmf_setup_kwargs)."""
    return "float64" if config["run"].get("f64", True) else "float32"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, bench: dict = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its configuration and
    traffic files loaded; raises KeyError for a name it does not hold."""
    bench = bench or benchmark()
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it holds "
                       f"{sorted(w['name'] for w in bench['workloads'])}")
    return Cell(name=name, chips=int(entry["chips"]),
                config=load_json(HERE / "configs" / f"{entry['config']}.json"),
                traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def reader(metric: str):
    """The ``read(readings)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
