"""Find a cell's parts by name: its configuration, its traffic mix and the
metrics it reports. Everything is data under ``BENCHMARK.json`` and
``benchmark/``: a new cell is a new ``workloads`` entry and new files."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ["ROOT", "HERE", "Cell", "load", "metric_reader", "reference_class"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]   # the end-to-end metrics this cell reports
    per_layer: list[dict]    # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, bench_file: Path | None = None) -> Cell:
    bench = json.loads((bench_file or ROOT / "BENCHMARK.json").read_text())
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"there are {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if m["moves"] in reported and _reports(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """``read(trace)`` of ``metrics/<name>.py``."""
    return _module(HERE / "metrics" / f"{name}.py",
                   "benchmark_metric_" + name.replace(".", "_")).read


def reference_class(config: dict):
    """The ``Reference`` class of the configuration's plain reference."""
    mod = importlib.import_module(f"benchmark.reference.{config['reference']}")
    return mod.Reference

