"""What a run is asked to do, found by name: ``BENCHMARK.json`` at the
checkout's root, ``configs/<config>.json``, ``traffic/<traffic>.json``,
``workloads/<cell>.json`` and ``metrics/<metric>.py`` beside this file.
A cell, a configuration, a traffic mix or a metric is added by adding its
files and its entry in ``BENCHMARK.json``; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

__all__ = ["HERE", "ROOT", "load_benchmark", "Cell", "load_cell", "metrics_for", "reader"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


class Cell:
    """One cell: its ``BENCHMARK.json`` entry, its workload file (limits),
    its configuration and its traffic mix."""

    def __init__(self, entry: dict, workload: dict, config: dict, traffic: dict):
        self.entry, self.workload, self.config, self.traffic = entry, workload, config, traffic
        self.name = entry["name"]

    @property
    def limits(self) -> dict:
        return self.workload["limits"]

    @property
    def coupled(self) -> bool:
        return self.traffic["kind"] == "coupled"


def load_cell(name: str, bench: dict | None = None, here: Path = HERE) -> Cell:
    bench = load_benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(entries)}")
    entry = entries[name]
    workload = _json(here / "workloads" / f"{name}.json")
    config = _json(here / "configs" / f"{entry['config']}.json")
    traffic = _json(here / "traffic" / f"{entry['traffic']}.json")
    return Cell(entry, workload, config, traffic)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def metrics_for(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries this cell reports: those that
    list it, or that list no cells (a per-layer metric then goes with
    every cell reporting the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell, {m["name"]})]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, cell, names)]
    return e2e, per


def reader(name: str, here: Path = HERE):
    """``metrics/<name>.py``'s ``read(summary, cell) -> float | None``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
