"""The benchmark's files load, and a cell, a configuration, a traffic mix
or a per-layer metric added as files alone is found by name."""
from __future__ import annotations

import json
import re
import shutil

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_loads(bench):
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench)
        assert cell.config["name"] == w["config"]
        assert cell.workload["config"] == w["config"] and cell.workload["chips"] == w["chips"]
        assert set(cell.limits) >= {"start_gap", "sol_gap"}
        lo, hi = cell.traffic["check_frames"]
        assert 0 <= lo < hi < cell.traffic["trace_frames"]


def test_names_and_files(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [m["name"] for m in bench[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert spec.ROOT.joinpath(c["file"]).is_file()
        assert json.loads(spec.ROOT.joinpath(c["file"]).read_text())["reduced"] == c["reduced"]
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_every_cell_reports_setup_another_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e, per = spec.metrics_for(bench, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and per


def test_a_cell_and_a_metric_added_as_files(bench, tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((here / "configs" / "rsw512_hero.json").read_text())
    cfg.update(name="rsw256_new", nx=256)
    (here / "configs" / "rsw256_new.json").write_text(json.dumps(cfg))
    (here / "traffic" / "rk4_frames10.json").write_text(json.dumps(
        dict(json.loads((here / "traffic" / "rk4_frames5.json").read_text()),
             steps_per_frame=10)))
    (here / "workloads" / "rsw256_rk4.json").write_text(json.dumps(
        {"name": "rsw256_rk4", "config": "rsw256_new", "traffic": "rk4_frames10", "chips": 1,
         "why": "a test", "limits": {"start_gap": 1.0, "sol_gap": 1.0}}))
    (here / "metrics" / "new.count.py").write_text(
        "def read(summary, cell):\n    return float(summary['steps'])\n")
    bench = dict(bench)
    bench["workloads"] = bench["workloads"] + [
        {"name": "rsw256_rk4", "config": "rsw256_new", "traffic": "rk4_frames10", "chips": 1,
         "why": "a test"}]
    bench["per_layer"] = bench["per_layer"] + [
        {"name": "new.count", "unit": "steps", "better": "higher", "source": "host_clock",
         "layer": "whole step", "moves": "steps_per_s", "workloads": ["rsw256_rk4"]}]
    cell = spec.load_cell("rsw256_rk4", bench, here)
    assert cell.config["nx"] == 256 and cell.traffic["steps_per_frame"] == 10
    _, per = spec.metrics_for(bench, "rsw256_rk4")
    assert "new.count" in {m["name"] for m in per}
    assert "new.count" not in {m["name"] for m in spec.metrics_for(bench, "rsw512_rk4")[1]}
    assert spec.reader("new.count", here)({"steps": 7}, cell) == 7.0
