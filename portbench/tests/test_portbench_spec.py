"""The benchmark's files load, and a cell, a configuration, a traffic mix
or a per-layer metric added as files alone is found by name."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from portbench import reference, spec

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


# --- the command line and the reference's parts, found by name ---------------

_RSW = ["rsw", "--nx", "512", "--L", "6.283185307179586", "--cfltune", "0.16297466172610084",
        "--umax-estimate", "2.0", "--nutune", "1.0", "--nnu", "4", "--stepper", "IFMAB3",
        "--seed", "2147483659", "--platform", "cuda"]
_RSW_IC = ["--cg", "1.0", "--f-over-cg", "3.0", "--Kg", "10.0", "13.0", "--Kw", "0.0", "5.0",
           "--ag", "0.5", "--aw", "0.05"]
_TWO = ["twolayer", "--nx", "2048", "--L", "6.283185307179586", "--cfltune", "0.1",
        "--umax-estimate", "2.0", "--nutune", "1.0", "--nnu", "4", "--stepper", "IFMAB3",
        "--seed", "2147483659", "--platform", "cuda"]
_TWO_IC = ["--cg", "1.0", "--f", "3.0", "--U", "0.2", "--mu", "0.5", "--drho-rho0", "0.2",
           "--Kg", "2.0", "6.0", "--ag", "0.01"]
_RAYS = ["--omega0-over-f", "2.0", "--interp", "bilinear"]
_RK4 = ["--gather", "auto", "--ray-method", "rk4", "--ray-substeps", "1"]
# each cell's command line, pinned word for word: the model's part, then
# the configuration's flags (rsw512_bd's alone has any)
ARGV = {
    "rsw512_rk4": _RSW + ["--sqrt-npackets", "1024", *_RAYS, "--table-dtype", "bfloat16",
                          *_RK4, *_RSW_IC],
    "twolayer2048_flow": _TWO + ["--sqrt-npackets", "16", *_RAYS, "--table-dtype", "bfloat16",
                                 *_RK4, *_TWO_IC],
    "rsw512_adaptive": _RSW + ["--sqrt-npackets", "1024", *_RAYS, "--table-dtype", "bfloat16",
                               "--gather", "auto", "--ray-method", "adaptive",
                               "--ray-substeps", "1", "--ray-rtol", "0.001", "--ray-atol",
                               "1e-06", "--ray-max-steps", "16", *_RSW_IC],
    "twolayer2048_taps": _TWO + ["--sqrt-npackets", "512", *_RAYS, "--table-dtype", "float32",
                                 *_RK4, *_TWO_IC],
    "rsw512_spinup": _RSW + ["--sqrt-npackets", "1024", *_RAYS, "--table-dtype", "bfloat16",
                             *_RK4, *_RSW_IC],
    "rsw512_bd": _RSW + ["--sqrt-npackets", "512", *_RAYS, "--table-dtype", "bfloat16", *_RK4,
                         *_RSW_IC, "--birth-death", "--bd-k-shape", "1.5", "--bd-lam", "10.0"],
}


@pytest.mark.parametrize("name", sorted(ARGV))
def test_each_cells_command_line_is_pinned(name, bench):
    from portbench.cells import argv

    cell = spec.load_cell(name, bench)
    assert argv(cell.config, cell.traffic, 2_147_483_659, "cuda") == ARGV[name]


def test_the_flags_parse_as_the_port_parses_them(bench):
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli

    from portbench.cells import argv

    cell = spec.load_cell("rsw512_bd", bench)
    args = cli.build_parser().parse_args(argv(cell.config, cell.traffic, 5, "cpu"))
    event = reference.find("events", "weibull_birth_death")
    assert args.birth_death and (args.bd_k_shape, args.bd_lam) == event.params(cell.config)
    assert args.seed == 5


def _toy_parts(here):
    (here / "interp").mkdir(parents=True)
    (here / "events").mkdir()
    (here / "interp" / "toy.py").write_text(
        "def table(fields, g, p):\n    return fields\n\n\n"
        "def sampler(Fo, Fn, bx, by, g, p):\n    return None\n")
    (here / "events" / "toy_event.py").write_text(
        "def follow(cfg, g, p, snap):\n    return lambda st, amb, t0, t1: st\n")


def test_a_toy_interpolant_and_event_are_found_by_name(tmp_path):
    from portbench import reference
    from portbench.check import reference_parts

    _toy_parts(tmp_path)
    cfg = {"rays": {"interp": "toy", "events": ["toy_event"]}}
    interp, events = reference_parts(cfg, tmp_path)
    assert interp.table("f", None, None) == "f"
    assert [name for name, _ in events] == ["toy_event"]
    assert events[0][1].follow(cfg, None, None, None)("st", None, 0, 1) == "st"
    assert reference.find("interp", "toy", tmp_path) is not None
    # a configuration that lists no events gets the k-cutoff reset
    _, events = reference_parts({"rays": {"interp": "bilinear"}})
    assert [name for name, _ in events] == ["k_cutoff_reset"]


@pytest.mark.parametrize("kind", ["interp", "events"])
def test_an_unknown_part_stops_the_run(kind, bench):
    from portbench.run import run_cell

    cell = spec.load_cell("rsw512_rk4", bench)
    cfg = json.loads(json.dumps(cell.config))
    if kind == "interp":
        cfg["rays"]["interp"] = "no_such_interpolant"
    else:
        cfg["rays"]["events"] = ["k_cutoff_reset", "no_such_event"]
    with pytest.raises(SystemExit, match="no_such_"):
        run_cell(spec.Cell(cell.entry, cell.workload, cfg, cell.traffic), bench, 1, 0.1, False,
                 device="cpu")


def test_a_bicubic_configuration_needs_only_files(bench, tmp_path):
    """A configuration, a workload and ``reference/interp/bicubic.py``,
    added as files to a copy of the benchmark, are all it takes: the cell
    loads, its command line names the interpolant and the reference finds
    it. No harness module names an interpolant outside the byte tables,
    nor an event but the default reset."""
    import ast

    from portbench.cells import argv
    from portbench.check import reference_parts

    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((here / "configs" / "rsw512_hero.json").read_text())
    cfg["name"], cfg["rays"]["interp"] = "rsw512_bicubic", "bicubic"
    cfg["work"]["ray_flops_per_packet"] = 2000.0
    (here / "configs" / "rsw512_bicubic.json").write_text(json.dumps(cfg))
    (here / "workloads" / "rsw512_bicubic.json").write_text(json.dumps(
        {"name": "rsw512_bicubic", "config": "rsw512_bicubic", "traffic": "rk4_frames5",
         "chips": 1, "why": "a test", "limits": {"start_gap": 1e-3, "sol_gap": 1e-3}}))
    (here / "reference" / "interp" / "bicubic.py").write_text(
        (here / "reference" / "interp" / "bilinear.py").read_text())
    bench = dict(bench, workloads=bench["workloads"] + [
        {"name": "rsw512_bicubic", "config": "rsw512_bicubic", "traffic": "rk4_frames5",
         "chips": 1, "why": "a test"}])
    cell = spec.load_cell("rsw512_bicubic", bench, here)
    words = argv(cell.config, cell.traffic, 1, "cuda")
    assert words[words.index("--interp") + 1] == "bicubic"
    interp, _ = reference_parts(cell.config, here / "reference")
    assert callable(interp.sampler) and callable(interp.table)

    interps = {p.stem for p in (here / "reference" / "interp").glob("*.py")}
    events = {p.stem for p in (here / "reference" / "events").glob("*.py")}
    allowed = {"roofline.py": interps, "ray_taps_roofline.py": interps,
               "check.py": {"k_cutoff_reset"}}
    for path in spec.HERE.rglob("*.py"):
        rel = path.relative_to(spec.HERE).parts
        if rel[0] == "tests" or rel[:2] in (("reference", "interp"), ("reference", "events")):
            continue
        named = {n.value for n in ast.walk(ast.parse(path.read_text()))
                 if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        assert named & (interps | events) <= allowed.get(path.name, set()), path
