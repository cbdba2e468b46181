"""Whole runs of every cell at a tiny size on the CPU (the kernels' plain
twins), past the harness's look for a card: sound runs come out correct,
runs with the timed path broken underneath do not, and nothing loads JAX
or the JAX package."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import reference
from portbench.check import judge
from portbench.control import readings
from portbench.run import FORBIDDEN, ROOT, run_cell
from portbench.spec import load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
SEED = 2_147_483_659


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, bench, tiny):
    result, checks = run_cell(tiny(name), bench, SEED, 0.3, False, device="cpu")
    assert result["correct"], checks
    assert list(result)[-1] == "checks"
    assert {"setup_s", "steps_per_s", "frame_ms_p95", "peak_mem_gib"} <= set(result["metrics"])
    assert result["attempted"] >= 5


@pytest.mark.parametrize("name", ["rsw512_rk4", "rsw512_adaptive"])
def test_a_traced_run_reads_its_layers(name, bench, tiny):
    result, _ = run_cell(tiny(name), bench, 17, 0.3, True, device="cpu")
    assert result["correct"]
    assert "step_mfu" in result["metrics"]
    assert result["device"]["window_s"] > 0 and set(result["breakdown"]) == {"device_ops",
                                                                            "idle_gaps"}


def _fault(kind):
    """Break the timed path underneath: the flow step returns its state
    unchanged; the ray step leaves half the packets where they were; the
    ray step alters one packet's wavenumber where it is produced."""
    from juliaraytracingsw_tpu_torch.models import base
    from juliaraytracingsw_tpu_torch.rays import raytrace

    if kind == "unchanged":
        make = base.STEPPERS["IFMAB3"]

        def broken(L, calcN, dt, filt=None):
            init, step = make(L, calcN, dt, filt)

            def same(sol, clock, state):
                return sol, step(sol, clock, state)[1], state
            return init, same
        return base.STEPPERS, "IFMAB3", broken
    orig = raytrace.table_substep

    def substep(T, st, scal, **kw):
        out = orig(T, st, scal, **kw).clone()
        if kind == "half":
            half = st.shape[1] // 2
            out[:, half:] = st[:4, half:]
        else:
            out[2, 0] *= 1.01
        return out
    return raytrace, "table_substep", substep


@pytest.mark.parametrize("name,kind", [("rsw512_rk4", "unchanged"), ("rsw512_rk4", "half"),
                                       ("rsw512_rk4", "altered"),
                                       ("twolayer2048_flow", "unchanged"),
                                       ("rsw512_adaptive", "unchanged"),
                                       ("rsw512_bd", "unchanged"), ("rsw512_bd", "half"),
                                       ("rsw512_bd", "altered")])
def test_a_broken_run_is_not_correct(name, kind, bench, tiny, monkeypatch):
    where, attr, broken = _fault(kind)
    if isinstance(where, dict):
        monkeypatch.setitem(where, attr, broken)
    else:
        monkeypatch.setattr(where, attr, broken)
    result, checks = run_cell(tiny(name), bench, 23, 0.3, False, device="cpu")
    assert not result["correct"], checks


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(name, tiny):
    cell = tiny(name)
    (row,) = readings(cell, [31], {31}, device="cpu")
    assert judge(row["program"], cell.limits), row
    assert not judge(row["control"], cell.limits), row
    assert reference.LOWER.table == "float8_e4m3fn" and reference.LOWER.arith == "bfloat16"


def test_no_jax_after_building_every_cell():
    code = (
        "import sys, copy\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "import portbench.run\n"
        "from conftest import tiny_cell\n"
        "from portbench.cells import Program\n"
        f"for name in {CELLS!r}:\n"
        "    c = tiny_cell(name)\n"
        "    p = Program(c.config, c.traffic, 1, 'cpu', log_fn=lambda l: None)\n"
        "    p.init(1)\n"
        "    p.frame()\n"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "juliaraytracingsw_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "rsw512_rk4",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size(cuda_device):
    from portbench.spec import load_cell

    cell = load_cell("rsw512_rk4")
    (row,) = readings(cell, [7], {7}, device=cuda_device)
    assert judge(row["program"], cell.limits), row
    assert not judge(row["control"], cell.limits), row
