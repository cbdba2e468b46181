"""The plain reference agrees with the port on the CPU at a tiny size
(where the port runs its kernels' plain twins), and imports nothing of
the port or of JAX."""
from __future__ import annotations

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import reference
from portbench.reference.flow import Flow, grid
from portbench.reference.rays import Rays

REF_DIR = Path(reference.__file__).parent
N = 32
BILINEAR = reference.find("interp", "bilinear")


def _program(cfg):
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.coupled.driver import derive_nu
    from juliaraytracingsw_tpu_torch.models import rsw, twolayerqg
    from juliaraytracingsw_tpu_torch.models.base import build_stepper

    g = make_grid(N, device="cpu")
    fl, dt = cfg["flow"], cfg["dt"]
    nu = derive_nu(1.0, N, fl["nnu"], dt)
    if fl["model"] == "rsw":
        model = rsw.make_model(g, nu=nu, nnu=fl["nnu"], f=fl["f"], Cg=fl["Cg"])
    else:
        model = twolayerqg.make_model(g, U=fl["U"], mu=fl["mu"], nu=nu, nnu=fl["nnu"],
                                      f0=fl["f"], Cg=fl["Cg"], drho_rho0=fl["drho_rho0"])
    return g, model, build_stepper(model, "IFMAB3", dt), nu


@pytest.mark.parametrize("config", ["rsw512_hero", "twolayer2048"])
def test_flow_steps_agree(config, tiny):
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock

    from portbench.inputs import initial_flow

    cell = tiny("rsw512_rk4" if config == "rsw512_hero" else "twolayer2048_flow", nx=N)
    cfg = cell.config
    g, model, (init, step), nu = _program(cfg)
    ref = Flow(cfg, "cpu", cfg["dt"], nu)
    sol = initial_flow(cfg, 5, "cpu")
    s_p, clock, state = sol, zero_clock(device="cpu"), init(sol)
    s_r, N1, N2 = sol, torch.zeros_like(sol), torch.zeros_like(sol)
    for i in range(8):
        s_p, clock, state = step(s_p, clock, state)
        s_r, N1, N2 = ref.step(s_r, i, N1, N2, reference.NOMINAL)
    change = float((s_r - sol).abs().max())
    assert change > 0
    assert float((s_p - s_r).abs().max()) <= 1e-5 * change
    torch.testing.assert_close(state[0], N1, rtol=1e-5, atol=1e-6 * float(N1.abs().max()))


def _tables_and_packets(method):
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.rays.raytrace import RayParams, build_pair

    g = make_grid(N, device="cpu")
    rng = np.random.default_rng(3)
    fo, fn = (torch.as_tensor(rng.standard_normal((5, N, N)), dtype=torch.float32)
              for _ in range(2))
    rp = RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]), dx=g.dx, dy=g.dy,
                   table_dtype="bfloat16")
    n = 200
    st = torch.as_tensor(np.stack([
        rng.uniform(-4, 4, n), rng.uniform(-4, 4, n), rng.uniform(-8, 8, n),
        rng.uniform(-8, 8, n), np.where(np.arange(n) % 2, 1.0, -1.0)]), dtype=torch.float32)
    return g, fo, fn, rp, build_pair(fo, fn, rp), st


def test_rk4_substep_agrees():
    from juliaraytracingsw_tpu_torch.ops.ray_step import table_substep

    g, fo, fn, rp, T, st = _tables_and_packets("rk4")
    h = 1e-2
    out = table_substep(T, st, torch.tensor([0.0, h]), rp=rp, interp="bilinear", da=1.0,
                        ny=N, nx=N)
    rays = Rays(grid(N, 2 * math.pi, "cpu"), 3.0, 1.0, reference.NOMINAL, BILINEAR)
    ref = rays.rk4(st, rays.tables(fo), rays.tables(fn), torch.tensor(0.0), torch.tensor(h))
    torch.testing.assert_close(out, ref[:4], rtol=1e-5, atol=1e-5)
    assert float((ref[:4] - st[:4]).abs().max()) > 1e-3


def test_dp54_attempt_agrees():
    from juliaraytracingsw_tpu_torch.ops.ray_step import table_attempt

    g, fo, fn, rp, T, st = _tables_and_packets("dp5")
    h = 2e-2
    out = table_attempt(T, st, torch.tensor([0.0, 1.0, h, 1e-3, 1e-6]), rp=rp,
                        interp="bilinear", ny=N, nx=N)
    rays = Rays(grid(N, 2 * math.pi, "cpu"), 3.0, 1.0, reference.NOMINAL, BILINEAR)
    ref, esum = rays.attempt(st, rays.tables(fo), rays.tables(fn), 0.0, 1.0,
                             torch.tensor(h), 1e-3, 1e-6)
    torch.testing.assert_close(out[:4], ref[:4], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out[4], esum, rtol=1e-3, atol=1e-3 * float(esum.max()))
    assert float(esum.max()) > 0


def test_reference_imports_nothing_of_the_program():
    for path in REF_DIR.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".", 1)[0]
                assert top not in {"juliaraytracingsw_tpu_torch", "juliaraytracingsw_tpu",
                                   "jax", "jaxlib", "flax"}, (path.name, name)
