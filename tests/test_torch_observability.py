"""The port's observability and live-dashboard utilities on the CPU:

- ``profile_trace`` writes a ``torch.profiler`` trace holding the ops run
  inside it;
- ``debug_flags`` switches anomaly detection, the float64 default and
  deterministic algorithms for a scope and restores them;
- ``checked_step`` passes finite steps through and raises
  ``NonFiniteState`` (step and time attached) on a NaN;
- ``LiveDashboard`` on a port's ``SimState``: the page and image of the
  JAX package's dashboard, every ``every`` frames.
"""
import glob
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu_torch.core.steppers import Clock, zero_clock  # noqa: E402
from juliaraytracingsw_tpu_torch.utils import observability as obs  # noqa: E402
from juliaraytracingsw_tpu_torch.utils.live import LiveDashboard  # noqa: E402


def test_profile_trace_writes_a_trace(tmp_path):
    with obs.profile_trace(str(tmp_path)) as prof:
        a = torch.ones(64, 64)
        (a @ a).sum()
    traces = glob.glob(os.path.join(str(tmp_path), "*.pt.trace.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.load(open(traces[0]))["traceEvents"]}
    assert "aten::mm" in names
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_debug_flags_scope_and_restore():
    before = (torch.is_anomaly_enabled(), torch.get_default_dtype(),
              torch.are_deterministic_algorithms_enabled())
    with obs.debug_flags(nan_debug=True, x64=True, deterministic=True):
        assert torch.is_anomaly_enabled() and torch.zeros(1).dtype == torch.float64
        assert torch.are_deterministic_algorithms_enabled()
    after = (torch.is_anomaly_enabled(), torch.get_default_dtype(),
             torch.are_deterministic_algorithms_enabled())
    assert after == before


def test_debug_flags_nan_debug_names_the_op():
    x = torch.tensor([-1.0], requires_grad=True)
    with obs.debug_flags(nan_debug=True):
        with pytest.raises(RuntimeError, match="SqrtBackward"):
            torch.sqrt(x).sum().backward()


def test_checked_step():
    def step(sol, clock, state):
        return sol * 2.0, Clock(clock.t + 0.5, clock.step + 1), state

    checked = obs.checked_step(step)
    sol, clock, _ = checked(torch.ones(2, dtype=torch.complex64), zero_clock(device="cpu"), ())
    assert clock.step == 1 and torch.equal(sol.real, torch.full((2,), 2.0))
    bad = torch.tensor([1.0, float("nan")], dtype=torch.complex64)
    with pytest.raises(obs.NonFiniteState, match="step 2") as exc:
        checked(bad, clock, ())
    assert exc.value.step == 2 and exc.value.t == 1.0
    assert isinstance(exc.value, FloatingPointError)


def test_live_dashboard_renders_a_port_state(tmp_path):
    pytest.importorskip("matplotlib")
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.coupled.driver import SimState
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets

    grid = make_grid(16, device="cpu")
    rng = np.random.default_rng(0)
    sim = SimState(sol=None, clock=Clock(torch.tensor(0.25), 7), stepper_state=(),
                   packets=lattice_packets(4, grid.Lx, grid.Ly, 5.0, device="cpu"),
                   fields=torch.as_tensor(rng.normal(size=(5, 16, 16)).astype(np.float32)))
    dash = LiveDashboard(str(tmp_path), title="rsw 16^2", every=2)
    series = {"kinetic_energy": [np.float32(1.0), np.float32(0.9)]}
    drawn = [dash.update(sim, grid, [0.1, 0.2], series) for _ in range(3)]
    assert drawn == [True, False, True]
    assert (tmp_path / "live.png").stat().st_size > 0
    html = (tmp_path / "live.html").read_text()
    assert "rsw 16^2 — step 7, t = 0.250" in html
