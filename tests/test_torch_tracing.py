"""The port's stage spans and host-wait counts on the CPU, on the command
line's RSW case at 32^2 with 256 packets on the patch path:

- ``span`` is one shared null context, recording nothing, when no
  profiler runs;
- under ``torch.profiler`` an RK4 coupled frame, an adaptive ('while')
  frame and a flow-only chunk emit their stage spans with the nesting the
  driver documents, and each host wait its ``wait.<site>`` span;
- ``observability.waits`` counts every blocking call once, by site, with
  or without a profiler: a coupled frame's guard, diagnostics and log
  scalars are one wait, at ``driver.frame_tail``;
- a frame's state is bit-equal with and without a profiler running.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from juliaraytracingsw_tpu_torch.experiments import __main__ as cli  # noqa: E402
from juliaraytracingsw_tpu_torch.utils import observability as obs  # noqa: E402


def _quiet(_line):
    pass


def _driver(ray_method="rk4", **kw):
    """The command line's RSW case, initialised; the adaptive one in the
    'while' loop from one substep, as the benchmark runs it."""
    args = cli.build_parser().parse_args(
        ["rsw", "--nx", "32", "--sqrt-npackets", "16", "--gather", "patch",
         "--ray-method", ray_method, "--platform", "cpu"])
    case = cli.SETUPS["rsw"](args, _quiet)
    drv = cli.make_driver(args, case, log_fn=_quiet, **kw)
    if ray_method == "adaptive":
        drv.ray_opts.update(loop="while", init_substeps=1)
    drv.init(case.sol0, case.packets)
    return drv


def _spans(prof):
    """{(span, innermost enclosing span or None): count} of a profile."""
    spans = sorted((e.time_range.start, -e.time_range.end, e.name) for e in prof.events()
                   if e.is_user_annotation and e.device_type.name == "CPU")
    out, stack = {}, []
    for s, neg_e, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        key = (name, stack[-1][0] if stack else None)
        out[key] = out.get(key, 0) + 1
        stack.append((name, -neg_e))
    return out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


class _Writer:
    """Keeps what a ``SequencedWriter`` would write, on the host."""

    def __init__(self):
        self.items = {}

    def write(self, key, value):
        self.items[key] = value

    def write_frame(self, step, **groups):
        self.items.update({f"snapshots/{k}/{step}": v for k, v in groups.items()})

    def write_packets(self, step, t, **arrays):
        self.items[f"p/t/{step}"] = t
        self.items.update({f"p/{k}/{step}": v for k, v in arrays.items() if v is not None})

    def flush(self):
        pass


def test_span_without_a_profiler_is_one_null_object():
    a, b = obs.span("frame.coupled"), obs.span("rays.table")
    assert a is b
    with a:
        x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0
    before = dict(obs.waits)
    with obs.wait("driver.frame_tail") as w:
        pass
    assert w is None and obs.waits["driver.frame_tail"] == before["driver.frame_tail"] + 1
    obs.reset_waits()
    assert set(obs.waits) == set(obs.WAIT_SITES) and not any(obs.waits.values())


def test_span_under_a_profiler_is_a_range_of_its_timeline():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outer"):
            with obs.span("flow.step"):
                torch.ones(4).sum()
            with obs.wait("driver.nan_guard"):
                pass
    spans = _spans(prof)
    assert spans[("flow.step", "outer")] == 1
    assert spans[("wait.driver.nan_guard", "outer")] == 1
    assert obs.span("flow.step") is obs.span("rays.step")     # off again


def test_rk4_frame_spans_nest():
    drv = _driver()
    drv.run(1, 5)
    spans = _profiled(lambda: drv.run(1, 5))
    top = "frame.coupled"
    assert spans == {
        (top, None): 1,
        ("rays.table", top): 5,             # one pair table a step
        ("flow.step", top): 5, ("rays.fields", top): 5, ("rays.step", top): 5,
        ("rays.reset", top): 5,
        # the guard, the diagnostics and the log's scalars: one tail, one wait
        ("driver.frame_tail", None): 1, ("wait.driver.frame_tail", "driver.frame_tail"): 1,
        ("driver.log", None): 1,
    }


def test_adaptive_frame_spans_nest():
    drv = _driver("adaptive")
    drv.run(1, 5)
    spans = _profiled(lambda: drv.run(1, 5))
    slots = sum(int(i["n_accepted"]) + int(i["n_rejected"]) for i in drv.ray_infos)
    top = "frame.coupled"
    assert spans[("rays.adaptive", top)] == 5
    assert spans[("rays.table", "rays.adaptive")] == 5     # both tables, every step
    assert spans[("rays.attempt", "rays.adaptive")] == slots
    assert spans[("wait.rays.adaptive", "rays.adaptive")] == 5      # the first test
    assert spans[("wait.rays.adaptive", "rays.attempt")] == slots
    assert ("rays.step", top) not in spans and ("rays.table", top) not in spans


def test_flow_chunk_spans_nest():
    drv = _driver()
    spans = _profiled(lambda: drv.spinup(25, chunk=25))
    assert spans == {("frame.flow", None): 1, ("flow.step", "frame.flow"): 25,
                     ("rays.fields", "frame.flow"): 1, ("driver.nan_guard", None): 1,
                     ("wait.driver.nan_guard", "driver.nan_guard"): 1}


@pytest.mark.parametrize("profiled", [False, True])
def test_waits_of_an_rk4_frame_and_a_spinup_chunk(profiled):
    drv = _driver()
    obs.reset_waits()
    if profiled:
        _profiled(lambda: drv.run(1, 5))
    else:
        drv.run(1, 5)
    # the frame's tail: the NaN guard, the clock, the two energies and the
    # log's umax, read back together
    assert obs.waits == {**dict.fromkeys(obs.WAIT_SITES, 0), "driver.frame_tail": 1}
    obs.reset_waits()
    drv.spinup(50, chunk=25)
    assert obs.waits == {**dict.fromkeys(obs.WAIT_SITES, 0), "driver.nan_guard": 2}


def test_waits_of_an_adaptive_step_are_one_and_its_slots():
    drv = _driver("adaptive")
    obs.reset_waits()
    drv.run(2, 5)
    slots = sum(int(i["n_accepted"]) + int(i["n_rejected"]) for i in drv.ray_infos)
    assert slots >= 10
    assert obs.waits["rays.adaptive"] == 10 + slots
    assert obs.waits["driver.frame_tail"] == 2 and obs.waits["driver.nan_guard"] == 0


def test_waits_of_the_outputs_and_the_midpoint_solve():
    drv = _driver(snapshot_writer=_Writer(), packet_writer=_Writer())
    obs.reset_waits()
    drv.run(2, 5, snapshot_every=2)
    # per frame the packet rows and the clock; one snapshot (solution, clock)
    assert obs.waits["driver.outputs"] == 2 * 2 + 2
    assert set(drv.packet_writer.items) >= {"p/t/5", "p/x/10", "p/g/10"}
    assert drv.snapshot_writer.items["snapshots/t/5"] == pytest.approx(5 * drv.dt, rel=1e-5)
    assert isinstance(drv.snapshot_writer.items["snapshots/sol/5"], torch.Tensor)
    mid = _driver("midpoint")
    obs.reset_waits()
    mid.run(1, 2)
    # each substep tests its residual at least once and at most maxit times
    assert 2 <= obs.waits["rays.midpoint"] <= 2 * mid.rp.midpoint_maxit


@pytest.mark.parametrize("ray_method", ["rk4", "adaptive"])
def test_a_frame_is_bit_equal_under_a_profiler(ray_method):
    plain, traced = _driver(ray_method), _driver(ray_method)
    plain.run(1, 5)
    _profiled(lambda: traced.run(1, 5))
    for a, b in zip(plain.sim.packets, traced.sim.packets):
        assert torch.equal(a, b)
    assert torch.equal(plain.sim.sol, traced.sim.sol)
    assert torch.equal(plain.sim.fields, traced.sim.fields)
    assert torch.equal(plain.sim.clock.t, traced.sim.clock.t)
    for name in plain.diag_series:
        np.testing.assert_array_equal(plain.diag_series[name], traced.diag_series[name])
