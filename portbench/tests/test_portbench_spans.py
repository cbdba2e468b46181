"""The traced run by stage (``portbench/stages.py``): device time put down
to the span open at each op's launch, idle time to the span at each gap's
middle, the idle that follows a host wait; the keys of ``trace.summarize``
unchanged beside them; the span-fed readers; a tiny traced run of every
cell on the CPU."""
from __future__ import annotations

import pytest
import torch

from portbench import spec, stages, trace

WINDOW = (0.0, 100.0)
# (kind, name, start_us, end_us, id, linked correlation id)
HOST = [
    ("cpu", trace.WINDOW_MARK, 0.0, 100.0, 1, 0),
    ("cpu", "aten::mul", 6.0, 8.0, 4, 0),
    ("cpu", "cudaLaunchKernel", 7.0, 8.0, 900, 4),
    ("cpu", "cudaLaunchKernel", 23.0, 24.0, 901, 5),
    ("cpu", "cudaLaunchKernel", 31.0, 32.0, 902, 77),
    ("cpu", "aten::max", 63.0, 64.0, 8, 0),
    ("cpu", "cudaLaunchKernel", 63.2, 63.8, 904, 0),   # no linked id, as older PyTorch
    ("cpu", "cudaStreamSynchronize", 65.0, 74.0, 905, 8),
    ("cpu", "cudaMalloc", 50.0, 58.0, 10, 0),
    ("cpu", "aten::add", 90.0, 91.0, 9, 0),
]
SPANS = [
    ("span", "frame.coupled", 2.0, 60.0, 2, 0),
    ("span", "flow.step", 4.0, 19.0, 3, 0),
    ("span", "rays.table", 22.0, 30.0, 5, 0),
    ("span", "driver.nan_guard", 62.0, 80.0, 6, 0),
    ("span", "wait.driver.nan_guard", 64.0, 75.0, 7, 0),
]
DEVICE = [
    ("cuda", "k_mul", 10.0, 15.0, 900, 4),        # launched by aten::mul in flow.step
    ("cuda", "k_table", 25.0, 35.0, 901, 5),      # launched under rays.table itself
    ("cuda", "k_fallback", 36.0, 38.0, 902, 77),  # its host op is missing: the launch call
    ("cuda", "k_guard", 70.0, 72.0, 904, 0),      # its launch call, in the NaN guard
    ("cuda", "memset", 85.0, 86.0),               # no ids
    ("cuda", "k_outside", 92.0, 95.0, 906, 9),    # aten::add, after every span
]


def test_device_and_idle_time_by_stage():
    s = stages.summarize(HOST + SPANS + DEVICE, WINDOW)
    assert s["stage_device_s"] == pytest.approx({
        "flow.step": 5e-6, "rays.table": 10e-6, "frame.coupled": 2e-6,
        "driver.nan_guard": 2e-6, stages.NOT_FOUND: 1e-6, stages.OUTSIDE: 3e-6})
    assert sum(s["stage_device_s"].values()) == pytest.approx(
        sum(sec for _, sec in s["device_ops"].values()))
    # gaps [0,10) [15,25) [35,36) [38,70) [72,85) [86,92) [95,100) by their middles
    assert s["stage_idle_s"] == pytest.approx({
        "flow.step": 10e-6, "frame.coupled": 43e-6, "driver.nan_guard": 13e-6,
        stages.OUTSIDE: 11e-6})
    assert sum(s["stage_idle_s"].values()) == pytest.approx(s["window_s"] - s["busy_s"])
    assert s["stage_idle_ops"]["flow.step"] == [("(no host operation)", pytest.approx(10e-6))]
    assert s["stage_idle_ops"]["frame.coupled"] == [
        ("cudaMalloc", pytest.approx(32e-6)), ("(no host operation)", pytest.approx(11e-6))]
    # only [72, 85) holds the wait's end (75); [38, 70) holds its start
    assert s["sync_idle_s"] == pytest.approx(13e-6)
    assert s["spans"] == {
        "frame.coupled": [1, pytest.approx(58e-6), pytest.approx(35e-6)],
        "flow.step": [1, pytest.approx(15e-6), pytest.approx(15e-6)],
        "rays.table": [1, pytest.approx(8e-6), pytest.approx(8e-6)],
        "driver.nan_guard": [1, pytest.approx(18e-6), pytest.approx(7e-6)],
        "wait.driver.nan_guard": [1, pytest.approx(11e-6), pytest.approx(11e-6)]}


def test_the_summary_keys_are_unchanged_by_spans():
    plain = trace.summarize([ev[:4] for ev in HOST + DEVICE], WINDOW)
    staged = stages.summarize(HOST + SPANS + DEVICE, WINDOW)
    assert {k: staged[k] for k in plain} == plain
    # the gaps still name host operations: taken as host operations, the
    # spans would have named them
    assert [name for name, _ in staged["idle_gaps"]] == ["(no host operation)", "cudaMalloc"]
    as_host = trace.summarize([("cpu", *ev[1:4]) if ev[0] == "span" else ev[:4]
                               for ev in HOST + SPANS + DEVICE], WINDOW)
    assert "frame.coupled" in dict(as_host["idle_gaps"])
    # nor is anything counted without spans or ids
    bare = stages.summarize([ev[:4] for ev in HOST + DEVICE], WINDOW)
    assert bare["stage_device_s"] == pytest.approx({stages.NOT_FOUND: 23e-6})
    assert bare["spans"] == {} and bare["sync_idle_s"] == 0.0


def _summary(**kw):
    s = dict(window_s=0.1, busy_s=0.03, frames=4, steps=20,
             counters=dict(host_waits=24), spans={"wait.driver.log": [8, 0.001, 0.001]},
             sync_idle_s=0.004, stage_device_s={"flow.step": 0.004, "rays.table": 0.01})
    s.update(kw)
    return s


def read(name, summary):
    return spec.reader(name)(summary, spec.load_cell("rsw512_rk4"))


def test_the_span_readers():
    s = _summary()
    assert read("driver.host_waits_per_step", s) == pytest.approx(1.2)
    assert read("driver.sync_idle_pct", s) == pytest.approx(4.0)
    assert read("flow.step_ms_per_step", s) == pytest.approx(0.2)
    assert read("rays.table_ms_per_step", s) == pytest.approx(0.5)
    # a program without the counter or the spans, a flow-only cell
    bare = _summary(counters={}, spans={"frame.flow": [4, 0.1, 0.01]}, sync_idle_s=0.0,
                    stage_device_s={"flow.step": 0.004, stages.OUTSIDE: 0.001})
    assert read("driver.host_waits_per_step", bare) is None
    assert read("driver.sync_idle_pct", bare) is None
    assert read("rays.table_ms_per_step", bare) is None
    assert read("flow.step_ms_per_step", bare) == pytest.approx(0.2)
    old = {k: v for k, v in _summary().items() if k not in ("spans", "stage_device_s")}
    for name in stages.METRICS:
        if name != "driver.host_waits_per_step":
            assert read(name, old) is None, name


@pytest.mark.parametrize("name", ["rsw512_rk4", "rsw512_adaptive", "twolayer2048_flow"])
def test_a_tiny_traced_run_by_stage(name, bench, tiny):
    cell = tiny(name)
    result, _, summary = stages.run_traced(cell, bench, 2_147_483_659, device="cpu")
    assert result["correct"]
    tr, c = cell.traffic, summary["counters"]
    frames = tr["trace_frames"]
    if cell.coupled:
        # the NaN guard, the log's two scalars, the diagnostics' clock and
        # two energies: 6 a frame; the adaptive loop's first test a step
        # and one after each attempt
        waits = 6 * frames
        if tr["ray_method"] != "rk4":
            waits += summary["steps"] + c["attempts_accepted"] + c["attempts_rejected"]
        assert summary["spans"]["frame.coupled"][0] == frames
    else:
        waits = frames
        assert summary["spans"]["flow.step"][0] == summary["steps"]
    assert c["host_waits"] == waits
    report = stages.stage_report(summary, cell)
    assert report["metrics"]["driver.host_waits_per_step"]["value"] == pytest.approx(
        waits / summary["steps"])
    # the CPU run traces the host alone: no device time to put down
    assert "flow.step_ms_per_step" not in report["metrics"]
    assert any(line.startswith("span wait.driver.nan_guard") for line in report["lines"])


@pytest.mark.parametrize("trace_flag", ["0", "1"])
def test_stages_runs_traced_and_on_a_card_only(trace_flag):
    if trace_flag == "1" and torch.cuda.is_available():
        pytest.skip("a card is there: the run would start")
    assert stages.main(["--workload", "rsw512_rk4", "--seed", "1", "--seconds", "1",
                        "--trace", trace_flag]) == 2
