"""The per-layer readers and the trace reduction on synthetic input."""
from __future__ import annotations

import pytest

from portbench import roofline, spec
from portbench.trace import label_gaps, summarize, union_seconds


def _summary(**kw):
    s = dict(window_s=0.1, busy_s=0.03, frames=4, steps=20, launch_calls=2400,
             device_ops={"void ray_step_table_kernel<0, __nv_bfloat16>(...)": [20, 0.0036],
                         "void ray_attempt_table_kernel<0, __nv_bfloat16>(...)": [25, 0.005],
                         "void regular_fft_factor<256, ...>": [200, 0.002],
                         "void vector_fft_c2r<...>": [120, 0.002],
                         "Memcpy DtoD (Device -> Device)": [10, 0.0001]},
             idle_gaps=[], held_rows=262144.0, n_packets=1 << 20, interp="bilinear",
             table_dtype="bfloat16", nx=512, coupled=True, ray_method="rk4",
             counters=dict(table_launches=20, table_attempt_launches=0,
                           attempts_accepted=20, attempts_rejected=5))
    s.update(kw)
    return s


def read(name, summary):
    return spec.reader(name)(summary, spec.load_cell("rsw512_rk4"))


def test_readers_on_a_synthetic_summary():
    s = _summary()
    assert read("device.idle_pct", s) == pytest.approx(70.0)
    assert read("driver.launch_calls_per_step", s) == pytest.approx(120.0)
    assert read("flow.fft_ms_per_step", s) == pytest.approx(0.2)
    bound = roofline.bound_s(roofline.ray_step_bytes(262144.0, 1 << 20, "bilinear", "bfloat16"))
    assert read("ray_step_roofline", s) == pytest.approx(100 * 20 * bound / 0.0036)
    bound = roofline.bound_s(roofline.ray_attempt_bytes(262144.0, 1 << 20, "bilinear",
                                                        "bfloat16"))
    assert read("ray_attempt_roofline", s) == pytest.approx(100 * 25 * bound / 0.005)
    assert read("adaptive.attempts_per_step", s) == pytest.approx(25 / 20)
    assert 0 < read("step_mfu", s) < 100


def test_readers_return_nothing_without_their_source():
    s = _summary(device_ops={}, launch_calls=0,
                 counters=dict(table_launches=0, table_attempt_launches=0,
                               attempts_accepted=0, attempts_rejected=0))
    for name in ("device.idle_pct", "driver.launch_calls_per_step", "flow.fft_ms_per_step",
                 "ray_step_roofline", "ray_attempt_roofline", "adaptive.attempts_per_step"):
        assert read(name, s) is None, name


def test_summarize_unions_and_labels_gaps():
    events = [("cpu", "portbench.window", 0.0, 100.0),
              ("cpu", "aten::add", 5.0, 15.0), ("cpu", "cudaLaunchKernel", 8.0, 9.0),
              ("cpu", "cudaStreamSynchronize", 40.0, 70.0),
              ("cuda", "k1", 10.0, 30.0), ("cuda", "k2", 20.0, 35.0), ("cuda", "k1", 60.0, 65.0),
              ("cuda", "outside", 200.0, 210.0)]
    s = summarize(events, (0.0, 100.0))
    assert s["window_s"] == pytest.approx(1e-4)
    assert s["busy_s"] == pytest.approx(30e-6)
    assert s["device_ops"]["k1"] == [2, pytest.approx(25e-6)]
    assert "outside" not in s["device_ops"]
    assert s["launch_calls"] == 1
    gaps = dict(s["idle_gaps"])
    # [0, 10) aten::add spans its middle (5); [35, 60) and [65, 100) the sync
    # and nothing
    assert gaps["aten::add"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(25e-6)
    assert gaps["(no host operation)"] == pytest.approx(35e-6)
    assert union_seconds([])[0] == 0.0
    assert label_gaps([], []) == {}


def test_the_birth_death_roofline_reads_its_kernel():
    """Launches x the function's bytes at the deaths a launch (the births
    counter over the launches) at 3.35 TB/s, over the kernel's device
    time; nothing without the kernel."""
    kernel = "void (anonymous namespace)::birth_death_kernel<float>(...)"
    s = _summary(n_packets=262144, device_ops={kernel: [20, 0.0003]},
                 counters=dict(births=600))
    nbytes = 4 * (7 * (262144 - 30) + 2 * 30 + 7 * 262144) + 262144
    share = read("birth_death_roofline", s)
    assert share == pytest.approx(100 * 20 * nbytes / 3.35e12 / 0.0003)
    assert 0 < share < 100
    assert read("birth_death_roofline", _summary(n_packets=262144)) is None


def test_step_mfu_takes_the_configurations_ray_work():
    """``work.ray_flops_per_packet``, where a configuration states it, is
    the work of one attempt a packet; else the method's count."""
    cell = spec.load_cell("rsw512_rk4")
    s = _summary()
    base = spec.reader("step_mfu")(s, cell)
    per = roofline.ray_flops_per_packet("rk4")
    cell.config["work"] = dict(cell.config["work"], ray_flops_per_packet=2 * per)
    more = spec.reader("step_mfu")(s, cell)
    extra = 20 * (1 << 20) * per
    assert more - base == pytest.approx(100 * extra / (0.1 * roofline.FP32_FLOPS_PER_S))
