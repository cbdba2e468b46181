"""The two-layer coupled run on the taps path (``rays/interp``,
``rays/raytrace._raytrace_taps``), as the benchmark's cell
``twolayer2048_taps`` drives it, at 32^2 with 8^2 packets on the CPU.

- RK4 frames held to the benchmark's plain reference (``portbench/check``)
  within the cell's limits; the reference one precision below (the
  control) fails them;
- ``gather='auto'`` takes taps at the cell's size and the patch table at
  the RSW hero's;
- each RK4 stage's sample is one ``rays.taps`` span inside ``rays.step``
  under a profiler, and one count in ``rays/interp.taps_gathers``.
"""
import copy

import pytest
import torch

from juliaraytracingsw_tpu_torch.experiments import __main__ as cli
from juliaraytracingsw_tpu_torch.rays import interp
from juliaraytracingsw_tpu_torch.rays.raytrace import RayParams, resolve_gather
from portbench.check import judge
from portbench.control import readings
from portbench.spec import Cell, load_cell

CELL = "twolayer2048_taps"
NX, SQRTP = 32, 8
K = 3   # flow steps a frame


def _tiny_cell() -> Cell:
    """The cell at NX^2 with SQRTP^2 packets (auto -> taps), a short
    spin-up and the checked frames early; its limits as committed."""
    cell = load_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["nx"], cfg["packets"]["sqrt_n"] = NX, SQRTP
    tr = copy.deepcopy(cell.traffic)
    tr["spinup_steps"], tr["check_frames"], tr["trace_frames"] = 20, [1, 3], 4
    return Cell(cell.entry, cell.workload, cfg, tr)


def _driver(*extra: str):
    args = cli.build_parser().parse_args(
        ["twolayer", "--nx", str(NX), "--sqrt-npackets", str(SQRTP), "--interp", "bilinear",
         "--table-dtype", "float32", "--gather", "auto", "--ray-method", "rk4", "--seed", "3",
         "--platform", "cpu", *extra])
    case = cli.SETUPS[args.cmd](args, lambda s: None)
    drv = cli.make_driver(args, case, log_fn=lambda s: None)
    drv.init(case.sol0, case.packets, clock=cli.start_clock(case, case.sol0.device))
    return drv


def test_taps_frames_follow_the_reference_and_the_control_does_not():
    cell = _tiny_cell()
    gathers = interp.taps_gathers["bilinear"]
    (row,) = readings(cell, [2_147_483_659], {2_147_483_659}, device="cpu")
    assert interp.taps_gathers["bilinear"] > gathers
    assert judge(row["program"], cell.limits), row
    assert not judge(row["control"], cell.limits), row


@pytest.mark.parametrize("n_packets,n,gather", [(512 ** 2, 2048, "taps"),
                                                (1024 ** 2, 512, "patch")],
                         ids=["twolayer2048_rays", "rsw512_hero"])
def test_auto_gather_at_the_cells_sizes(n_packets, n, gather):
    rp = RayParams(3.0, 1.0, -3.14, -3.14, 6.28 / n, 6.28 / n, gather="auto")
    assert resolve_gather(rp, n_packets, n, n).gather == gather


def test_each_stage_is_a_taps_span_inside_the_ray_step():
    drv = _driver()
    drv.spinup(4, chunk=4)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        drv.run(1, K)
    spans = {}
    for e in prof.events():
        if e.name in ("rays.taps", "rays.step"):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert len(spans["rays.step"]) == K
    assert len(spans["rays.taps"]) == 4 * K
    for s, e in spans["rays.taps"]:
        assert sum(a <= s and e <= b for a, b in spans["rays.step"]) == 1


@pytest.mark.parametrize("substeps", [1, 2])
def test_the_gather_counter_counts_each_stage(substeps):
    drv = _driver("--ray-substeps", str(substeps))
    drv.spinup(4, chunk=4)
    before = dict(interp.taps_gathers)
    drv.run(2, K)
    assert interp.taps_gathers["bilinear"] - before["bilinear"] == 4 * 2 * K * substeps
    assert {k: v for k, v in interp.taps_gathers.items() if k != "bilinear"} == \
        {k: v for k, v in before.items() if k != "bilinear"}


def _summary(**kw):
    s = dict(steps=400, n_packets=512 ** 2, interp="bilinear", coupled=True,
             device_ops={"void at::native::_scatter_gather_elementwise_kernel<128, 8, "
                         "at::native::_cuda_scatter_gather_internal_kernel<false, "
                         "at::native::OpaqueType<4>, int>::operator()<...>(...)": [1600, 0.08],
                         "void regular_fft<2048u, ...>": [4000, 0.2]})
    s.update(kw)
    return s


def test_taps_readers_on_a_synthetic_summary():
    from portbench import roofline, spec

    cell = load_cell(CELL)
    assert spec.reader("rays.taps_ms_per_step")(_summary(), cell) == pytest.approx(0.2)
    # one gather: 5 fields x 4 taps x 262,144 packets, float32 values read
    # and written, int32 indices read
    bound = roofline.bound_s(5 * 4 * 512 ** 2 * (4 + 4 + 4))
    share = spec.reader("ray_taps_roofline")(_summary(), cell)
    assert share == pytest.approx(100 * 1600 * bound / 0.08)
    assert 0 < share < 100


@pytest.mark.parametrize("name", ["rays.taps_ms_per_step", "ray_taps_roofline"])
def test_taps_readers_return_nothing_without_gathers(name):
    from portbench import spec

    s = _summary(device_ops={"void regular_fft<2048u, ...>": [4000, 0.2]})
    assert spec.reader(name)(s, load_cell(CELL)) is None
