"""The bicubic Hermite hero (benchmark cell ``rsw512_bicubic``) held to the
benchmark's plain reference interpolant, ``portbench/reference/interp/
bicubic.py``, on the CPU at 32^2:

- the reference's sampler against the port's taps interpolant
  (``rays/interp.bicubic_hermite``) and against the patch path's twin
  (``ops/ray_step.table_substep_torch`` over ``pair_table_torch``), on
  seeded random corner data, at stage positions up to a cell outside the
  packet's base cell;
- the reference's table (spectral derivatives of the five fields) against
  the port's ``fields_from_psih(..., 'bicubic')``;
- the cell at 32^2 with 256 packets comes out correct; with the port's
  derivative blocks zeroed, with bilinear swapped in for the port's
  interpolant, and as the control (the reference one precision below), it
  does not;
- the cell's command line, word for word.

On the card (marked ``cuda``): the graphed bicubic frame counts one pair
table and one table-kernel launch a step at its capture and none at its
replays, and a traced run of the cell reads the two kernels' roofline
shares. The metric ``pair_table_roofline`` is read on synthetic summaries.
Imports no JAX:

    python -m pytest --noconftest -q tests/test_torch_bicubic_reference.py
"""
import copy
import math

import numpy as np
import pytest
import torch

from juliaraytracingsw_tpu_torch.core.grid import make_grid
from juliaraytracingsw_tpu_torch.coupled import driver as drv_mod
from juliaraytracingsw_tpu_torch.coupled.initial_conditions import random_band_psih
from juliaraytracingsw_tpu_torch.experiments import __main__ as cli
from juliaraytracingsw_tpu_torch.ops import pair_table, ray_step
from juliaraytracingsw_tpu_torch.rays import interp as port_interp
from juliaraytracingsw_tpu_torch.rays.raytrace import RayParams, fields_from_psih
from juliaraytracingsw_tpu_torch.utils import observability as obs
from portbench import cells, reference, roofline, spec
from portbench.check import judge
from portbench.control import readings
from portbench.reference import flow as ref_flow
from portbench.reference.rays import Rays
from portbench.run import run_cell
from torch_card import cli_driver, coupled_argv, cuda_device, kernel_runs  # noqa: F401

CELL = "rsw512_bicubic"
NX, SQRTP = 32, 16
L = 2 * math.pi
F, CG = 3.0, 1.0
SEED = 2_147_483_659
F32 = reference.Prec("float32", "float32")


def _tiny_cell(nx: int = NX, sqrtp: int = SQRTP) -> spec.Cell:
    """The cell at nx^2 with sqrtp^2 packets (auto -> patch), a short
    spin-up and the checked frames early; its limits as committed."""
    cell = spec.load_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["nx"], cfg["packets"]["sqrt_n"] = nx, sqrtp
    tr = copy.deepcopy(cell.traffic)
    tr["spinup_steps"], tr["check_frames"], tr["trace_frames"] = 20, [1, 3], 4
    return spec.Cell(cell.entry, cell.workload, cfg, tr)


@pytest.fixture
def bench_json():
    return spec.load_benchmark()


def _bicubic():
    return reference.find("interp", "bicubic")


def _stacks(seed: int, n: int = NX):
    """Two seeded random (20, n, n) float32 corner-data stacks."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((20, n, n), generator=gen), torch.randn((20, n, n), generator=gen))


def _stage_points(seed: int, count: int = 4096, n: int = NX):
    """Base cells anywhere on the grid (the wrap included) and offsets from
    their corner of [-1, 2) cells each way, kept off cell faces."""
    gen = torch.Generator().manual_seed(seed)
    dx = L / n
    bx = torch.randint(-2, n + 2, (count,), generator=gen).float()
    by = torch.randint(-2, n + 2, (count,), generator=gen).float()
    cx = torch.randint(-1, 2, (count,), generator=gen).float()
    cy = torch.randint(-1, 2, (count,), generator=gen).float()
    fx = 0.02 + 0.96 * torch.rand(count, generator=gen)
    fy = 0.02 + 0.96 * torch.rand(count, generator=gen)
    return bx, by, (cx + fx) * dx, (cy + fy) * dx


def _close(a, b, rtol=2e-6):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= rtol * scale, float((a - b).abs().max()) / scale


# --- the reference's sampler against the port's two forms ----------------------

@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 2e-5)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("a", [0.0, 0.3, 1.0])
def test_the_sampler_matches_the_taps_interpolant(a, dtype, rtol):
    """The same Hermite form: equal to round-off in float64; in float32
    the two sum their 16 taps in other orders."""
    g = ref_flow.grid(NX, L, "cpu")
    Fo, Fn = (s.to(dtype) for s in _stacks(1))
    bx, by, lx, ly = (v.to(dtype) for v in _stage_points(2))
    ref = _bicubic().sampler(Fo, Fn, bx, by, g, F32)(lx, ly, a)
    x, y = g.x0 + bx * g.dx + lx, g.x0 + by * g.dx + ly
    blended = (1.0 - a) * Fo + a * Fn
    port = port_interp.interpolate(blended, x, y, g.x0, g.x0, g.dx, g.dx, "bicubic")
    assert ref.shape == port.shape == (5, bx.numel()) and ref.dtype == dtype
    _close(port, ref, rtol)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_an_rk4_step_matches_the_patch_twin(table_dtype):
    """One RK4 step of random packets through the table's twin and through
    the reference rays, both over the same stored tables."""
    p = reference.Prec("float32", table_dtype)
    g = ref_flow.grid(NX, L, "cpu")
    Fo, Fn = (p.t(0.2 * s) for s in _stacks(3))
    gen = torch.Generator().manual_seed(4)
    n = 2048
    st = torch.stack([(torch.rand(n, generator=gen) - 0.5) * L,
                      (torch.rand(n, generator=gen) - 0.5) * L,
                      10.0 * torch.randn(n, generator=gen), 10.0 * torch.randn(n, generator=gen),
                      torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0)])
    h = 0.05
    rp = RayParams(F, CG, g.x0, g.x0, g.dx, g.dx, interp="bicubic", gather="patch",
                   table_dtype=table_dtype)
    T = pair_table.pair_table_torch(Fo, Fn, "bicubic", table_dtype)
    scal = torch.tensor([0.0, h])
    port = ray_step.table_substep_torch(T, st, scal, rp=rp, interp="bicubic", da=1.0,
                                        ny=NX, nx=NX)
    ref = Rays(g, F, CG, p, _bicubic()).rk4(st, Fo, Fn, torch.tensor(0.0), torch.tensor(h))
    moved = (ref[:2] - st[:2]).abs().max() / g.dx
    assert 0.2 < float(moved) < 2.5      # stages reach past the base cell
    assert float((port[:2] - ref[:2]).abs().max()) / g.dx < 1e-5
    _close(port[2:4], ref[2:4], 1e-5)


def test_the_table_matches_the_ports_fields():
    grid = make_grid(NX, L, device="cpu")
    g = ref_flow.grid(NX, L, "cpu")
    psih = random_band_psih(grid, np.random.default_rng(5), kband=(2, 10), amp=1.0)
    port = fields_from_psih(psih, grid, "bicubic")
    ref = _bicubic().table(ref_flow.fields(psih, g), g, F32)
    assert port.shape == ref.shape == (20, NX, NX)
    for block in range(4):
        _close(port[5 * block:5 * block + 5], ref[5 * block:5 * block + 5], 1e-5)
    assert float(ref[5:].abs().max()) > 1.0          # the derivative blocks carry weight


# --- whole runs of the cell ------------------------------------------------------

def test_a_sound_run_is_correct(bench_json):
    result, checks = run_cell(_tiny_cell(), bench_json, SEED, 0.3, False, device="cpu")
    assert result["correct"], checks
    assert checks["pos_gap_max"][0] < 1e-3 and checks["wave_gap_max"][0] < 1e-4


def _zero_derivatives(fn):
    def fields(psih, grid, interp="bilinear", prefilter=None):
        out = fn(psih, grid, interp, prefilter)
        return torch.cat([out[:5], torch.zeros_like(out[5:])]) if interp == "bicubic" else out
    return fields


def _bilinear_argv(fn):
    def argv(*a):
        words = fn(*a)
        words[words.index("--interp") + 1] = "bilinear"
        return words
    return argv


@pytest.mark.parametrize("fault", ["zero_derivatives", "bilinear"])
def test_a_broken_run_is_not_correct(fault, bench_json, monkeypatch):
    if fault == "zero_derivatives":
        monkeypatch.setattr(drv_mod, "fields_from_psih",
                            _zero_derivatives(drv_mod.fields_from_psih))
    else:
        monkeypatch.setattr(cells, "argv", _bilinear_argv(cells.argv))
    result, checks = run_cell(_tiny_cell(), bench_json, 23, 0.3, False, device="cpu")
    assert not result["correct"], checks
    assert checks["wave_gap_max"][0] > checks["wave_gap_max"][1], checks


def test_the_control_fails_and_the_program_passes():
    cell = _tiny_cell()
    (row,) = readings(cell, [31], {31}, device="cpu")
    assert judge(row["program"], cell.limits), row
    assert not judge(row["control"], cell.limits), row


def test_the_cells_command_line_is_pinned(bench_json):
    cell = spec.load_cell(CELL, bench_json)
    assert cells.argv(cell.config, cell.traffic, SEED, "cuda") == [
        "rsw", "--nx", "512", "--L", "6.283185307179586", "--cfltune", "0.16297466172610084",
        "--umax-estimate", "2.0", "--nutune", "1.0", "--nnu", "4", "--stepper", "IFMAB3",
        "--seed", "2147483659", "--platform", "cuda", "--sqrt-npackets", "1024",
        "--omega0-over-f", "2.0", "--interp", "bicubic", "--table-dtype", "bfloat16",
        "--gather", "auto", "--ray-method", "rk4", "--ray-substeps", "1",
        "--cg", "1.0", "--f-over-cg", "3.0", "--Kg", "10.0", "13.0", "--Kw", "0.0", "5.0",
        "--ag", "0.5", "--aw", "0.05"]
    args = cli.build_parser().parse_args(cells.argv(cell.config, cell.traffic, SEED, "cpu"))
    assert (args.interp, args.table_dtype, args.gather) == ("bicubic", "bfloat16", "auto")


# --- the table build's roofline ----------------------------------------------------

def _summary(**kw):
    s = dict(steps=20, nx=512, interp="bicubic", table_dtype="bfloat16",
             device_ops={"void (anonymous namespace)::pair_table_kernel<2, unsigned short>(...)":
                         [20, 0.0040],
                         "void (anonymous namespace)::ray_step_table_kernel<2, "
                         "jrsw::bf16_bits>(...)": [20, 0.0128]})
    s.update(kw)
    return s


def test_the_pair_table_roofline_on_a_synthetic_summary(bench_json):
    read = spec.reader("pair_table_roofline")
    cell = spec.load_cell(CELL, bench_json)
    # both 20-channel f32 stacks read, 512^2 rows of 1,280 B written
    nbytes = 512 ** 2 * (2 * 20 * 4 + 2 * 4 * 4 * 20 * 2)
    assert roofline.bound_s(nbytes) * 1e3 == pytest.approx(0.1127, abs=5e-5)
    assert read(_summary(), cell) == pytest.approx(100 * 20 * roofline.bound_s(nbytes) / 0.0040)
    bilinear = _summary(interp="bilinear")
    assert roofline.bound_s(512 ** 2 * (2 * 5 * 4 + 320)) * 1e3 == pytest.approx(0.0282,
                                                                                 abs=5e-5)
    assert read(bilinear, cell) == pytest.approx(
        100 * 20 * roofline.bound_s(512 ** 2 * (2 * 5 * 4 + 320)) / 0.0040)


@pytest.mark.parametrize("ops", [{}, {"void at::native::roll_cuda_kernel<float>(...)":
                                      [640, 0.1]}], ids=["empty", "roll"])
def test_the_pair_table_roofline_reads_nothing_without_its_kernel(ops, bench_json):
    read = spec.reader("pair_table_roofline")
    assert read(_summary(device_ops=ops), spec.load_cell(CELL, bench_json)) is None


# --- on the card -------------------------------------------------------------------

@pytest.mark.cuda
def test_the_graphed_bicubic_frame_counts_its_launches_at_capture(cuda_device):
    """The coupled RK4 frame at 64^2 with 4,096 packets: its capture counts
    one pair-table and one table-kernel launch a step under 'bicubic'; its
    replays count none, and a profiler finds both kernels run once a step."""
    k = 5
    drv, _, _ = cli_driver(coupled_argv("rsw", 64, 64, 4, "--interp", "bicubic",
                                        "--gather", "patch"))
    assert drv.rp.interp == "bicubic" and drv.sim.fields.shape == (20, 64, 64)
    obs.reset_graph_frames()
    drv.spinup(4, chunk=4)
    drv.run(1, k)                                         # the eager first call
    builds, steps = (pair_table.pair_table_launches["bicubic"],
                     ray_step.table_launches["bicubic"])
    drv.run(1, k)                                         # the capture
    assert pair_table.pair_table_launches["bicubic"] == builds + k
    assert ray_step.table_launches["bicubic"] == steps + k
    with kernel_runs() as runs:
        drv.run(3, k)
    assert runs["table"] == runs["pair table"] == 3 * k and runs["roll"] == 0
    assert pair_table.pair_table_launches["bicubic"] == builds + k
    assert ray_step.table_launches["bicubic"] == steps + k
    assert obs.graph_frames["captured"] == 1 and obs.graph_frames["replayed"] >= 3
    assert bool(torch.isfinite(drv.sim.packets.x).all())


@pytest.mark.cuda
def test_a_traced_run_reads_both_rooflines(cuda_device, bench_json):
    cell = _tiny_cell(64, 64)
    result, checks = run_cell(cell, bench_json, 7, 0.3, True, device=cuda_device)
    assert result["correct"], checks
    for metric in ("ray_step_roofline", "pair_table_roofline"):
        assert 0 < result["metrics"][metric]["value"] <= 100, metric

