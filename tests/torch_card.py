"""What the tests marked ``cuda`` share: the ``cuda_device`` fixture, the
hand-written kernels' runs counted from a profiler trace, and the command
line's coupled cases built and driven as it builds and drives them.

Imports neither JAX nor a module at the repository's root: the card's
machine has no JAX. Nor does it have h5py, so ``drive_cli`` runs the
driver the command line builds without its HDF5 writers.
"""
import contextlib
import os

import numpy as np
import pytest
import torch

from juliaraytracingsw_tpu_torch.experiments import __main__ as cli
from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih

DT = 1e-3                                          # the hero's flow dt
HERO_IC = ("--seed", "1", "--ag", "0.5", "--aw", "0.05")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernels and CUDA graphs have no "
                    "CPU mode)")
    return "cuda"


def quiet(line):
    pass


# the kernels by the names they run under on the card (substrings)
KERNEL_NAMES = {"table": ("ray_step_table_kernel",),
                "table attempt": ("ray_attempt_table_kernel",),
                "first cut": ("ray_step_kernel", "ray_attempt_kernel"),
                "pair table": ("pair_table_kernel",),
                "birth_death": ("birth_death_kernel",),
                "roll": ("roll_cuda_kernel",),
                # PyTorch's kernel for the taps path's 1-D index_select
                "taps gather": ("_scatter_gather_elementwise_kernel",)}


@contextlib.contextmanager
def kernel_runs():
    """``with kernel_runs() as runs: ...``: the kernels' runs on the card
    inside the block, CUDA graph replays included (the launch counters
    count host launches only), from a ``torch.profiler`` trace; ``runs``
    holds them by the keys of ``KERNEL_NAMES`` once the block has ended."""
    from torch.profiler import ProfilerActivity, profile

    runs: dict = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield runs
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type.name == "CUDA"]
    for key, subs in KERNEL_NAMES.items():
        runs[key] = sum(1 for n in names if any(sub in n for sub in subs))


def coupled_argv(cmd: str, nx: int, sqrtp: int, frames: int, *extra: str,
                 platform: str = "cuda", spinup_steps: int = 0,
                 gather: str = "auto") -> list[str]:
    """A coupled subcommand at nx^2 with sqrtp^2 packets, bilinear bf16
    tables, RK4, the hero's dt (its CFL tune), ``spinup_steps`` flow steps,
    then ``frames`` frames of 5 steps, no outputs; ``extra`` options come
    last, so they override these."""
    dx = 2 * np.pi / nx
    spinup_T, output_dt = (spinup_steps + 0.5) * DT, 5.5 * DT
    return [cmd, "--nx", str(nx), "--sqrt-npackets", str(sqrtp), "--interp", "bilinear",
            "--table-dtype", "bfloat16", "--ray-method", "rk4", "--gather", gather,
            "--cfltune", repr(DT * 2.0 / dx), "--spinup-T", repr(spinup_T),
            "--output-dt", repr(output_dt), "--T", repr(spinup_T + (frames + 0.5) * output_dt),
            "--platform", platform, *extra]


def setup_case(argv: list[str]):
    """(parsed arguments, ``Case``) of a coupled subcommand, by the command
    line's own set-up."""
    args = cli.build_parser().parse_args(argv)
    setup = cli.SETUPS[args.cmd]
    case = setup(args) if args.cmd == "single-wave" else setup(args, quiet)
    return args, case


def cli_driver(argv: list[str]):
    """(driver, parsed arguments, case) of a coupled subcommand without
    writers, the driver started from the case's state."""
    args, case = setup_case(argv)
    drv = cli.make_driver(args, case, log_fn=quiet)
    drv.init(case.sol0, case.packets, clock=cli.start_clock(case, case.sol0.device))
    return drv, args, case


def drive_cli(argv: list[str]):
    """A coupled subcommand's run without its HDF5 outputs, as the command
    line runs it: the driver built by ``experiments.__main__`` itself, then
    spin-up (``single-wave``: the injected wave), frames and the checkpoint
    -> the driver."""
    drv, args, case = cli_driver(argv)
    spinup_steps, frames, steps_per_frame = cli.schedule(args)
    drv.spinup(spinup_steps)
    if args.cmd == "single-wave":
        drv.sim = drv.sim._replace(sol=cli.inject(args, case, drv.sim.sol))
    drv.run(frames, steps_per_frame)
    if args.checkpoint:
        drv.checkpoint(args.checkpoint)
    return drv


def cli_outputs(argv: list[str], have_h5py: bool):
    """(diagnostics {name: series}, last packets {x, k}) of one command line
    run: from its files, or without h5py from its driver."""
    if have_h5py:
        import h5py

        from juliaraytracingsw_tpu_torch.io.output import SequencedReader

        cli.run(argv, log_fn=quiet)
        out_dir = argv[argv.index("--out-dir") + 1]
        with h5py.File(os.path.join(out_dir, "diagnostics.h5"), "r") as f:
            diags = {k: f[k][()] for k in f}
        _, frame = SequencedReader(os.path.join(out_dir, "packets")).final_packet_frame()
        return diags, {"x": frame["x"], "k": frame["k"]}
    drv = drive_cli(argv)
    p = drv.sim.packets
    diags = {"t": np.asarray(drv.diag_times),
             **{k: np.asarray(v) for k, v in drv.diag_series.items()}}
    return diags, {"x": torch.stack([p.x, p.y], 1).cpu().numpy(),
                   "k": torch.stack([p.k, p.l], 1).cpu().numpy()}


def hero_fields(nx: int, interp: str, platform: str):
    """The hero's flow at nx^2 as the ``rsw`` command line sets it up (its
    IC of seed 1 as the old level, of seed 2 as the new) -> (grid, ray
    parameters with float32 tables, old fields, new fields)."""
    levels = []
    for seed in ("1", "2"):
        _, case = setup_case(coupled_argv("rsw", nx, 1, 1, *HERO_IC, "--seed", seed,
                                          "--interp", interp, "--table-dtype", "float32",
                                          "--gather", "patch", platform=platform))
        levels.append(fields_from_psih(case.psih_fn(case.sol0), case.model.grid, interp))
    return case.model.grid, case.rp, *levels


def random_state(n: int, grid, k0: float, device, seed: int = 11) -> torch.Tensor:
    """``st (5, N)``: n packets at random positions over the domain, on
    the wavenumber ring of radius k0, alternate signs."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-grid.Lx / 2, grid.Lx / 2, (2, n))
    phase = rng.uniform(0, 2 * np.pi, n)
    sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    return torch.as_tensor(np.stack([x, y, k0 * np.cos(phase), k0 * np.sin(phase), sign])
                           .astype(np.float32), device=device)


def rel_gap(gpu: torch.Tensor, cpu: torch.Tensor) -> float:
    """max |gpu - cpu| over max |cpu|."""
    return float((gpu.cpu() - cpu).abs().max() / cpu.abs().max())


def packet_gap(gpu, cpu) -> float:
    """The largest |gpu - cpu| over the packets' x, y, k, l."""
    return max(float((getattr(gpu, n).cpu() - getattr(cpu, n)).abs().max()) for n in "xykl")
