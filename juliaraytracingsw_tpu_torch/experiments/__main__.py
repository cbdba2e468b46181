"""Command line of the port (port of ``experiments/__main__.py``).

    python -m juliaraytracingsw_tpu_torch.experiments rsw --nx 256 --out-dir run
    python -m juliaraytracingsw_tpu_torch.experiments analyze run
    python -m juliaraytracingsw_tpu_torch.experiments swqg --platform cpu ...

Subcommands ported:

    rsw       RSW turbulence + packet ensemble (``--model rsw``), with the
              band-limited geostrophic + wave IC (``--ic band``) or random
              wave fronts (``--ic front``)
    swqg      SWQG turbulence + packets
    analyze   offline analysis suite over one or more finished run dirs

Common flow per run: derive dt from the CFL tune and the hyperviscosity,
build the model and the ``CoupledDriver``, spin up, then coupled frames
with rolling HDF5 outputs (``<base>.%06d.h5``, ``packets.%06d.h5``),
diagnostics (``diagnostics.h5``) and, with ``--checkpoint``, a checkpoint
that either package restores. The files are the JAX package's.

``--platform`` names the torch device (default ``cuda``); without a card
the run fails and says to pass ``--platform cpu``. The other subcommands
and options of the JAX command line exit with a message naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import os
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["build_parser", "run", "main", "Case", "setup_rsw", "setup_swqg",
           "schedule", "make_driver"]


def _not_ported(what: str, item: str) -> SystemExit:
    return SystemExit(f"{what} is not ported to juliaraytracingsw_tpu_torch yet "
                      f"(ROADMAP queue 1, {item}); the JAX package's command line "
                      f"(python -m juliaraytracingsw_tpu.experiments) runs it")


# subcommands of the JAX command line that wait for their ROADMAP item
_UNPORTED_COMMANDS = {
    "twolayer": "item 8",
    "thomasyamada": "item 9",
    "steady-raytracing": "item 12",
    "twolayer-simulation": "item 8",
    "single-wave": "item 9",
    "sweep": "item 12",
    "omega-k": "item 12",
    "omega-k-plot": "item 12",
    "b-parameter": "item 12",
}
# (attribute, flag, item) of the options that wait for theirs
_UNPORTED_OPTIONS = (
    ("birth_death", "--birth-death", "item 5"),
    ("live", "--live", "item 12"),
    ("sharded", "--sharded", "item 13"),
    ("distributed", "--distributed", "item 13"),
)


def _add_common(p: argparse.ArgumentParser):
    p.add_argument("--nx", type=int, default=256)
    p.add_argument("--L", type=float, default=2 * np.pi)
    p.add_argument("--cfltune", type=float, default=0.1)
    p.add_argument("--nutune", type=float, default=1.0)
    p.add_argument("--nnu", type=int, default=4)
    p.add_argument("--umax-estimate", type=float, default=2.0,
                   help="velocity scale for the CFL-derived dt")
    p.add_argument("--stepper", default="IFMAB3")
    p.add_argument("--use-filter", action="store_true")
    p.add_argument("--spinup-T", type=float, default=10.0)
    p.add_argument("--T", type=float, default=20.0)
    p.add_argument("--output-dt", type=float, default=1.0)
    p.add_argument("--max-writes", type=int, default=300)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--base-filename", default=None)
    p.add_argument("--seed", type=int, default=1234)
    _add_platform(p)
    p.add_argument("--distributed", action="store_true",
                   help="not ported (ROADMAP queue 1, item 13)")
    p.add_argument("--sharded", action="store_true",
                   help="not ported (ROADMAP queue 1, item 13)")
    p.add_argument("--checkpoint", default=None,
                   help="write a resumable checkpoint here at the end")
    p.add_argument("--restore", default=None,
                   help="resume from a checkpoint file (of either package)")
    p.add_argument("--live", type=int, default=0, metavar="N",
                   help="not ported (ROADMAP queue 1, item 12)")


def _add_platform(p: argparse.ArgumentParser):
    p.add_argument("--platform", default="cuda",
                   help="torch device to run on: 'cuda' (default) or 'cpu'")


def _add_packets(p: argparse.ArgumentParser):
    p.add_argument("--sqrt-npackets", type=int, default=16)
    p.add_argument("--omega0-over-f", type=float, default=2.0)
    p.add_argument("--k-ring", action="store_true", default=True)
    p.add_argument("--ray-substeps", type=int, default=1)
    p.add_argument("--ray-method", default="rk4",
                   choices=["rk4", "dopri5", "midpoint", "adaptive", "adaptive7"],
                   help="'adaptive' = embedded Dormand-Prince 5(4) with error "
                        "control; 'adaptive7' = Fehlberg 7(8)")
    p.add_argument("--ray-rtol", type=float, default=1e-5)
    p.add_argument("--ray-atol", type=float, default=1e-7)
    p.add_argument("--ray-max-steps", type=int, default=32)
    p.add_argument("--interp", default="bilinear",
                   choices=["bilinear", "bspline", "bicubic"])
    p.add_argument("--gather", default="auto", choices=["auto", "patch", "taps"],
                   help="ray interpolation strategy: 'auto' picks per run "
                        "(rays/raytrace.resolve_gather: patch iff 8*packets >= "
                        "grid cells, the JAX package's rule), 'patch' (pair-table "
                        "rows read by the table kernels) or 'taps' (per-stage tap "
                        "gathers from the field stacks)")
    p.add_argument("--table-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="storage dtype of the ray pair table")
    p.add_argument("--frozen-flow", action="store_true")
    p.add_argument("--birth-death", action="store_true",
                   help="not ported (ROADMAP queue 1, item 5)")
    p.add_argument("--bd-k-shape", type=float, default=1.5)
    p.add_argument("--bd-lam", type=float, default=10.0)


def _device(platform: str) -> torch.device:
    """The torch device ``--platform`` names; no CUDA device means failure,
    never a silent run on the CPU."""
    device = torch.device(platform)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--platform {platform}: no CUDA device is available "
                         "(torch.cuda.is_available() is false); pass --platform cpu "
                         "to run on the CPU")
    return device


def _reject_unported(args):
    for attr, flag, item in _UNPORTED_OPTIONS:
        if getattr(args, attr, False):
            raise _not_ported(flag, item)
    if getattr(args, "model", "rsw") != "rsw":
        raise _not_ported(f"--model {args.model}", "item 8")


def _setup(args):
    from ..core.grid import make_grid
    from ..coupled.driver import derive_dt, derive_nu

    _reject_unported(args)
    grid = make_grid(args.nx, Lx=args.L, device=_device(args.platform))
    dt = derive_dt(args.cfltune, args.umax_estimate, grid.dx)
    nu = derive_nu(args.nutune, args.nx, args.nnu, dt)
    rng = np.random.default_rng(args.seed)
    return grid, dt, nu, rng


class Case(NamedTuple):
    """What a coupled subcommand builds before it runs: the model, the
    advecting streamfunction, the resolved ray parameters, the initial
    state, the diagnostics and the default snapshot file base."""

    model: object
    psih_fn: Callable
    rp: object
    sol0: torch.Tensor
    packets: object
    f: float
    Cg: float
    diagnostics: dict
    base: str


def _k0(args, f: float, Cg: float) -> float:
    return float(np.sqrt((args.omega0_over_f * f) ** 2 - f * f) / Cg)


def _ray_params(args, grid, f: float, Cg: float):
    from ..rays.raytrace import RayParams, resolve_gather

    rp = RayParams(f=f, Cg=Cg, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy, interp=args.interp,
                   table_dtype=args.table_dtype, gather=args.gather)
    return resolve_gather(rp, args.sqrt_npackets ** 2, grid.ny, grid.nx)


def setup_rsw(args) -> Case:
    """The ``rsw`` subcommand's model, IC, packets and diagnostics; sets
    ``args.dt``."""
    from ..coupled.initial_conditions import band_geo_wave_ic, front_ic
    from ..models import rsw
    from ..rays.packets import lattice_packets

    grid, dt, nu, rng = _setup(args)
    args.dt = dt
    f, Cg = args.f_over_cg * args.cg, args.cg
    model = rsw.make_model(grid, nu=nu, nnu=args.nnu, f=f, Cg=Cg)
    if args.ic == "front":
        sol0 = front_ic(grid, rng, n_waves=10, aw=args.aw, f=f, Cg=Cg)
    else:
        sol0 = band_geo_wave_ic(grid, rng, Kg=tuple(args.Kg), Kw=tuple(args.Kw),
                                ag=args.ag, aw=args.aw, f=f, Cg=Cg)

    def psih_fn(sol):
        Kd2 = f * f / (Cg * Cg)
        qh = grid.ik * sol[1] - grid.il * sol[0] - f * sol[2]
        return -qh / (grid.Krsq + Kd2)

    diags = {
        "kinetic_energy": lambda s, g, p: rsw.kinetic_energy(s, g),
        "potential_energy": lambda s, g, p: rsw.potential_energy(s, g, p),
    }
    rp = _ray_params(args, grid, f, Cg)
    if args.with_packets:
        packets = lattice_packets(args.sqrt_npackets, grid.Lx, grid.Ly, k0=_k0(args, f, Cg),
                                  k_ring=args.k_ring, device=grid.device)
    else:
        packets = lattice_packets(1, grid.Lx, grid.Ly, k0=1.0, device=grid.device)
    return Case(model, psih_fn, rp, sol0, packets, f, Cg, diags, "rsw")


def setup_swqg(args) -> Case:
    """The ``swqg`` subcommand's model, IC, packets and diagnostics; sets
    ``args.dt``."""
    from ..coupled.initial_conditions import random_band_psih
    from ..models import swqg
    from ..rays.packets import lattice_packets

    grid, dt, nu, rng = _setup(args)
    args.dt = dt
    f, Cg = args.f, args.cg
    model = swqg.make_model(grid, nu=nu, nnu=args.nnu, f=f, Cg=Cg)
    psih0 = random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag)
    sol0 = swqg.pv_from_streamfunction(psih0, grid, model.params)

    def psih_fn(s):
        return swqg.streamfunction_from_pv(s, grid, model.params)

    rp = _ray_params(args, grid, f, Cg)
    packets = lattice_packets(args.sqrt_npackets, grid.Lx, grid.Ly, k0=_k0(args, f, Cg),
                              k_ring=args.k_ring, device=grid.device)
    diags = {
        "energy": lambda s, g, p: swqg.energy(s, g, p),
        "enstrophy": lambda s, g, p: swqg.enstrophy(s, g, p),
    }
    return Case(model, psih_fn, rp, sol0, packets, f, Cg, diags, "swqg")


def schedule(args) -> tuple[int, int, int]:
    """(spinup steps, frames, flow steps per frame) of a run."""
    spinup_steps = int(args.spinup_T / args.dt)
    frames = max(int((args.T - args.spinup_T) / args.output_dt), 1)
    steps_per_frame = max(int(args.output_dt / args.dt), 1)
    return spinup_steps, frames, steps_per_frame


def make_driver(args, case: Case, snapshot_writer=None, packet_writer=None,
                log_fn: Callable = print):
    """The ``CoupledDriver`` of a parsed command line and its ``Case``."""
    from ..coupled.driver import CoupledDriver

    adaptive = args.ray_method in ("adaptive", "adaptive7")
    return CoupledDriver(
        model=case.model, psih_fn=case.psih_fn, rp=case.rp, dt=args.dt,
        stepper=args.stepper, use_filter=args.use_filter,
        ray_substeps=args.ray_substeps, ray_method=args.ray_method,
        ray_opts=dict(rtol=args.ray_rtol, atol=args.ray_atol,
                      max_steps=args.ray_max_steps) if adaptive else None,
        k_cutoff=100.0 * case.f / case.Cg, k0=_k0(args, case.f, case.Cg),
        frozen_flow=args.frozen_flow,
        snapshot_writer=snapshot_writer, packet_writer=packet_writer,
        diagnostics=case.diagnostics, log_fn=log_fn,
    )


def _writers(args, default_base):
    from ..io.output import SequencedWriter

    base = args.base_filename or default_base
    snap = SequencedWriter(os.path.join(args.out_dir, base), args.max_writes)
    pkts = SequencedWriter(os.path.join(args.out_dir, "packets"), args.max_writes)
    return snap, pkts


def _run_coupled(args, case: Case, log_fn: Callable):
    snap_w, pkt_w = _writers(args, case.base)
    drv = make_driver(args, case, snap_w, pkt_w, log_fn)
    drv.init(case.sol0, case.packets)
    if args.restore:
        drv.restore(args.restore)
    spinup_steps, frames, steps_per_frame = schedule(args)
    drv.spinup(spinup_steps)
    drv.run(frames, steps_per_frame)
    drv.save_diagnostics(os.path.join(args.out_dir, "diagnostics.h5"))
    if args.checkpoint:
        drv.checkpoint(args.checkpoint)
    drv.close()
    log_fn(f"done: t={float(drv.sim.clock.t):.3f}, {frames} frames -> {args.out_dir}")
    return drv


def cmd_rsw(args, log_fn: Callable = print):
    """RSW turbulence + packets."""
    return _run_coupled(args, setup_rsw(args), log_fn)


def cmd_swqg(args, log_fn: Callable = print):
    """SWQG turbulence + packets."""
    return _run_coupled(args, setup_swqg(args), log_fn)


def cmd_analyze(args, log_fn: Callable = print):
    """Offline analysis suite over one or more finished run directories."""
    from ..analysis.suite import analyze_run, analyze_runs

    device = _device(args.platform)
    if len(args.run_dir) > 1:
        reports, idx = analyze_runs(args.run_dir, base=args.base,
                                    out_dir=args.figures_dir or "figures", device=device)
        for rep in reports:
            log_fn(f"report: {rep.run_id} Ro={rep.rossby:.3f} Fr={rep.froude:.3f}")
        log_fn(f"index: {idx}")
        return reports
    rep, figs = analyze_run(args.run_dir[0], base=args.base, out_dir=args.figures_dir,
                            device=device)
    log_fn(f"report: {rep.run_id} Ro={rep.rossby:.3f} Fr={rep.froude:.3f} "
           f"figures={sorted(figs)}")
    return rep


def _cmd_unported(name: str, item: str, args, log_fn: Callable = print):
    raise _not_ported(f"the {name} subcommand", item)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="juliaraytracingsw_tpu_torch.experiments")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("rsw", help="RSW turbulence (+ optional packets)")
    _add_common(p)
    _add_packets(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f-over-cg", type=float, default=3.0)
    p.add_argument("--model", default="rsw",
                   choices=["rsw", "linborg", "modified", "quadheight"],
                   help="shallow-water variant; only 'rsw' is ported "
                        "(the others: ROADMAP queue 1, item 8)")
    p.add_argument("--ic", default="band", choices=["band", "front"])
    p.add_argument("--Kg", type=float, nargs=2, default=(10, 13))
    p.add_argument("--Kw", type=float, nargs=2, default=(0, 5))
    p.add_argument("--ag", type=float, default=1.5)
    p.add_argument("--aw", type=float, default=0.1)
    p.add_argument("--with-packets", action="store_true", default=True)
    p.set_defaults(fn=cmd_rsw)

    p = sub.add_parser("swqg", help="SWQG turbulence + packets")
    _add_common(p)
    _add_packets(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f", type=float, default=3.0)
    p.add_argument("--Kg", type=float, nargs=2, default=(10, 13))
    p.add_argument("--ag", type=float, default=0.5)
    p.set_defaults(fn=cmd_swqg)

    p = sub.add_parser("analyze", help="offline analysis suite over run dirs")
    p.add_argument("run_dir", nargs="+")
    p.add_argument("--base", default="rsw")
    p.add_argument("--figures-dir", default=None)
    _add_platform(p)
    p.set_defaults(fn=cmd_analyze)

    for name, item in _UNPORTED_COMMANDS.items():
        p = sub.add_parser(name, help=f"not ported (ROADMAP queue 1, {item})")
        p.set_defaults(fn=partial(_cmd_unported, name, item))
    return ap


def run(argv=None, log_fn: Callable = print):
    """Parse ``argv`` and run its subcommand; returns the coupled run's
    ``CoupledDriver`` or the analysis report(s). Every line the run prints
    goes to ``log_fn``."""
    ap = build_parser()
    # an unported subcommand takes the JAX command line's arguments unread
    args, extra = ap.parse_known_args(argv)
    if extra and args.cmd not in _UNPORTED_COMMANDS:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args, log_fn)


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
