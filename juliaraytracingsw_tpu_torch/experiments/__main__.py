"""Command line of the port (port of ``experiments/__main__.py``).

    python -m juliaraytracingsw_tpu_torch.experiments rsw --nx 256 --out-dir run
    python -m juliaraytracingsw_tpu_torch.experiments analyze run
    python -m juliaraytracingsw_tpu_torch.experiments swqg --platform cpu ...

Subcommands ported:

    rsw                  RSW turbulence + packet ensemble, ``--model``
                         rsw|linborg|modified|quadheight, with the
                         band-limited geostrophic + wave IC (``--ic band``)
                         or random wave fronts (``--ic front``)
    swqg                 SWQG turbulence + packets
    twolayer             two-layer QG + packets (``--baroclinic``: the
                         baroclinic advecting flow; ``--ic-file``: a
                         ``twolayer-simulation`` file; ``--nlayers n > 2``:
                         the n-layer model, packets in the depth-weighted
                         mean flow)
    twolayer-simulation  two-layer spin-up writing an initial-condition file
                         (``--freely-evolving``: FilteredAB3)
    thomasyamada         two-phase Thomas-Yamada run (``--restart-file``)
    single-wave          one enveloped wave injected into spun-up RSW, with
                         two packets at its centre
    steady-raytracing    packets through a frozen snapshot (a band-limited
                         streamfunction or ``--snapshot-file``)
    sweep                one run of an experiment per row of a sweep table
                         (``--task``, ``JRSW_SWEEP_INDEX``,
                         ``SLURM_ARRAY_TASK_ID``)
    omega-k              per-k frequency spectra of a finished run
                         (``--model rsw|ty``, ``--stft-window``,
                         ``--mem-cap-gb``, ``--fanout``)
    omega-k-plot         radial (omega, K) power from the per-k files
    b-parameter          ray diffusivity b from the per-k psi rows
    analyze              offline analysis suite over finished run dirs

Common flow per run: derive dt from the CFL tune and the hyperviscosity,
build the model and the ``CoupledDriver``, spin up, then coupled frames
with rolling HDF5 outputs (``<base>.%06d.h5``, ``packets.%06d.h5``),
diagnostics (``diagnostics.h5``) and, with ``--checkpoint``, a checkpoint
that either package restores. The files are the JAX package's.

The coupled subcommands take ``--birth-death`` (Weibull resampling of
the ensemble, seeded by ``--seed``) and ``--live N`` (a dashboard,
``live.png``/``live.html``, every N frames; needs matplotlib).

``--sharded`` (``rsw``, every ``--model``; ``swqg``; ``twolayer``, with
``--nlayers``; ``thomasyamada``) runs the flow slab-sharded over a process
mesh (``parallel/sharded``: the state in kr-column blocks, slab FFTs, the
interpolation fields gathered to every rank, each rank its block of the
packets); its checkpoints hold the unsharded state, so they restore at
any mesh size and in either package, and only rank 0 writes files.
``--distributed`` first joins the job's processes into one
``torch.distributed`` group from the scheduler's environment
(``parallel/launcher.resolve_cluster``: SLURM, mpirun, or
``JRSW_COORDINATOR``/``JRSW_NUM_PROCESSES``/``JRSW_PROCESS_ID``), one
process per GPU; without it the mesh is this one process.

``--platform`` names the torch device (default ``cuda``); without a card
the run fails and says to pass ``--platform cpu``. ``omega-k-plot`` and
``b-parameter`` are host analyses (numpy, h5py).
"""
from __future__ import annotations

import argparse
import os
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["build_parser", "run", "main", "Case", "setup_rsw", "setup_swqg",
           "setup_twolayer", "setup_single_wave", "setup_thomasyamada", "SETUPS",
           "inject", "start_clock", "schedule", "make_driver", "steady_raytracing",
           "make_sharded", "run_sharded", "ShardedRun"]


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
                   help="join the job's processes (one per GPU) into one "
                        "torch.distributed group from the scheduler's environment "
                        "(SLURM, mpirun, or JRSW_COORDINATOR/JRSW_NUM_PROCESSES/"
                        "JRSW_PROCESS_ID); needs --sharded on more than one process")
    p.add_argument("--sharded", action="store_true",
                   help="run the flow slab-sharded over the process mesh (kr-column "
                        "state blocks, slab FFTs, gathered ray fields, packets split "
                        "over the ranks); IF-AB3, fixed-step rays")
    p.add_argument("--checkpoint", default=None,
                   help="write a resumable checkpoint here at the end")
    p.add_argument("--restore", default=None,
                   help="resume from a checkpoint file (of either package)")
    p.add_argument("--live", type=int, default=0, metavar="N",
                   help="refresh a live dashboard (<out-dir>/live.html, live.png) "
                        "every N frames; needs matplotlib")


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
                   help="Weibull birth/death resampling of the ensemble (its "
                        "random stream seeded by --seed)")
    p.add_argument("--bd-k-shape", type=float, default=1.5,
                   help="Weibull shape parameter of packet lifetimes")
    p.add_argument("--bd-lam", type=float, default=10.0,
                   help="Weibull scale of packet lifetimes")


def _device(platform: str) -> torch.device:
    """The torch device ``--platform`` names; no CUDA device means failure,
    never a silent run on the CPU."""
    device = torch.device(platform)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--platform {platform}: no CUDA device is available "
                         "(torch.cuda.is_available() is false); pass --platform cpu "
                         "to run on the CPU")
    return device


def _init_distributed(args, log_fn: Callable) -> None:
    """``--distributed``: bring up the job's process group (NCCL on the
    card, each rank on its own GPU; gloo on the CPU)."""
    if not getattr(args, "distributed", False):
        return
    import torch.distributed as dist

    from ..parallel.launcher import initialize_from_env

    spec = initialize_from_env(device=_device(args.platform))
    if spec.process_id == 0:
        log_fn(f"distributed: {spec.source} process {spec.process_id}/{spec.num_processes}")
    if dist.is_initialized() and dist.get_world_size() > 1 and not args.sharded:
        raise SystemExit("--distributed over more than one process needs --sharded: "
                         "only the sharded flow splits the work between the processes")


def _setup(args, log_fn: Callable = print):
    from ..core.grid import make_grid
    from ..coupled.driver import derive_dt, derive_nu

    _init_distributed(args, log_fn)
    grid = make_grid(args.nx, Lx=args.L, device=_device(args.platform))
    dt = derive_dt(args.cfltune, args.umax_estimate, grid.dx)
    nu = derive_nu(args.nutune, args.nx, args.nnu, dt)
    rng = np.random.default_rng(args.seed)
    return grid, dt, nu, rng


class Case(NamedTuple):
    """What a coupled subcommand builds before it runs: the model, the
    advecting streamfunction, the resolved ray parameters, the initial
    state, the diagnostics and the default snapshot file base; ``k0`` the
    packets' reset wavenumber where it is not the command line's
    (``single-wave``), ``t0`` the start time where it is not 0
    (``twolayer --ic-file``)."""

    model: object
    psih_fn: Callable
    rp: object
    sol0: torch.Tensor
    packets: object
    f: float
    Cg: float
    diagnostics: dict
    base: str
    k0: float | None = None
    t0: float | None = None


def _k0(args, f: float, Cg: float) -> float:
    return float(np.sqrt((args.omega0_over_f * f) ** 2 - f * f) / Cg)


def _ray_params(args, grid, f: float, Cg: float):
    from ..rays.raytrace import RayParams, resolve_gather

    rp = RayParams(f=f, Cg=Cg, x0=float(grid.x[0]), y0=float(grid.y[0]),
                   dx=grid.dx, dy=grid.dy, interp=args.interp,
                   table_dtype=args.table_dtype, gather=args.gather)
    return resolve_gather(rp, args.sqrt_npackets ** 2, grid.ny, grid.nx)


def _rsw_psih_fn(grid, f: float, Cg: float):
    """PV inversion of an RSW (u, v, eta) state: the advecting
    streamfunction."""
    def psih_fn(sol):
        Kd2 = f * f / (Cg * Cg)
        qh = grid.ik * sol[1] - grid.il * sol[0] - f * sol[2]
        return -qh / (grid.Krsq + Kd2)
    return psih_fn


def _rsw_diagnostics(rsw):
    return {
        "kinetic_energy": lambda s, g, p: rsw.kinetic_energy(s, g),
        "potential_energy": lambda s, g, p: rsw.potential_energy(s, g, p),
    }


def setup_rsw(args, log_fn: Callable = print) -> Case:
    """The ``rsw`` subcommand's model (``--model``), IC, packets and
    diagnostics; sets ``args.dt``."""
    from ..core.spectral import irfft2, rfft2
    from ..coupled.initial_conditions import band_geo_wave_ic, front_ic
    from ..models import linborg, modified_sw, quadheight, rsw
    from ..rays.packets import lattice_packets

    grid, dt, nu, rng = _setup(args, log_fn)
    args.dt = dt
    f, Cg = args.f_over_cg * args.cg, args.cg
    factory = {"rsw": rsw, "linborg": linborg, "modified": modified_sw,
               "quadheight": quadheight}[args.model]
    model = factory.make_model(grid, nu=nu, nnu=args.nnu, f=f, Cg=Cg)
    if args.ic == "front":
        sol0 = front_ic(grid, rng, n_waves=10, aw=args.aw, f=f, Cg=Cg)
    else:
        sol0 = band_geo_wave_ic(grid, rng, Kg=tuple(args.Kg), Kw=tuple(args.Kw),
                                ag=args.ag, aw=args.aw, f=f, Cg=Cg)

    if args.model == "quadheight":
        # prognostic m = 1/(1 + eta): convert the (u, v, eta) IC
        sol0 = quadheight.set_solution(sol0[0], sol0[1], sol0[2], grid)
        eta_psih_fn = _rsw_psih_fn(grid, f, Cg)

        def psih_fn(sol):
            # eta = 1/m - 1, then the PV inversion
            etah = rfft2(1.0 / irfft2(sol[2], grid.nx) - 1.0)
            return eta_psih_fn(torch.stack([sol[0], sol[1], etah]))

        diags = {
            "kinetic_energy": lambda s, g, p: quadheight.kinetic_energy(s, g),
            "potential_energy": lambda s, g, p: quadheight.potential_energy(s, g, p),
        }
    else:
        psih_fn = _rsw_psih_fn(grid, f, Cg)
        diags = _rsw_diagnostics(rsw)

    rp = _ray_params(args, grid, f, Cg)
    if args.with_packets:
        packets = lattice_packets(args.sqrt_npackets, grid.Lx, grid.Ly, k0=_k0(args, f, Cg),
                                  k_ring=args.k_ring, device=grid.device)
    else:
        packets = lattice_packets(1, grid.Lx, grid.Ly, k0=1.0, device=grid.device)
    return Case(model, psih_fn, rp, sol0, packets, f, Cg, diags, args.model)


def setup_swqg(args, log_fn: Callable = print) -> Case:
    """The ``swqg`` subcommand's model, IC, packets and diagnostics; sets
    ``args.dt``."""
    from ..coupled.initial_conditions import random_band_psih
    from ..models import swqg
    from ..rays.packets import lattice_packets

    grid, dt, nu, rng = _setup(args, log_fn)
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


def _twolayer_ic_file(args, grid, U: float, mu: float, log_fn: Callable):
    """Adopt an initial-condition file's psih, t0, dt, U, mu and drho/rho0
    (the layout ``twolayer-simulation`` writes and the reference reads);
    nu is re-derived for the adopted dt -> (psih0, U, mu, nu, t0)."""
    from ..coupled.driver import derive_nu
    from ..io.jld2 import load_twolayer_ic

    psih_np, t0, params, dt_file = load_twolayer_ic(args.ic_file)
    Uf = np.asarray(params.get("U", U))
    if Uf.ndim and Uf.size == 2 and not np.isclose(Uf[0], -Uf[1]):
        log_fn(f"WARNING: IC file stores asymmetric layer velocities U={Uf.tolist()}; "
               f"this model supports only (+U, -U) and adopts max|U| — results will "
               f"differ from the reference")
    U = float(np.max(np.abs(Uf))) if Uf.ndim else float(Uf)
    mu = float(params.get("μ", mu))
    dt = args.dt = float(dt_file)
    nu = derive_nu(args.nutune, args.nx, args.nnu, dt)
    bfield = np.asarray(params.get("b", ()))
    if bfield.size == 2 and bfield[0] != 0:
        args.drho_rho0 = float((bfield[0] - bfield[1]) / bfield[0])
    log_fn(f"IC file {args.ic_file}: t0={t0:.3f} U={U} mu={mu} dt={dt} "
           f"drho_rho0={args.drho_rho0} (file values adopted)")
    if psih_np.shape != (2, grid.ny, grid.nkr):
        raise SystemExit(f"IC psih shape {psih_np.shape} does not match grid "
                         f"(2, {grid.ny}, {grid.nkr}) — pass the matching --nx")
    psih0 = torch.as_tensor(np.asarray(psih_np, np.complex64), device=grid.device)
    return psih0, U, mu, nu, float(t0)


def _setup_multilayer(args, grid, nu, rng, f, Cg) -> Case:
    """``twolayer --nlayers n`` with n > 2: the n-layer model (equal depths,
    shear spread linearly from +U to -U, F/2 per interface), packets
    advected by the depth-weighted mean streamfunction."""
    from ..coupled.initial_conditions import random_band_psih
    from ..models import multilayerqg as mlqg
    from ..rays.packets import lattice_packets

    if args.ic_file:
        raise SystemExit("--ic-file is two-layer-only (its reference layout stores "
                         "exactly two layers)")
    if args.baroclinic:
        raise SystemExit("--baroclinic is two-layer-only; the n-layer path advects with "
                         "the depth-weighted barotropic mean")
    n, U = args.nlayers, args.U
    F = 2.0 * f * f / (Cg * Cg) / args.drho_rho0
    model = mlqg.make_model(grid, U=tuple(float(u) for u in np.linspace(U, -U, n)),
                            beta=0.0, mu=args.mu, nu=nu, nnu=args.nnu,
                            Fcoup=tuple(F / 2.0 for _ in range(n - 1)))
    psih0 = torch.stack([random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag)
                         for _ in range(n)])
    sol0 = mlqg.pv_from_streamfunction(psih0, grid, model.params)
    psi_from_q = model.extras["psi_from_q"]
    w = torch.as_tensor(np.asarray(model.params.delta, np.float32),
                        device=grid.device)[:, None, None]

    def psih_fn(s):
        return (w * psi_from_q(s)).sum(0)

    rp = _ray_params(args, grid, f, Cg)
    packets = lattice_packets(args.sqrt_npackets, grid.Lx, grid.Ly, k0=_k0(args, f, Cg),
                              k_ring=args.k_ring, device=grid.device)
    # the model's S^-1 table, not one inverted on the host at each call:
    # the driver's frame tail runs them inside a CUDA graph
    diags = {
        "kinetic_energy": lambda s, g, p: torch.stack(
            mlqg.kinetic_energy(s, g, p, psih=psi_from_q(s))),
        "potential_energy": lambda s, g, p: torch.stack(
            mlqg.potential_energy(s, g, p, psih=psi_from_q(s))),
    }
    return Case(model, psih_fn, rp, sol0, packets, f, Cg, diags, f"{n}Lqg")


def setup_twolayer(args, log_fn: Callable = print) -> Case:
    """The ``twolayer`` subcommand's model, IC (``--ic-file`` or two
    band-limited layers), packets and diagnostics; sets ``args.dt``."""
    from ..coupled.initial_conditions import random_band_psih
    from ..models import twolayerqg
    from ..rays.packets import lattice_packets

    grid, dt, nu, rng = _setup(args, log_fn)
    args.dt = dt
    f, Cg = args.f, args.cg
    if args.nlayers > 2:
        return _setup_multilayer(args, grid, nu, rng, f, Cg)
    U, mu, psih0, t0 = args.U, args.mu, None, None
    if args.ic_file:
        psih0, U, mu, nu, t0 = _twolayer_ic_file(args, grid, U, mu, log_fn)
    model = twolayerqg.make_model(grid, U=U, mu=mu, nu=nu, nnu=args.nnu, f0=f, Cg=Cg,
                                  drho_rho0=args.drho_rho0)
    if psih0 is None:
        psih0 = torch.stack([random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag)
                             for _ in range(2)])
    sol0 = twolayerqg.pv_from_streamfunction(psih0, grid, model.params)
    sgn = -1.0 if args.baroclinic else 1.0

    def psih_fn(s):
        # barotropic (psi1 + psi2)/2 or baroclinic (psi1 - psi2)/2 advection
        psih = twolayerqg.streamfunction_from_pv(s, grid, model.params)
        return 0.5 * (psih[0] + sgn * psih[1])

    rp = _ray_params(args, grid, f, Cg)
    packets = lattice_packets(args.sqrt_npackets, grid.Lx, grid.Ly, k0=_k0(args, f, Cg),
                              k_ring=args.k_ring, device=grid.device)
    diags = {
        "kinetic_energy": lambda s, g, p: torch.stack(twolayerqg.kinetic_energy(s, g, p)),
        "potential_energy": lambda s, g, p: twolayerqg.potential_energy(s, g, p),
    }
    return Case(model, psih_fn, rp, sol0, packets, f, Cg, diags, "2Lqg", t0=t0)


def setup_single_wave(args) -> Case:
    """The ``single-wave`` subcommand's RSW model, geostrophic IC (no wave
    part), the two packets (one per branch) at the envelope's centre with
    the injected wavevector, and diagnostics; sets ``args.dt``. The wave
    itself is injected after the spinup (``inject``)."""
    from ..coupled.initial_conditions import band_geo_wave_ic
    from ..models import rsw
    from ..rays.packets import Packets
    from ..rays.raytrace import RayParams, resolve_gather

    grid, dt, nu, rng = _setup(args)
    args.dt = dt
    f, Cg = args.f_over_cg * args.cg, args.cg
    model = rsw.make_model(grid, nu=nu, nnu=args.nnu, f=f, Cg=Cg)
    sol0 = band_geo_wave_ic(grid, rng, Kg=tuple(args.Kg), Kw=(0, 0), ag=args.ag, aw=0.0,
                            f=f, Cg=Cg)
    rp = RayParams(f=f, Cg=Cg, x0=float(grid.x[0]), y0=float(grid.y[0]), dx=grid.dx,
                   dy=grid.dy, interp=args.interp, table_dtype=args.table_dtype,
                   gather=args.gather)
    rp = resolve_gather(rp, 2, grid.ny, grid.nx)
    k0 = float(grid.kr[args.k0_idx])
    l0 = float(grid.l[args.l0_idx])

    def col(a, b):
        return torch.tensor([a, b], dtype=torch.float32, device=grid.device)

    packets = Packets(x=col(args.wave_x0, args.wave_x0), y=col(args.wave_y0, args.wave_y0),
                      k=col(k0, k0), l=col(l0, l0), sign=col(1.0, -1.0))
    return Case(model, _rsw_psih_fn(grid, f, Cg), rp, sol0, packets, f, Cg,
                _rsw_diagnostics(rsw), "single_wave", k0=k0)


def inject(args, case: Case, sol: torch.Tensor) -> torch.Tensor:
    """``single-wave``: the spun-up state with the enveloped wave in place
    of its wave part."""
    from ..coupled.single_wave import inject_single_wave

    return inject_single_wave(sol, case.model.grid, case.model.params, x0=args.wave_x0,
                              y0=args.wave_y0, k0_idx=args.k0_idx, l0_idx=args.l0_idx,
                              env_size=args.env_size, aw=args.aw)


def setup_thomasyamada(args, log_fn: Callable = print):
    """The ``thomasyamada`` subcommand's run configuration
    (``coupled/ty_driver.TYRunConfig``): ETDRK4 unless ``--stepper`` names
    another than IFMAB3, a startup phase at ``startup_dt_factor`` times the
    main dt."""
    from ..coupled.ty_driver import TYRunConfig

    _init_distributed(args, log_fn)
    device = _device(args.platform)
    stepper = args.stepper if args.stepper != "IFMAB3" else "ETDRK4"
    dt = args.ty_dt
    coarse = dt * args.startup_dt_factor
    return TYRunConfig(
        nx=args.nx, Lx=args.L, nu=args.ty_nu, nnu=args.ty_nnu, Ro=args.Ro,
        stepper=stepper, startup_dt=coarse,
        startup_nsteps=int(args.startup_T / coarse),
        startup_nsubs=max(int(args.output_dt / coarse), 1),
        dt=dt, nsteps=int(args.T / dt), nsubs=max(int(args.output_dt / dt), 1),
        k0g_range=tuple(args.Kg), k0w_range=tuple(args.Kw),
        at=args.at, ag=args.ag, aw=args.aw, seed=args.seed,
        restart_file=args.restart_file, restart_frame=args.restart_frame,
        out_dir=args.out_dir, base_filename=args.base_filename or "ty",
        max_writes=args.max_writes, log_fn=log_fn, device=str(device),
    )


# the coupled subcommands' set-up functions: parsed arguments -> Case
SETUPS = {"rsw": setup_rsw, "swqg": setup_swqg, "twolayer": setup_twolayer,
          "single-wave": setup_single_wave}


def schedule(args) -> tuple[int, int, int]:
    """(spinup steps, frames, flow steps per frame) of a run."""
    spinup_steps = int(args.spinup_T / args.dt)
    frames = max(int((args.T - args.spinup_T) / args.output_dt), 1)
    steps_per_frame = max(int(args.output_dt / args.dt), 1)
    return spinup_steps, frames, steps_per_frame


def make_driver(args, case: Case, snapshot_writer=None, packet_writer=None,
                log_fn: Callable = print):
    """The ``CoupledDriver`` of a parsed command line and its ``Case``
    (with ``--live``, its dashboard)."""
    from ..coupled.driver import CoupledDriver

    adaptive = args.ray_method in ("adaptive", "adaptive7")
    k0 = case.k0 if case.k0 is not None else _k0(args, case.f, case.Cg)
    live = None
    if getattr(args, "live", 0):
        from ..utils.live import LiveDashboard

        live = LiveDashboard(args.out_dir, title=case.base, every=args.live)
    return CoupledDriver(
        model=case.model, psih_fn=case.psih_fn, rp=case.rp, dt=args.dt,
        stepper=args.stepper, use_filter=args.use_filter,
        ray_substeps=args.ray_substeps, ray_method=args.ray_method,
        ray_opts=dict(rtol=args.ray_rtol, atol=args.ray_atol,
                      max_steps=args.ray_max_steps) if adaptive else None,
        k_cutoff=100.0 * case.f / case.Cg, k0=k0,
        frozen_flow=args.frozen_flow,
        birth_death=args.birth_death, bd_k_shape=args.bd_k_shape, bd_lam=args.bd_lam,
        bd_seed=args.seed,
        snapshot_writer=snapshot_writer, packet_writer=packet_writer,
        diagnostics=case.diagnostics, log_fn=log_fn, live=live,
    )


def _writers(args, default_base):
    from ..io.output import SequencedWriter

    base = args.base_filename or default_base
    snap = SequencedWriter(os.path.join(args.out_dir, base), args.max_writes)
    pkts = SequencedWriter(os.path.join(args.out_dir, "packets"), args.max_writes)
    return snap, pkts


def start_clock(case: Case, device):
    """The run's first clock: ``case.t0`` (an IC file's) or 0."""
    from ..core.steppers import Clock

    if not case.t0:
        return None
    return Clock(torch.tensor(case.t0, dtype=torch.float32, device=device), 0)


def _run_coupled(args, case: Case, log_fn: Callable, after_spinup: Callable | None = None):
    snap_w, pkt_w = _writers(args, case.base)
    try:
        drv = make_driver(args, case, snap_w, pkt_w, log_fn)
    except ValueError as exc:   # a configuration the driver refuses (--stepper ETDRK4 of a block L)
        raise SystemExit(str(exc)) from exc
    drv.init(case.sol0, case.packets, clock=start_clock(case, case.sol0.device))
    if args.restore:
        drv.restore(args.restore)
    spinup_steps, frames, steps_per_frame = schedule(args)
    drv.spinup(spinup_steps)
    if after_spinup is not None:
        drv.sim = drv.sim._replace(sol=after_spinup(drv.sim.sol))
    drv.run(frames, steps_per_frame)
    drv.save_diagnostics(os.path.join(args.out_dir, "diagnostics.h5"))
    if args.checkpoint:
        drv.checkpoint(args.checkpoint)
    drv.close()
    log_fn(f"done: t={float(drv.sim.clock.t):.3f}, {frames} frames -> {args.out_dir}")
    return drv


class ShardedRun(NamedTuple):
    """A finished ``--sharded`` run: the sharded model, the rank's state
    block, clock and AB3 history, the rank's packets and the diagnostics
    (every rank holds the same series)."""

    sh: object
    sol: torch.Tensor
    clock: object
    state: object
    packets: object
    diag_times: list
    diag_series: dict


class _NullWriter:
    """The writer of a rank other than 0: takes every write, keeps nothing."""

    def write(self, *args, **kw):
        pass

    write_frame = write_packets = write

    def flush(self):
        pass

    close = flush


# the sharded class of each model of a coupled subcommand (Model.name)
_SHARDED = {"rsw": ("sharded_rsw", "ShardedRSW"),
            "linborg_sw": ("sharded_rsw", "ShardedLinborg"),
            "modified_sw": ("sharded_rsw", "ShardedModifiedSW"),
            "quadheight_sw": ("sharded_rsw", "ShardedQuadHeight"),
            "swqg": ("sharded", "ShardedSWQG"),
            "twolayerqg": ("sharded", "ShardedTwoLayerQG"),
            "multilayerqg": ("sharded", "ShardedMultiLayerQG")}


def make_sharded(args, case: Case, mesh):
    """The sharded counterpart of ``case.model`` on ``mesh`` (a two-layer
    model advects by the baroclinic streamfunction with ``--baroclinic``)."""
    import importlib

    module, name = _SHARDED[case.model.name]
    cls = getattr(importlib.import_module(f"..parallel.{module}", __package__), name)
    kw = {}
    if case.model.name == "twolayerqg":
        kw["advect"] = "baroclinic" if args.baroclinic else "barotropic"
    return cls(case.model.grid, case.model.params, mesh, dt=args.dt, interp=args.interp, **kw)


def _check_sharded_options(args) -> None:
    """The options a sharded run does not take exit before it starts."""
    from ..parallel.sharded import SHARDED_RAY_METHODS

    refused = [flag for flag, on in (("--frozen-flow", args.frozen_flow),
                                     ("--birth-death", args.birth_death),
                                     ("--live", args.live), ("--use-filter", args.use_filter),
                                     (f"--stepper {args.stepper}",
                                      args.stepper not in ("IFMAB3", "ETDAB3"))) if on]
    if refused:
        raise SystemExit(f"--sharded does not support {' '.join(refused)} (the sharded "
                         "flow steps IF-AB3 without a filter; use the replicated driver)")
    if args.ray_method not in SHARDED_RAY_METHODS:
        raise SystemExit(f"--sharded supports --ray-method {'|'.join(SHARDED_RAY_METHODS)}")


def run_sharded(args, case: Case, sh, snapshot_writer=None, packet_writer=None,
                log_fn: Callable = print) -> ShardedRun:
    """The ``--sharded`` host loop on ``sh`` (``make_sharded``): spin-up in
    chunks of 500 steps, then frames of the sharded coupled frame, each
    with the NaN guard, diagnostics of the gathered state, the packet
    telemetry and a snapshot; ``--restore``/``--checkpoint`` read and write
    the unsharded tree ``{sol, clock, N1, N2, packets}``, which restores at
    any mesh size and in either package.

    Every rank calls this with writers or every rank without (writes gather
    over the mesh); only rank 0's writers and log see anything. The NaN
    guard reduces a finite flag over the mesh first, so every rank raises
    together."""
    import time

    from ..core.steppers import AB3State, zero_clock
    from ..io.checkpoint import load_checkpoint, save_checkpoint
    from ..parallel.mesh import (all_gather, all_reduce_finite, gather_packets,
                                 shard_packets)
    from ..rays.raytrace import sample_gradients, sample_velocity

    mesh = sh.mesh
    lead = mesh.rank == 0
    log = log_fn if lead else (lambda line: None)
    model, rp = case.model, case.rp
    grid, dt = model.grid, args.dt
    if snapshot_writer is not None:
        from ..io.output import save_problem

        save_problem(snapshot_writer, grid, model.params, dt)
    if packet_writer is not None:
        for key, value in (("params/f0", rp.f), ("params/Cg", rp.Cg), ("params/dt", dt),
                           ("params/N", case.packets.n),
                           ("params/omega_sign", case.packets.sign)):
            packet_writer.write(key, value)

    init_fn, step_fn = sh.stepper()
    sol = sh.shard_solution(case.sol0)
    clock = start_clock(case, mesh.device) or zero_clock(device=mesh.device)
    state = init_fn(sol)
    pk = shard_packets(case.packets, mesh)

    def ckpt_tree():
        return {"sol": sh.unshard(sol), "clock": clock, "N1": sh.unshard(state.N1),
                "N2": sh.unshard(state.N2), "packets": gather_packets(pk, mesh)}

    if args.restore:
        tree = load_checkpoint(args.restore, ckpt_tree())
        sol, clock = sh.shard_solution(tree["sol"]), tree["clock"]
        state = AB3State(sh.shard_solution(tree["N1"]), sh.shard_solution(tree["N2"]))
        pk = shard_packets(tree["packets"], mesh)
        log(f"restored {args.restore}: t={float(clock.t):.3f} step={clock.step}")
    t_wall = time.time()

    def check_nan(where):
        if not all_reduce_finite(mesh, sol):
            for w in (snapshot_writer, packet_writer):
                if w is not None:
                    w.flush()
            raise FloatingPointError(f"solution is NaN/Inf at {where}")

    spinup_steps, frames, steps_per_frame = schedule(args)
    done = 0
    while done < spinup_steps:
        n = min(500, spinup_steps - done)
        for _ in range(n):
            sol, clock, state = step_fn(sol, clock, state)
        done += n
        check_nan("spinup")

    frame = sh.make_coupled_frame(rp, steps_per_frame, ray_substeps=args.ray_substeps,
                                  ray_method=args.ray_method, k_cutoff=100.0 * case.f / case.Cg,
                                  k0=_k0(args, case.f, case.Cg))
    diag_times, diag_series = [], {name: [] for name in case.diagnostics}
    for i in range(frames):
        sol, clock, state, pk = frame(sol, clock, state, pk)
        check_nan(f"frame {i}")
        sol_full = sh.unshard(sol)
        fields = sh.fields(sol)
        diag_times.append(float(clock.t))
        for name, fn in case.diagnostics.items():
            diag_series[name].append(_host(fn(sol_full, grid, model.params)))
        if packet_writer is not None:
            rows = [pk.x, pk.y, pk.k, pk.l, *sample_velocity(pk, fields, rp),
                    *sample_gradients(pk, fields, rp)]
            host = _host(all_gather(torch.stack(rows), 1, mesh))

            def cols(lo, hi):
                return np.ascontiguousarray(host[lo:hi].T)

            packet_writer.write_packets(clock.step, float(clock.t), x=cols(0, 2),
                                        k=cols(2, 4), u=cols(4, 6), g=cols(6, 10))
        if snapshot_writer is not None:
            snapshot_writer.write_frame(clock.step, sol=sol_full)
            snapshot_writer.write(f"snapshots/t/{clock.step}", float(clock.t))
        umax = float(fields[:2].abs().max())
        log(f"step: {clock.step:06d}, t: {float(clock.t):.2f}, "
            f"cfl: {dt * umax / min(grid.dx, grid.dy):.2e}, "
            f"wall: {(time.time() - t_wall) / 60:.2f} min [sharded x{mesh.size}]")
    if args.checkpoint:
        tree = ckpt_tree()
        if lead:
            save_checkpoint(args.checkpoint, tree)
        log(f"checkpoint -> {args.checkpoint}")
    return ShardedRun(sh, sol, clock, state, pk, diag_times, diag_series)


def _run_coupled_sharded(args, case: Case, log_fn: Callable) -> ShardedRun:
    """``--sharded``: ``run_sharded`` on the process mesh, rank 0 writing
    the snapshot and packet files and ``diagnostics.h5``."""
    from ..parallel.mesh import make_mesh

    _check_sharded_options(args)
    mesh = make_mesh(device=case.model.grid.device)
    sh = make_sharded(args, case, mesh)
    writers = _writers(args, case.base) if mesh.rank == 0 else (_NullWriter(), _NullWriter())
    res = run_sharded(args, case, sh, *writers, log_fn=log_fn)
    if mesh.rank == 0:
        import h5py

        with h5py.File(os.path.join(args.out_dir, "diagnostics.h5"), "w") as fh:
            fh["t"] = np.asarray(res.diag_times)
            for name, series in res.diag_series.items():
                fh[name] = np.asarray(series)
        log_fn(f"done: t={float(res.clock.t):.3f}, {len(res.diag_times)} frames -> "
               f"{args.out_dir}")
    for w in writers:
        w.close()
    return res


def _coupled(args, case: Case, log_fn: Callable):
    return (_run_coupled_sharded if args.sharded else _run_coupled)(args, case, log_fn)


def _refuse_sharded(args, cmd: str) -> None:
    if getattr(args, "sharded", False):
        raise SystemExit(f"--sharded runs rsw, swqg, twolayer and thomasyamada, not {cmd}")


def cmd_rsw(args, log_fn: Callable = print):
    """RSW turbulence (any ``--model`` variant) + packets."""
    return _coupled(args, setup_rsw(args, log_fn), log_fn)


def cmd_swqg(args, log_fn: Callable = print):
    """SWQG turbulence + packets."""
    return _coupled(args, setup_swqg(args, log_fn), log_fn)


def cmd_twolayer(args, log_fn: Callable = print):
    """Two-layer (or n-layer) QG turbulence + packets."""
    return _coupled(args, setup_twolayer(args, log_fn), log_fn)


def cmd_single_wave(args, log_fn: Callable = print):
    """Spin up RSW turbulence, replace the wave part of the state with one
    enveloped plane wave, and evolve it with the two packets."""
    _refuse_sharded(args, "single-wave")
    case = setup_single_wave(args)
    return _run_coupled(args, case, log_fn, after_spinup=partial(inject, args, case))


def cmd_thomasyamada(args, log_fn: Callable = print):
    """Two-phase Thomas-Yamada run (``--sharded``: on the process mesh,
    IF-AB3) -> (sol, clock, diagnostics)."""
    from ..core.grid import make_grid
    from ..coupled.ty_driver import run_thomasyamada, run_thomasyamada_sharded
    from ..models import thomasyamada

    cfg = setup_thomasyamada(args, log_fn)
    if args.sharded:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh(device=cfg.device)
        if mesh.rank:
            cfg.log_fn = lambda line: None
        sol, clock, diags = run_thomasyamada_sharded(cfg, mesh)
    else:
        sol, clock, diags = run_thomasyamada(cfg)
    grid = make_grid(args.nx, Lx=args.L, device=sol.device)
    ke, pe = thomasyamada.baroclinic_energy(sol, grid)
    cfg.log_fn(f"done: t={float(clock.t):.3f} baroclinic KE={float(ke):.4g} "
           f"PE={float(pe):.4g} wave KE={diags['wave_ke'][-1]:.4g} "
           f"geo KE={diags['geo_ke'][-1]:.4g}")
    return sol, clock, diags


def cmd_twolayer_simulation(args, log_fn: Callable = print):
    """Two-layer spin-up writing an initial-condition file that
    ``twolayer --ic-file`` reads -> its path."""
    import h5py

    from ..core.steppers import zero_clock
    from ..coupled.initial_conditions import random_band_psih
    from ..io.jld2_fixture import write_twolayer_ic
    from ..models import twolayerqg
    from ..models.base import build_stepper, run as run_steps

    _refuse_sharded(args, "twolayer-simulation")
    grid, dt, nu, rng = _setup(args, log_fn)
    model = twolayerqg.make_model(grid, U=args.U, mu=args.mu, nu=nu, nnu=args.nnu,
                                  f0=args.f, Cg=args.cg, drho_rho0=args.drho_rho0)
    psih0 = torch.stack([random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag)
                         for _ in range(2)])
    sol = twolayerqg.pv_from_streamfunction(psih0, grid, model.params)
    stepper = ("FilteredAB3" if args.stepper == "IFMAB3" and args.freely_evolving
               else args.stepper)
    init_fn, step_fn = build_stepper(model, stepper, dt, use_filter=args.use_filter)
    state = init_fn(sol)
    clock = zero_clock(device=grid.device)
    nsteps = int(args.T / dt)
    chunk = max(nsteps // 10, 1)
    done = 0
    while done < nsteps:
        k = min(chunk, nsteps - done)
        sol, clock, state = run_steps(step_fn, sol, clock, state, k)
        done += k
        ke = twolayerqg.kinetic_energy(sol, grid, model.params)
        log_fn(f"t={float(clock.t):8.2f} KE=({float(ke[0]):.4g}, {float(ke[1]):.4g})")
    psih = twolayerqg.streamfunction_from_pv(sol, grid, model.params).cpu().numpy()
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir,
                        f"initial_condition_{grid.nx}x{grid.ny}_U={args.U:.2f}.h5")
    # the reference's layout (snapshots/ψh, a params struct, clock/dt) with
    # the run's own configuration: equal depths, f-plane, buoyancies whose
    # contrast (b1 - b2)/b1 is drho/rho0
    write_twolayer_ic(path, psih, dt=dt, t=float(clock.t), step=clock.step, f0=args.f,
                      beta=0.0, b=(1.0, 1.0 - args.drho_rho0), H=(0.5, 0.5),
                      U=(args.U, -args.U), mu=args.mu)
    with h5py.File(path, "a") as f:
        f["ic/psih"] = psih
        f["ic/qh"] = sol.cpu().numpy()
        for name, val in (("Cg", args.cg), ("nx", grid.nx), ("Lx", grid.Lx)):
            f[f"params_extra/{name}"] = val
    log_fn(f"wrote {path}")
    return path


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


def steady_raytracing(args, packet_writer, log_fn: Callable = print):
    """Packets through a frozen snapshot: a band-limited random
    streamfunction, or ``--snapshot-file``/``--snapshot-key`` (a JLD2/HDF5
    psih). ``--packet-velocity-scale`` s runs the packets on a clock scaled
    by s with Cg/s. Each of the ``T / output_dt`` frames is ``round(s
    output_dt / dt)`` substeps from the frame's start, and its positions,
    wavenumbers and velocities go to ``packet_writer`` (an
    ``io/output.SequencedWriter`` or any object with its
    ``write_packets``/``close``), copied to the host at once ->
    (packets, t)."""
    from ..coupled.initial_conditions import random_band_psih
    from ..rays.packets import lattice_packets
    from ..rays.raytrace import (RayParams, fields_from_psih, raytrace, resolve_gather,
                                 sample_velocity)

    grid, dt, nu, rng = _setup(args)
    f, Cg = args.f, args.cg
    if args.snapshot_file:
        from ..io.jld2 import load_array

        psih = torch.as_tensor(
            load_array(args.snapshot_file, args.snapshot_key).astype(np.complex64),
            device=grid.device)
    else:
        psih = random_band_psih(grid, rng, kband=tuple(args.Kg), amp=args.ag)
    s = args.packet_velocity_scale
    rp = RayParams(f=f, Cg=Cg / s, x0=float(grid.x[0]), y0=float(grid.y[0]), dx=grid.dx,
                   dy=grid.dy, interp=args.interp, table_dtype=args.table_dtype,
                   gather=args.gather)
    rp = resolve_gather(rp, args.sqrt_npackets ** 2, grid.ny, grid.nx)
    fields = fields_from_psih(psih, grid, args.interp)
    packets = lattice_packets(args.sqrt_npackets, grid.Lx, grid.Ly, k0=_k0(args, f, Cg),
                              k_ring=args.k_ring, device=grid.device)
    nframes = max(int(args.T / args.output_dt), 1)
    sub = max(int(round(s * args.output_dt / dt)), 1)
    t = 0.0
    for i in range(nframes):
        packets = raytrace(packets, fields, fields, s * t, s * (t + args.output_dt), rp,
                           nsubsteps=sub, method=args.ray_method)
        t += args.output_dt
        u, v = sample_velocity(packets, fields, rp)
        host = torch.stack([packets.x, packets.y, packets.k, packets.l, u, v]).cpu().numpy()
        packet_writer.write_packets(i, t, x=np.ascontiguousarray(host[0:2].T),
                                    k=np.ascontiguousarray(host[2:4].T),
                                    u=np.ascontiguousarray(host[4:6].T))
    packet_writer.close()
    log_fn(f"done: {nframes} packet frames, t={t:.2f}")
    return packets, t


def cmd_steady_raytracing(args, log_fn: Callable = print):
    """Packets through a frozen snapshot, written to ``packets.%06d.h5``."""
    from ..io.output import SequencedWriter

    _refuse_sharded(args, "steady-raytracing")
    writer = SequencedWriter(os.path.join(args.out_dir, "packets"), args.max_writes)
    return steady_raytracing(args, writer, log_fn)


def cmd_sweep(args, log_fn: Callable = print):
    """Run an experiment of this command line once per row of a sweep
    table, each row's columns as ``--name value`` options, into
    ``<out-dir>/task_<id>``; ``--task`` picks one row (1-based), and so
    do ``JRSW_SWEEP_INDEX`` (0-based) or ``SLURM_ARRAY_TASK_ID`` (1-based)
    under a job array -> the rows run."""
    import shlex
    import subprocess
    import sys

    from ..config.params import load_sweep_table
    from ..parallel.launcher import sweep_row_from_env

    rows = load_sweep_table(args.table)
    if args.task is None and ("SLURM_ARRAY_TASK_ID" in os.environ
                              or "JRSW_SWEEP_INDEX" in os.environ):
        sel = [sweep_row_from_env(rows)]
    else:
        sel = rows if args.task is None else [rows[args.task - 1]]
    procs: list[tuple[str, subprocess.Popen]] = []

    def drain(limit):
        while len(procs) >= limit:
            tid, proc = procs.pop(0)
            if proc.wait() != 0:
                raise SystemExit(f"sweep task {tid} failed rc={proc.returncode}")

    for i, row in enumerate(sel):
        task_id = row.get("ArrayTaskID", str(i + 1))
        extra = []
        for key, val in row.items():
            if key != "ArrayTaskID":
                extra += [f"--{key.replace('_', '-')}", val]
        cmd = [sys.executable, "-m", "juliaraytracingsw_tpu_torch.experiments",
               args.experiment, "--out-dir", os.path.join(args.out_dir, f"task_{task_id}"),
               *extra, *shlex.split(args.extra_args)]
        log_fn(f"sweep task {task_id} : {' '.join(cmd)}")
        drain(args.max_parallel)
        procs.append((task_id, subprocess.Popen(cmd)))
    drain(1)
    return sel


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _run_grid(run_dir: str, base: str, device="cpu"):
    """The reader of a run's snapshot files and its grid."""
    from ..core.grid import make_grid
    from ..io.output import SequencedReader

    reader = SequencedReader(os.path.join(run_dir, base))
    grid = make_grid(int(reader.read("grid/nx")), Lx=float(reader.read("grid/Lx")),
                     device=device)
    return reader, grid


def _omega_k_fanout(args, log_fn: Callable):
    """``--fanout N``: the whole k range as N concurrent omega-k processes
    of this command line on the CPU (each sizing its sub-blocks to
    ``--mem-cap-gb`` / N)."""
    import sys

    from ..parallel.launcher import launch_sweep

    base_cmd = [sys.executable, "-m", "juliaraytracingsw_tpu_torch.experiments", "omega-k",
                args.run_dir, "--base", args.base, "--model", args.model, "--out-dir",
                args.out_dir, "--ntasks", str(args.fanout),
                "--mem-cap-gb", str(args.mem_cap_gb / args.fanout),
                "--stft-window", str(args.stft_window), "--platform", "cpu"]
    if not args.decompose:
        base_cmd.append("--no-decompose")
    rcs = launch_sweep(base_cmd, [{"task": i + 1} for i in range(args.fanout)],
                       os.path.join(args.out_dir, "_logs"), max_parallel=args.fanout,
                       out_flag=None)
    bad = [i + 1 for i, rc in enumerate(rcs) if rc != 0]
    if bad:
        raise SystemExit(f"omega-k fan-out tasks failed: {bad}")
    log_fn(f"fan-out of {args.fanout} omega-k tasks complete")


def cmd_omega_k(args, log_fn: Callable = print):
    """Per-k frequency spectra of a finished run: for the task's k rows
    (``--task``/``--ntasks``), the time series of each row (the wave and
    balanced coefficients c0/cp/cm and psit with ``--decompose``, the
    Thomas-Yamada rows with ``--model ty``, the raw state otherwise),
    detrended, windowed and transformed in time, one
    ``radial_data_k=%03d.h5`` a row; ``--stft-window`` adds sliding-window
    spectra, ``--mem-cap-gb`` bounds the collected series, ``--fanout``
    runs the whole range as concurrent processes. The eigenbases are built
    on ``--platform``; the analysis runs on the host -> files written."""
    import h5py

    from ..analysis.omega_k import (clean_fft, collect_time_series, count_snapshots, hann,
                                    snapshot_shape, stft_omega_k)
    from ..models.rsw import RSWParams
    from ..models.wave_vortex import balanced_wave_bases

    if args.fanout > 0:
        return _omega_k_fanout(args, log_fn)
    reader, grid = _run_grid(args.run_dir, args.base, _device(args.platform))
    nkr = grid.nkr
    job = max(nkr // args.ntasks, 1)
    k_lo = (args.task - 1) * job
    k_hi = nkr if args.task == args.ntasks else min(args.task * job, nkr)
    log_fn(f"task {args.task}/{args.ntasks}: k rows [{k_lo}, {k_hi})")
    kr, ell = _host(grid.kr), _host(grid.l)

    if args.model == "ty":
        from ..models.thomasyamada import ty_bases

        # eigenbases once; sub-blocks slice them. Rows for the cap: 6
        # series, 3 complex-U rows and ~3 rows of FFT temporaries
        ty_full = [_host(b) for b in ty_bases(grid)]
        n_vars = 12
    elif args.decompose:
        f0 = float(reader.read("params/f"))
        Cg2 = float(reader.read("params/Cg2"))
        params = RSWParams(nu=0.0, nnu=4, f=f0, Cg2=Cg2)
        Cg = float(np.sqrt(Cg2))
        bases_full = [_host(b) for b in balanced_wave_bases(grid, params)]
        n_vars = 5   # c0/cp/cm + psit + an FFT temporary
    else:
        shape = snapshot_shape(reader)
        n_vars = int(shape[0]) if shape else 3

    def make_extract(lo, hi):
        """The extract function and the complex-row functions of one k sub-block
        [lo, hi)."""
        complex_rows = {}
        if args.model == "ty":
            # barotropic (ut, vt) from zeta_t, wave/geo-projected baroclinic
            # (ug, vg, uw, vw), and complex U = u + i v, whose one-sided FFT
            # separates the +/- frequency branches
            invK = _host(grid.invKrsq)[:, lo:hi]
            kr_b = kr[None, lo:hi]
            ell_c = ell[:, None]
            Phi0, Phip, Phim = (b[:, :, lo:hi] for b in ty_full)

            def extract(snap):
                blk = snap[:, :, lo:hi]
                psit = -blk[0] * invK
                bc = blk[1:4]
                c0 = np.sum(bc * np.conj(Phi0), axis=0)
                cp = np.sum(bc * np.conj(Phip), axis=0)
                cm = np.sum(bc * np.conj(Phim), axis=0)
                Gh = c0[None] * Phi0
                Wh = cp[None] * Phip + cm[None] * Phim
                return {"ut": -1j * ell_c * psit, "vt": 1j * kr_b * psit,
                        "ug": Gh[0], "vg": Gh[1], "uw": Wh[0], "vw": Wh[1]}

            complex_rows = {
                "U_balanced": lambda s: (s["ut"] + s["ug"]) + 1j * (s["vt"] + s["vg"]),
                "U_wave": lambda s: s["uw"] + 1j * s["vw"],
                "U_total": lambda s: (s["ut"] + s["ug"] + s["uw"])
                + 1j * (s["vt"] + s["vg"] + s["vw"]),
            }
        elif args.decompose:
            bases = [b[:, :, lo:hi] for b in bases_full]
            ikb = 1j * kr[None, lo:hi]
            ilb = 1j * ell[:, None]
            invKKd = 1.0 / (_host(grid.Krsq)[:, lo:hi] + f0 * f0 / Cg2)

            def extract(snap):
                # the eigen-coefficient rows c0/c+/c- of the sub-block (the
                # projection of (u, v, Cg eta) on conj(Phi)) and the
                # geostrophic streamfunction row psit = -qh / (K^2 + Kd^2)
                # that b-parameter reads
                blk = snap[:, :, lo:hi]
                state = np.stack([blk[0], blk[1], Cg * blk[2]])
                out = {name: np.sum(state * np.conj(Phi), axis=0)
                       for name, Phi in zip(("c0", "cp", "cm"), bases)}
                qh = ikb * blk[1] - ilb * blk[0] - f0 * blk[2]
                out["psit"] = -qh * invKKd
                return out
        else:
            def extract(snap):
                return {"sol": snap[..., lo:hi]}

        return extract, complex_rows

    # bounded memory: the task's k range in sub-blocks whose collected
    # (T, ny, block) series fit --mem-cap-gb, one pass over the files each
    T_est = count_snapshots(reader)
    if T_est < 4:
        raise SystemExit("not enough snapshots for a time FFT")
    bytes_per_col = T_est * grid.ny * 16 * max(n_vars, 1)
    cap = int(args.mem_cap_gb * 2 ** 30)
    block = max(1, min(k_hi - k_lo, cap // max(bytes_per_col, 1)))
    n_blocks = -(-(k_hi - k_lo) // block)
    if n_blocks > 1:
        log_fn(f"mem cap {args.mem_cap_gb} GB -> {n_blocks} sub-blocks of <= {block} k rows "
               f"({T_est} snapshots)")

    os.makedirs(args.out_dir, exist_ok=True)
    written = []
    for lo in range(k_lo, k_hi, block):
        hi = min(lo + block, k_hi)
        extract, complex_rows = make_extract(lo, hi)
        t, series = collect_time_series(reader, extract)
        if len(t) < 4:
            raise SystemExit("not enough snapshots for a time FFT")
        w = hann(len(t))
        wsh = w.reshape((len(t),) + (1,) * (series[next(iter(series))].ndim - 1))
        # window-only FFT, so the +/- asymmetry of the complex velocity stays
        u_ffts = {name: np.fft.fft(wsh * fn(series), axis=0)
                  for name, fn in complex_rows.items()}
        for ki in range(lo, hi):
            path = os.path.join(args.out_dir, f"radial_data_k={ki:03d}.h5")
            with h5py.File(path, "w") as out:
                out["t"] = t
                out["k"] = float(kr[ki])
                for name, d in series.items():
                    out[name] = clean_fft(t, d[..., ki - lo], w)
                for name, Uf in u_ffts.items():
                    out[name] = Uf[..., ki - lo]
                if args.stft_window:
                    for name, d in series.items():
                        centers, st_om, spec = stft_omega_k(t, d[..., ki - lo],
                                                            args.stft_window)
                        out[f"stft/{name}"] = spec
                    out["stft/centers"] = centers
                    out["stft/omega"] = st_om
            written.append(path)
    log_fn(f"wrote {len(written)} per-k files -> {args.out_dir}")
    return written


def cmd_omega_k_plot(args, log_fn: Callable = print):
    """Assemble the per-k files into radially binned (omega, K) power of
    each class: ``omega_k_radial.h5`` and one heatmap PNG a class (the
    inertia-gravity dispersion curve over the wave classes of an RSW run)
    -> the file's path."""
    import h5py

    from ..analysis.figures import plot_omega_k_heatmap
    from ..analysis.omega_k import assemble_radial_omega_k

    reader, grid = _run_grid(args.run_dir, args.base)
    omega, radii, power = assemble_radial_omega_k(args.omega_dir, grid,
                                                  names=tuple(args.names.split(",")))
    dispersion = None
    try:
        f0 = float(reader.read("params/f"))
        Cg2 = float(reader.read("params/Cg2"))

        def dispersion(K):
            return np.sqrt(f0 * f0 + Cg2 * K * K)
    except KeyError:
        pass   # runs of other models store no f/Cg2
    os.makedirs(args.out_dir, exist_ok=True)
    out_path = os.path.join(args.out_dir, "omega_k_radial.h5")
    with h5py.File(out_path, "w") as f:
        f["omega"] = omega
        f["K"] = radii
        for name, pw in power.items():
            f[name] = pw
    for name, pw in power.items():
        plot_omega_k_heatmap(omega, radii, pw, args.out_dir, name=f"omega_k_{name}.png",
                             title=f"{name} power",
                             dispersion=dispersion if name in ("cp", "cm", "U_wave") else None)
    log_fn(f"assembled {len(power)} classes -> {out_path}")
    return out_path


def cmd_b_parameter(args, log_fn: Callable = print):
    """Ray diffusivity b from the per-k psit rows: the correlation
    spectrum C(omega, q), the WKB resonance integral D11(k) and the fit
    D11 = b (k/Kd)^2, into ``<omega-dir>/b_parameter.h5`` -> b."""
    import glob
    import re

    import h5py

    from ..analysis.b_parameter import compute_D11, fit_b, psi_correlation

    reader, grid = _run_grid(args.run_dir, args.base)
    f0 = float(reader.read("params/f"))
    Kd = f0 / float(np.sqrt(float(reader.read("params/Cg2"))))
    psit_by_k, t = {}, None
    for path in sorted(glob.glob(os.path.join(args.omega_dir, "radial_data_k=*.h5"))):
        ki = int(re.search(r"k=(\d+)", os.path.basename(path)).group(1))
        with h5py.File(path, "r") as f:
            if "psit" not in f:
                continue
            if t is None:
                t = f["t"][()]
            psit_by_k[ki] = f["psit"][()]
    if not psit_by_k:
        raise SystemExit(f"no psit rows found in {args.omega_dir} — run omega-k with "
                         "--decompose first")
    omegas, C = psi_correlation(psit_by_k, t, grid)
    k, D11 = compute_D11(omegas, C, grid, f0, Kd, n_points=min(args.n_points, grid.nkr * 4))
    b = fit_b(k, D11, Kd)
    out_path = os.path.join(args.omega_dir, "b_parameter.h5")
    with h5py.File(out_path, "w") as f:
        f["k"] = k
        f["D11"] = D11
        f["b"] = b
        f["Kd"] = Kd
    log_fn(f"b = {b:.6e} (Kd={Kd:.3f}, {len(psit_by_k)} k rows) -> {out_path}")
    return b


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
                   help="shallow-water variant")
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

    p = sub.add_parser("twolayer", help="TwoLayerQG turbulence + packets")
    _add_common(p)
    _add_packets(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f", type=float, default=3.0)
    p.add_argument("--U", type=float, default=0.2)
    p.add_argument("--mu", type=float, default=0.5)
    p.add_argument("--drho-rho0", type=float, default=0.2)
    p.add_argument("--Kg", type=float, nargs=2, default=(2, 6))
    p.add_argument("--ag", type=float, default=0.01)
    p.add_argument("--baroclinic", action="store_true",
                   help="advect packets with the baroclinic streamfunction")
    p.add_argument("--nlayers", type=int, default=2,
                   help=">2 switches to the n-layer QG model (equal depths, shear "
                        "spread +U..-U, F/2 per interface); packets ride the "
                        "depth-weighted mean flow")
    p.add_argument("--ic-file", default=None,
                   help="two-layer IC file (snapshots/ψh + params + clock/dt, as "
                        "twolayer-simulation writes it)")
    p.set_defaults(fn=cmd_twolayer)

    p = sub.add_parser("thomasyamada", help="two-phase Thomas-Yamada run")
    _add_common(p)
    p.add_argument("--Ro", type=float, default=0.2)
    p.add_argument("--ty-nu", type=float, default=3.5e-25)
    p.add_argument("--ty-nnu", type=int, default=8)
    p.add_argument("--ty-dt", type=float, default=1e-3,
                   help="fine (main-phase) time step")
    p.add_argument("--startup-dt-factor", type=float, default=5.0,
                   help="coarse startup dt = factor * dt")
    p.add_argument("--startup-T", type=float, default=1.0,
                   help="model time integrated in the coarse startup phase")
    p.add_argument("--Kg", type=float, nargs=2, default=(2, 6),
                   help="geostrophic IC band k0g_range")
    p.add_argument("--Kw", type=float, nargs=2, default=(0, 4),
                   help="wave IC band k0w_range")
    p.add_argument("--at", type=float, default=0.1,
                   help="barotropic streamfunction amplitude")
    p.add_argument("--ag", type=float, default=0.1)
    p.add_argument("--aw", type=float, default=0.05)
    p.add_argument("--restart-file", default=None,
                   help="resume from a finished run's snapshot base path")
    p.add_argument("--restart-frame", type=int, default=None)
    p.set_defaults(fn=cmd_thomasyamada)

    p = sub.add_parser("twolayer-simulation", help="spin-up writing an IC file")
    _add_common(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f", type=float, default=3.0)
    p.add_argument("--U", type=float, default=0.2)
    p.add_argument("--mu", type=float, default=0.5)
    p.add_argument("--drho-rho0", type=float, default=0.2)
    p.add_argument("--Kg", type=float, nargs=2, default=(2, 6))
    p.add_argument("--ag", type=float, default=0.01)
    p.add_argument("--freely-evolving", action="store_true",
                   help="unforced/undamped variant: FilteredAB3 in place of IFMAB3")
    p.set_defaults(fn=cmd_twolayer_simulation)

    p = sub.add_parser("single-wave",
                       help="single wave packet in an envelope + two packets")
    _add_common(p)
    _add_packets(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f-over-cg", type=float, default=3.0)
    p.add_argument("--Kg", type=float, nargs=2, default=(10, 13))
    p.add_argument("--ag", type=float, default=0.5)
    p.add_argument("--aw", type=float, default=0.1)
    p.add_argument("--wave-x0", type=float, default=0.0)
    p.add_argument("--wave-y0", type=float, default=0.0)
    p.add_argument("--k0-idx", type=int, default=10)
    p.add_argument("--l0-idx", type=int, default=0)
    p.add_argument("--env-size", type=float, default=0.5)
    p.set_defaults(fn=cmd_single_wave)

    p = sub.add_parser("steady-raytracing", help="packets through a frozen snapshot")
    _add_common(p)
    _add_packets(p)
    p.add_argument("--cg", type=float, default=1.0)
    p.add_argument("--f", type=float, default=3.0)
    p.add_argument("--Kg", type=float, nargs=2, default=(2, 6))
    p.add_argument("--ag", type=float, default=0.2)
    p.add_argument("--snapshot-file", default=None,
                   help="JLD2/HDF5 file holding the frozen streamfunction spectrum")
    p.add_argument("--snapshot-key", default="snapshots/sol/0")
    p.add_argument("--packet-velocity-scale", type=float, default=1.0,
                   help="time-rescaled packet clock s: tspan *= s, Cg /= s")
    p.set_defaults(fn=cmd_steady_raytracing)

    p = sub.add_parser("sweep", help="one run of an experiment per row of a sweep table")
    p.add_argument("experiment")
    p.add_argument("table")
    p.add_argument("--task", type=int, default=None, help="run only this 1-based task id")
    p.add_argument("--out-dir", default="sweep")
    p.add_argument("--extra-args", default="",
                   help="options added to every run (e.g. '--platform cpu')")
    p.add_argument("--max-parallel", type=int, default=1,
                   help="run up to this many sweep tasks concurrently")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("omega-k", help="per-k frequency spectra of a finished run")
    p.add_argument("run_dir")
    p.add_argument("--base", default="rsw")
    p.add_argument("--model", default="rsw", choices=["rsw", "ty"],
                   help="ty: the Thomas-Yamada wave/geostrophic rows and complex U")
    p.add_argument("--task", type=int, default=1, help="1-based task id")
    p.add_argument("--ntasks", type=int, default=1)
    p.add_argument("--decompose", action="store_true", default=True,
                   help="store the wave/balanced eigen-coefficients c0/c+/c-")
    p.add_argument("--no-decompose", dest="decompose", action="store_false")
    p.add_argument("--out-dir", default="omega_k")
    p.add_argument("--mem-cap-gb", type=float, default=8.0,
                   help="stream the task's k range in sub-blocks whose collected time "
                        "series fit this many GB")
    p.add_argument("--stft-window", type=int, default=0,
                   help="also store sliding-window spectra of each row with this "
                        "window length")
    p.add_argument("--fanout", type=int, default=0,
                   help="run the whole analysis as N concurrent omega-k processes on "
                        "the CPU (in place of --task/--ntasks)")
    _add_platform(p)
    p.set_defaults(fn=cmd_omega_k)

    p = sub.add_parser("omega-k-plot",
                       help="radially binned (omega, K) power from the per-k files")
    p.add_argument("run_dir")
    p.add_argument("--base", default="rsw")
    p.add_argument("--omega-dir", default="omega_k")
    p.add_argument("--names", default="c0,cp,cm",
                   help="comma-separated dataset names to assemble")
    p.add_argument("--out-dir", default="omega_k")
    p.set_defaults(fn=cmd_omega_k_plot)

    p = sub.add_parser("b-parameter", help="ray diffusivity b from the per-k psit rows")
    p.add_argument("run_dir")
    p.add_argument("--base", default="rsw")
    p.add_argument("--omega-dir", default="omega_k")
    p.add_argument("--n-points", type=int, default=176)
    p.set_defaults(fn=cmd_b_parameter)

    p = sub.add_parser("analyze", help="offline analysis suite over run dirs")
    p.add_argument("run_dir", nargs="+")
    p.add_argument("--base", default="rsw")
    p.add_argument("--figures-dir", default=None)
    _add_platform(p)
    p.set_defaults(fn=cmd_analyze)
    return ap


def run(argv=None, log_fn: Callable = print):
    """Parse ``argv`` and run its subcommand; returns the coupled run's
    ``CoupledDriver`` (with ``--sharded``, its ``ShardedRun``), the
    analysis report(s), ``thomasyamada``'s (sol,
    clock, diagnostics), ``twolayer-simulation``'s file,
    ``steady-raytracing``'s (packets, t), the sweep's rows, omega-k's
    files, omega-k-plot's file or b-parameter's b. Every line the run
    prints goes to ``log_fn``."""
    args = build_parser().parse_args(argv)
    return args.fn(args, log_fn)


def main(argv=None):
    run(argv)


if __name__ == "__main__":
    main()
