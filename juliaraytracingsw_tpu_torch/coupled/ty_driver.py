"""Thomas-Yamada experiment driver, the two-phase coarse -> fine run (port
of ``coupled/ty_driver.py``):

- phase 1 ("startup"): a coarse-dt stepper integrates the
  eigenbasis-projected random initial condition (or a restart snapshot)
  through the stiff initial transient, with its own ``startup`` output
  file and wave/geostrophic and barotropic energy diagnostics;
- hand-off: a fine-dt stepper continues from the startup state and clock;
- phase 2: the main loop, with reality enforcement, rolling outputs and
  diagnostics every chunk of ``nsubs`` steps.

A phase runs on the state's device; its host work per chunk is the NaN
check, the diagnostics (one value each) and, with a writer, one copy of the
state. The HDF5 outputs need h5py, which is imported only when a run
writes them.

``run_thomasyamada_sharded`` runs the same two phases on the slab-sharded
model (``parallel/sharded.ShardedThomasYamada``, IF-AB3 whatever
``cfg.stepper`` says, one model a phase's dt); after each chunk the state
is gathered, made real on every rank, checked, measured and sharded again,
and rank 0 writes the files.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..core.spectral import enforce_reality, irfft2
from ..core.steppers import zero_clock
from ..models import thomasyamada
from ..models.base import build_stepper, run

__all__ = ["TYRunConfig", "run_thomasyamada", "run_thomasyamada_sharded",
           "ty_restart_solution", "thomasyamada_speeds"]

DIAG_KEYS = ("t", "wave_ke", "wave_pe", "geo_ke", "geo_pe", "barotropic")


@dataclass
class TYRunConfig:
    nx: int = 128
    Lx: float = 2.0 * np.pi
    nu: float = 3.5e-25
    nnu: int = 8
    Ro: float = 0.2
    stepper: str = "ETDRK4"
    # two-phase stepping: startup_dt >> dt
    startup_dt: float = 5e-3
    startup_nsteps: int = 200
    startup_nsubs: int = 50
    dt: float = 1e-3
    nsteps: int = 1000
    nsubs: int = 50
    # initial condition's bands and amplitudes
    k0g_range: tuple = (2.0, 6.0)
    k0w_range: tuple = (0.0, 4.0)
    at: float = 0.1
    ag: float = 0.1
    aw: float = 0.05
    seed: int = 5678
    # restart from a finished run's snapshots
    restart_file: str | None = None
    restart_key: str = "snapshots/sol"
    restart_frame: int | None = None   # default: the last frame
    # output
    out_dir: str = "."
    base_filename: str = "ty"
    max_writes: int = 300
    diag_freq_frames: int = 1
    log_fn: callable = print
    device: str = "cuda"


def ty_restart_solution(path: str, key: str = "snapshots/sol",
                        frame: int | None = None, *, device: torch.device | str = "cuda"):
    """A ``(4, nl, nkr)`` complex64 TY state from a finished run's snapshot
    file sequence (the last frame unless ``frame`` names one) -> (state on
    ``device``, its step)."""
    from ..io.output import SequencedReader

    reader = SequencedReader(path)
    step = reader.steps(key)[-1] if frame is None else frame
    sol = np.asarray(reader.load(step, key), np.complex64)
    return torch.as_tensor(sol, device=device), step


def _finite(sol: torch.Tensor) -> bool:
    return bool(torch.isfinite(torch.view_as_real(sol)).all())


def _phase(model, cfg: TYRunConfig, sol, clock, dt, nsteps, nsubs, writer,
           diags, label, start_wall):
    """One stepping phase: chunks of ``nsubs`` steps, each followed by
    reality enforcement, the NaN check, diagnostics, the writer (None:
    no output) and the CFL log -> (sol, clock)."""
    grid = model.grid
    init_fn, step_fn = build_stepper(model, cfg.stepper, dt)
    state = init_fn(sol)
    bases = thomasyamada.ty_bases(grid)

    frames = max(int(round(nsteps / nsubs)), 1)
    for j in range(frames):
        sol, clock, state = run(step_fn, sol, clock, state, nsubs)
        sol = enforce_reality(sol, grid)
        if not _finite(sol):
            raise FloatingPointError(
                f"TY {label}: NaN/Inf at t={float(clock.t):.3f}")
        if j % cfg.diag_freq_frames == 0:
            wave, geo = thomasyamada.wave_geostrophic_energy(sol, grid, bases)
            diags["t"].append(float(clock.t))
            diags["wave_ke"].append(float(wave[0]))
            diags["wave_pe"].append(float(wave[1]))
            diags["geo_ke"].append(float(geo[0]))
            diags["geo_pe"].append(float(geo[1]))
            diags["barotropic"].append(float(thomasyamada.barotropic_energy(sol, grid)))
        if writer is not None:
            step = clock.step
            writer.write_frame(step, sol=sol)
            writer.write(f"snapshots/t/{step}", float(clock.t))
        # CFL from the largest barotropic / baroclinic speed
        cfl = dt * thomasyamada_speeds(sol, grid) / min(grid.dx, grid.dy)
        cfg.log_fn(
            f"[{label}] step {clock.step:06d}, t: {float(clock.t):.2f}, "
            f"cfl: {cfl:.4f}, wall: {(time.time() - start_wall) / 60:.2f} min"
        )
    return sol, clock


def thomasyamada_speeds(sol, grid) -> float:
    """max(|ut|, |vt|, |uc|, |vc|) over the grid."""
    zth, uch, vch = sol[0], sol[1], sol[2]
    psith = -zth * grid.invKrsq
    uth = -grid.il * psith
    vth = grid.ik * psith
    phys = irfft2(torch.stack([uth, vth, uch, vch]), grid.nx)
    return float(phys.abs().max())


def run_thomasyamada(cfg: TYRunConfig):
    """The whole two-phase TY experiment on ``cfg.device``, writing the
    ``startup`` and ``<base_filename>`` snapshot sequences and
    ``diagnostics.h5`` -> (sol, clock, diagnostics)."""
    import h5py

    from ..core.grid import make_grid
    from ..io.output import SequencedWriter, save_problem
    from .initial_conditions import ty_initial_condition

    grid = make_grid(cfg.nx, Lx=cfg.Lx, device=cfg.device)
    model = thomasyamada.make_model(grid, nu=cfg.nu, nnu=cfg.nnu, Ro=cfg.Ro)
    start_wall = time.time()

    if cfg.restart_file:
        sol, step0 = ty_restart_solution(cfg.restart_file, cfg.restart_key,
                                         cfg.restart_frame, device=grid.device)
        cfg.log_fn(f"restarted from {cfg.restart_file} frame {step0}")
    else:
        rng = np.random.default_rng(cfg.seed)
        sol = ty_initial_condition(grid, rng, cfg.k0g_range, cfg.k0w_range,
                                   cfg.at, cfg.ag, cfg.aw)
    clock = zero_clock(device=grid.device)
    diags = {k: [] for k in DIAG_KEYS}

    os.makedirs(cfg.out_dir, exist_ok=True)
    # phase 1: coarse dt, its own output file
    startup_writer = SequencedWriter(os.path.join(cfg.out_dir, "startup"), cfg.max_writes)
    save_problem(startup_writer, grid, model.params, cfg.startup_dt)
    sol, clock = _phase(model, cfg, sol, clock, cfg.startup_dt, cfg.startup_nsteps,
                        cfg.startup_nsubs, startup_writer, diags, "startup", start_wall)
    startup_writer.close()
    cfg.log_fn("Startup finished")

    # hand-off: the fine-dt stepper continues from the startup state and clock
    writer = SequencedWriter(os.path.join(cfg.out_dir, cfg.base_filename), cfg.max_writes)
    save_problem(writer, grid, model.params, cfg.dt)
    sol, clock = _phase(model, cfg, sol, clock, cfg.dt, cfg.nsteps, cfg.nsubs,
                        writer, diags, "main", start_wall)
    writer.close()

    with h5py.File(os.path.join(cfg.out_dir, "diagnostics.h5"), "w") as f:
        for k, v in diags.items():
            f[k] = np.asarray(v)
    return sol, clock, diags


def _phase_sharded(sh, cfg: TYRunConfig, sol_sh, clock, dt, nsteps, nsubs, writer,
                   diags, label, start_wall):
    """``_phase`` on the sharded model ``sh`` (built for this phase's dt):
    chunks of ``nsubs`` sharded IF-AB3 steps, then the gathered state made
    real (``enforce_reality``, every rank alike) and sharded again, the NaN
    check (every rank sees the same gathered state, so all raise
    together), diagnostics, the writer (None: no output) and the CFL log.
    The AB3 history starts anew with the phase, as the reference's
    hand-off does -> (the rank's block, clock)."""
    grid = sh.grid
    init_fn, step_fn = sh.stepper()
    state = init_fn(sol_sh)
    bases = thomasyamada.ty_bases(grid)
    frames = max(int(round(nsteps / nsubs)), 1)
    for j in range(frames):
        sol_sh, clock, state = run(step_fn, sol_sh, clock, state, nsubs)
        solh = sh.unshard(sol_sh)
        if not _finite(solh):
            raise FloatingPointError(
                f"TY {label} (sharded): NaN/Inf at t={float(clock.t):.3f}")
        sol = enforce_reality(solh, grid)
        sol_sh = sh.shard_solution(sol)
        if j % cfg.diag_freq_frames == 0:
            wave, geo = thomasyamada.wave_geostrophic_energy(sol, grid, bases)
            diags["t"].append(float(clock.t))
            diags["wave_ke"].append(float(wave[0]))
            diags["wave_pe"].append(float(wave[1]))
            diags["geo_ke"].append(float(geo[0]))
            diags["geo_pe"].append(float(geo[1]))
            diags["barotropic"].append(float(thomasyamada.barotropic_energy(sol, grid)))
        if writer is not None:
            writer.write_frame(clock.step, sol=solh)
            writer.write(f"snapshots/t/{clock.step}", float(clock.t))
        cfl = dt * thomasyamada_speeds(sol, grid) / min(grid.dx, grid.dy)
        cfg.log_fn(
            f"[{label}] step {clock.step:06d}, t: {float(clock.t):.2f}, "
            f"cfl: {cfl:.4f}, wall: {(time.time() - start_wall) / 60:.2f} min"
            f" [sharded x{sh.mesh.size}]")
    return sol_sh, clock


def run_thomasyamada_sharded(cfg: TYRunConfig, mesh=None):
    """The two-phase TY experiment on the slab-sharded model over ``mesh``
    (default: ``parallel/mesh.make_mesh(device=cfg.device)``), each phase a
    ``ShardedThomasYamada`` for its dt; rank 0 writes the ``startup`` and
    ``<base_filename>`` sequences and ``diagnostics.h5`` -> (the gathered
    sol, clock, diagnostics) on every rank."""
    from ..core.grid import make_grid
    from ..io.output import SequencedWriter, save_problem
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import ShardedThomasYamada
    from .initial_conditions import ty_initial_condition

    mesh = make_mesh(device=cfg.device) if mesh is None else mesh
    grid = make_grid(cfg.nx, Lx=cfg.Lx, device=mesh.device)
    params = thomasyamada.TYParams(nu=cfg.nu, nnu=cfg.nnu, Ro=cfg.Ro)
    start_wall = time.time()
    lead = mesh.rank == 0

    if cfg.restart_file:
        sol, step0 = ty_restart_solution(cfg.restart_file, cfg.restart_key,
                                         cfg.restart_frame, device=grid.device)
        cfg.log_fn(f"restarted from {cfg.restart_file} frame {step0}")
    else:
        rng = np.random.default_rng(cfg.seed)
        sol = ty_initial_condition(grid, rng, cfg.k0g_range, cfg.k0w_range,
                                   cfg.at, cfg.ag, cfg.aw)
    clock = zero_clock(device=grid.device)
    diags = {k: [] for k in DIAG_KEYS}

    def writer(base, dt):
        if not lead:
            return None
        w = SequencedWriter(os.path.join(cfg.out_dir, base), cfg.max_writes)
        save_problem(w, grid, params, dt)
        return w

    os.makedirs(cfg.out_dir, exist_ok=True)
    sh_coarse = ShardedThomasYamada(grid, params, mesh, dt=cfg.startup_dt)
    startup_writer = writer("startup", cfg.startup_dt)
    sol_sh, clock = _phase_sharded(
        sh_coarse, cfg, sh_coarse.shard_solution(sol), clock, cfg.startup_dt,
        cfg.startup_nsteps, cfg.startup_nsubs, startup_writer, diags, "startup", start_wall)
    if startup_writer is not None:
        startup_writer.close()
    cfg.log_fn("Startup finished")

    sh = ShardedThomasYamada(grid, params, mesh, dt=cfg.dt)
    main_writer = writer(cfg.base_filename, cfg.dt)
    sol_sh, clock = _phase_sharded(
        sh, cfg, sh.shard_solution(sh_coarse.unshard(sol_sh)), clock, cfg.dt, cfg.nsteps,
        cfg.nsubs, main_writer, diags, "main", start_wall)
    if main_writer is not None:
        main_writer.close()
    sol = sh.unshard(sol_sh)
    if lead:
        import h5py

        with h5py.File(os.path.join(cfg.out_dir, "diagnostics.h5"), "w") as f:
            for k, v in diags.items():
                f[k] = np.asarray(v)
    return sol, clock, diags
