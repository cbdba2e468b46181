"""Multi-process dry run (the port's counterpart of
``__graft_entry__.dryrun_multichip``).

Every rank of a mesh runs, at 32^2 and about 32 packets a rank:

1. one full differentiable step: an RSW IF-AB3 flow step from a
   replicated state, the interpolation fields of the old and the new
   state, two RK4 substeps of the rank's block of the packets (on the
   card through ``csrc/ray_step.cu``), and the loss mean(k^2 + l^2) over
   ALL packets, summed across ranks by the differentiable
   ``torch.distributed.nn.functional.all_reduce``; the gradient with
   respect to the flow state is then summed over the ranks, so it equals
   the unsharded one;
2. a slab-FFT round trip of the new interpolation fields over the mesh;
3. the slab-sharded coupled frame (``parallel/sharded_rsw.ShardedRSW``,
   2 flow steps), sequential and with ``overlap=True``, held equal.

    srun --ntasks 4 --gpus-per-task 1 python -m juliaraytracingsw_tpu_torch.parallel.dryrun
    python -m juliaraytracingsw_tpu_torch.parallel.dryrun --platform cpu   # a mesh of 1

(the job's topology comes from ``parallel/launcher.resolve_cluster``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from .mesh import Mesh, all_gather, make_mesh, shard_packets

__all__ = ["dryrun_multichip", "build_case", "training_step"]


def _sqrt_packets(n_ranks: int) -> int:
    """The lattice side for about 32 packets a rank, even, its square a
    multiple of the mesh size (the reference's rule)."""
    sqrtp = int(np.ceil(np.sqrt(n_ranks * 32)))
    sqrtp += sqrtp % 2
    while (sqrtp * sqrtp) % n_ranks:
        sqrtp += 1
    return sqrtp


def build_case(nx: int, sqrt_packets: int, device, f: float = 3.0, Cg: float = 1.0,
               dt: float = 1e-3):
    """The dry run's RSW model, stepper, initial state, global packets and
    ray parameters (``__graft_entry__._build``'s configuration)."""
    from ..core.grid import make_grid
    from ..coupled.driver import derive_nu
    from ..coupled.initial_conditions import band_geo_wave_ic
    from ..models import rsw
    from ..models.base import build_stepper
    from ..rays.packets import lattice_packets
    from ..rays.raytrace import RayParams

    grid = make_grid(nx, device=device)
    model = rsw.make_model(grid, nu=derive_nu(1.0, nx, 4, dt), nnu=4, f=f, Cg=Cg)
    init_fn, step_fn = build_stepper(model, "IFMAB3", dt=dt)
    sol0 = band_geo_wave_ic(grid, np.random.default_rng(1234), Kg=(10, 13), Kw=(0, 5),
                            ag=0.5, aw=0.05, f=f, Cg=Cg)
    packets = lattice_packets(sqrt_packets, grid.Lx, grid.Ly,
                              k0=float(np.sqrt((2 * f) ** 2 - f ** 2) / Cg), k_ring=True,
                              device=device)
    rp = RayParams(f=f, Cg=Cg, x0=float(grid.x[0]), y0=float(grid.y[0]), dx=grid.dx,
                   dy=grid.dy)

    def psih_fn(sol):
        Kd2 = f * f / (Cg * Cg)
        qh = grid.ik * sol[1] - grid.il * sol[0] - f * sol[2]
        return -qh / (grid.Krsq + Kd2)

    return grid, model, init_fn, step_fn, sol0, packets, rp, psih_fn, dt


def training_step(case, packets, n_total: int, mesh: Mesh | None = None):
    """Loss and gradient of one differentiable coupled step with respect to
    the flow state, for this rank's ``packets`` of ``n_total`` (mesh None:
    one process holds them all) -> (loss, grad, new state, packets)."""
    from ..core.steppers import zero_clock
    from ..rays.raytrace import fields_from_psih, raytrace

    grid, _, init_fn, step_fn, sol0, _, rp, psih_fn, _ = case
    sol = sol0.detach().clone().requires_grad_(True)
    clock = zero_clock(device=sol.device)
    fields_old = fields_from_psih(psih_fn(sol), grid, rp.interp)
    sol1, clock1, _ = step_fn(sol, clock, init_fn(sol))
    fields_new = fields_from_psih(psih_fn(sol1), grid, rp.interp)
    out = raytrace(packets, fields_old, fields_new, clock.t, clock1.t, rp, nsubsteps=2)
    local = (out.k ** 2 + out.l ** 2).sum()
    if mesh is not None:
        local = dist_fn.all_reduce(local, group=mesh.group)
    loss = local / n_total
    (grad,) = torch.autograd.grad(loss, sol)
    if mesh is not None:
        # each rank's backward saw the ranks' summed output cotangent (the
        # all_reduce's backward), i.e. mesh.size times its packets' share:
        # the summed gradient over the mesh size is the unsharded one
        g = torch.view_as_real(grad).contiguous()
        dist.all_reduce(g, group=mesh.group)
        grad = torch.view_as_complex(g / mesh.size)
    return loss.detach(), grad, sol1.detach(), out


def dryrun_multichip(mesh: Mesh | None = None, *, device="cuda") -> dict:
    """One dry-run step on ``mesh`` (default: ``make_mesh(device=)``) ->
    {'loss', 'grad' (the full gradient, every rank), 'slab_err', 'packets'
    (the rank's), 'sharded_packets', 'n_packets'}; raises if a check fails."""
    from ..core.steppers import zero_clock
    from ..rays.raytrace import fields_from_psih
    from .fft import slab_irfft2, slab_rfft2, slab_sharding_physical
    from .sharded_rsw import ShardedRSW

    mesh = make_mesh(device=device) if mesh is None else mesh
    case = build_case(32, _sqrt_packets(mesh.size), mesh.device)
    grid, model, _, _, sol0, packets, rp, psih_fn, dt = case
    local = shard_packets(packets, mesh)
    loss, grad, sol1, out = training_step(case, local, packets.n, mesh)
    if not bool(torch.isfinite(loss)):
        raise FloatingPointError("loss is not finite")
    gnorm = float(torch.linalg.vector_norm(grad))
    if not (np.isfinite(gnorm) and gnorm > 0):
        raise FloatingPointError(f"gradient vanished or is not finite (norm {gnorm})")

    # the sharded-field path: a slab-FFT round trip of the fields
    slab = slab_sharding_physical(mesh).local(fields_from_psih(psih_fn(sol1), grid, rp.interp))
    back = slab_irfft2(slab_rfft2(slab, mesh), grid.nx, mesh)
    slab_err = float(all_gather((back - slab).abs().max()[None], 0, mesh).max())
    if slab_err >= 1e-4:
        raise AssertionError(f"slab FFT round trip error {slab_err}")

    # the sharded flow: column-block state, slab FFTs in calcN, gathered
    # fields, the rank's packets; sequential and pipelined frames agree
    sh = ShardedRSW(grid, model.params, mesh, dt=dt)
    init_s, _ = sh.stepper()
    runs = []
    for overlap in (False, True):
        frame = sh.make_coupled_frame(rp, flow_steps=2, ray_substeps=1, overlap=overlap)
        sol_sh = sh.shard_solution(sol0)
        runs.append(frame(sol_sh, zero_clock(device=mesh.device), init_s(sol_sh), local))
    (sol_a, _, _, pk_a), (sol_b, _, _, pk_b) = runs
    if not bool(torch.isfinite(sh.unshard(sol_a).abs()).all()):
        raise FloatingPointError("sharded flow is not finite")
    if not (torch.equal(sol_a, sol_b) and all(torch.equal(a, b) for a, b in zip(pk_a, pk_b))):
        raise AssertionError("the overlap frame differs from the sequential frame")
    return {"loss": float(loss), "grad": grad, "slab_err": slab_err, "packets": out,
            "sharded_packets": pk_a, "n_packets": packets.n}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="juliaraytracingsw_tpu_torch.parallel.dryrun")
    ap.add_argument("--platform", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    from .launcher import initialize_from_env

    initialize_from_env(device=args.platform)
    res = dryrun_multichip(device=args.platform)
    if dist.get_rank() == 0:
        print(f"dry run on a mesh of {dist.get_world_size()} ({dist.get_backend()}): loss "
              f"{res['loss']:.6e}, "
              f"|grad| {float(torch.linalg.vector_norm(res['grad'])):.6e}, slab FFT round "
              f"trip {res['slab_err']:.2e}, {res['n_packets']} packets")
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
