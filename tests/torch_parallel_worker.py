"""The ranks of the port's multi-process tests, and the harness that spawns
them (imports no JAX: the ranks run the PyTorch port alone).

A test module starts ONE job for all of its cases: ``Ranks.start(world,
cases, inputs, tmp_dir)`` spawns ``world`` processes with
``torch.multiprocessing`` (spawn), joins them in a gloo process group
over a ``FileStore`` under ``tmp_dir`` (60 s collective timeout), and
each rank runs the named cases in order on the inputs (numpy arrays made
by the test, the same the JAX package gets). Rank 0 writes each case's
result, an ``.npz`` of numpy arrays, as soon as the case ends, so the
test process compares a case while the ranks run the next.
``Ranks.result(name)`` waits for that file. The job has a deadline
(``JOIN_LIMIT_S``): past it, or as soon as a rank fails, every rank is
killed and the waiting test fails, so a hung collective never reaches
the suite's clock.

A case is ``fn(mesh_factory, inputs, out_dir) -> dict of arrays | None``;
``mesh_factory(n=None)`` is ``parallel/mesh.make_mesh(n, device='cpu')``
(a mesh of the first n ranks, None outside it).
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

JOIN_LIMIT_S = 240.0
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=60)

CASES: dict = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _save(path: str, out: dict) -> None:
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **{k: np.asarray(v) for k, v in out.items()})
    os.replace(tmp, path)


def run_rank(rank: int, world: int, store: str, inputs_path: str, out_dir: str,
             names: list) -> None:
    """One rank of the job (the spawned processes' entry point)."""
    from juliaraytracingsw_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=COLLECTIVE_TIMEOUT)
    try:
        with np.load(inputs_path) as f:
            inputs = dict(f)
        for name in names:
            out = CASES[name](partial(make_mesh, device="cpu"), inputs, out_dir)
            if rank == 0:
                _save(os.path.join(out_dir, f"{name}.npz"), out or {})
    finally:
        dist.destroy_process_group()


class Ranks:
    """A running job of spawned ranks and its results."""

    def __init__(self, ctx, out_dir: str, deadline: float):
        self.ctx, self.out_dir, self.deadline = ctx, out_dir, deadline

    @classmethod
    def start(cls, world: int, names: list, inputs: dict, tmp_dir: str) -> "Ranks":
        out_dir = tempfile.mkdtemp(prefix="ranks_", dir=tmp_dir)
        inputs_path = os.path.join(out_dir, "inputs.npz")
        np.savez(inputs_path, **inputs)
        ctx = mp.start_processes(run_rank, args=(world, os.path.join(out_dir, "store"),
                                                 inputs_path, out_dir, list(names)),
                                 nprocs=world, join=False, start_method="spawn")
        return cls(ctx, out_dir, time.monotonic() + JOIN_LIMIT_S)

    def _kill(self) -> None:
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
        for p in self.ctx.processes:
            p.join(5)

    def result(self, name: str) -> dict:
        """Case ``name``'s arrays from rank 0, once they are written."""
        path = os.path.join(self.out_dir, f"{name}.npz")
        while not os.path.exists(path):
            try:
                done = self.ctx.join(timeout=0.2)
            except mp.ProcessException as exc:   # a rank failed
                self._kill()
                raise AssertionError(f"a rank failed before case {name} ended: {exc}") from exc
            if done and not os.path.exists(path):
                raise AssertionError(f"the ranks ended without a result for case {name}")
            if time.monotonic() > self.deadline:
                self._kill()
                raise AssertionError(f"case {name}: the ranks passed their "
                                     f"{JOIN_LIMIT_S:.0f} s limit and were killed")
        with np.load(path) as f:
            return dict(f)

    def close(self) -> None:
        """Wait for the ranks to end (killing them at the deadline)."""
        try:
            while not self.ctx.join(timeout=max(self.deadline - time.monotonic(), 0.1)):
                if time.monotonic() > self.deadline:
                    break
        except mp.ProcessException:   # reported by the case that waited for it
            pass
        self._kill()


# --- helpers of the cases -----------------------------------------------------

def _grid(inputs):
    from juliaraytracingsw_tpu_torch.core.grid import make_grid

    return make_grid(int(inputs["nx"]), device="cpu")


def _clock():
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock

    return zero_clock(device="cpu")


def _packets(inputs, prefix="packets"):
    from juliaraytracingsw_tpu_torch.rays.packets import Packets

    return Packets(*(torch.as_tensor(inputs[f"{prefix}.{n}"])
                     for n in ("x", "y", "k", "l", "sign")))


def _rp(grid, **kw):
    from juliaraytracingsw_tpu_torch.rays.raytrace import RayParams

    return RayParams(f=3.0, Cg=1.0, x0=float(grid.x[0]), y0=float(grid.y[0]),
                     dx=grid.dx, dy=grid.dy, **kw)


def _np(t):
    return t.detach().cpu().numpy()


def _model(kind: str, inputs, grid):
    """(replicated model module's params, sharded class) of a kind."""
    from juliaraytracingsw_tpu_torch.parallel import sharded as S
    from juliaraytracingsw_tpu_torch.parallel import sharded_rsw as R

    dt = float(inputs["dt"])
    nu = float(inputs["nu"])
    if kind in ("rsw", "linborg", "modified", "quadheight"):
        from juliaraytracingsw_tpu_torch.models import linborg, modified_sw, quadheight, rsw

        factory = {"rsw": rsw, "linborg": linborg, "modified": modified_sw,
                   "quadheight": quadheight}[kind]
        cls = {"rsw": R.ShardedRSW, "linborg": R.ShardedLinborg,
               "modified": R.ShardedModifiedSW, "quadheight": R.ShardedQuadHeight}[kind]
        return factory.make_model(grid, nu=nu, nnu=4, f=3.0, Cg=1.0).params, cls, dt
    if kind == "twolayer":
        from juliaraytracingsw_tpu_torch.models import twolayerqg

        model = twolayerqg.make_model(grid, U=0.2, mu=1e-2, nu=nu, nnu=4, f0=3.0, Cg=1.0,
                                      drho_rho0=0.2)
        return model.params, S.ShardedTwoLayerQG, dt
    if kind == "swqg":
        from juliaraytracingsw_tpu_torch.models import swqg

        return swqg.make_model(grid, nu=nu, nnu=4, f=3.0, Cg=1.0).params, S.ShardedSWQG, dt
    if kind == "ty":
        from juliaraytracingsw_tpu_torch.models import thomasyamada

        return (thomasyamada.make_model(grid, nu=1e-18, nnu=4, Ro=0.2).params,
                S.ShardedThomasYamada, dt)
    if kind == "multilayer":
        from juliaraytracingsw_tpu_torch.models import multilayerqg

        n = 3
        model = multilayerqg.make_model(grid, U=tuple(0.2 - 0.2 * j for j in range(n)),
                                        beta=0.5, mu=1e-2, nu=nu, nnu=4,
                                        Fcoup=tuple(4.0 for _ in range(n - 1)))
        return model.params, S.ShardedMultiLayerQG, dt
    raise KeyError(kind)


def _sharded(make_mesh, inputs, kind, **kw):
    grid = _grid(inputs)
    params, cls, dt = _model(kind, inputs, grid)
    return cls(grid, params, make_mesh(), dt=dt, **kw)


def steps(make_mesh, inputs, kind, nsteps=10, **kw):
    """``nsteps`` sharded IF-AB3 steps from ``sol.<kind>`` -> the gathered
    state, its pad columns and the state's shape after a round trip."""
    from juliaraytracingsw_tpu_torch.parallel.mesh import all_gather

    sh = _sharded(make_mesh, inputs, kind, **kw)
    init_fn, step_fn = sh.stepper()
    sol = sh.shard_solution(inputs[f"sol.{kind}"])
    clock, state = _clock(), init_fn(sol)
    for _ in range(nsteps):
        sol, clock, state = step_fn(sol, clock, state)
    padded = all_gather(sol, -1, sh.mesh)
    return {"sol": _np(sh.unshard(sol)), "pad": _np(padded[..., sh.grid.nkr:]),
            "nkr_pad": sh.nkr_pad, "step": clock.step,
            "roundtrip_shape": np.asarray(sh.unshard(sh.shard_solution(
                inputs[f"sol.{kind}"])).shape)}


def fields(make_mesh, inputs, kind, **kw):
    sh = _sharded(make_mesh, inputs, kind, **kw)
    return {"fields": _np(sh.fields(sh.shard_solution(inputs[f"sol.{kind}"])))}


def frame(make_mesh, inputs, kind, flow_steps=5, overlap=False, rp_kw=None, k_cutoff=True,
          **kw):
    """One sharded coupled frame of the global packets -> the gathered
    state and packets and the clock."""
    from juliaraytracingsw_tpu_torch.parallel.mesh import gather_packets, shard_packets

    sh = _sharded(make_mesh, inputs, kind, **kw)
    rp = _rp(sh.grid, **(rp_kw or {}))
    k0 = float(np.sqrt(3.0) * 3.0)
    init_fn, _ = sh.stepper()
    fr = sh.make_coupled_frame(rp, flow_steps, k_cutoff=300.0 if k_cutoff else None,
                               k0=k0 if k_cutoff else None, overlap=overlap)
    sol = sh.shard_solution(inputs[f"sol.{kind}"])
    pk = shard_packets(_packets(inputs), sh.mesh)
    sol, clock, _, pk = fr(sol, _clock(), init_fn(sol), pk)
    out = {"sol": _np(sh.unshard(sol)), "step": clock.step, "t": float(clock.t)}
    for n, a in zip("xykl", gather_packets(pk, sh.mesh)):
        out[n] = _np(a)
    return out


def _overlap_pair(make_mesh, inputs, kind):
    seq = frame(make_mesh, inputs, kind, k_cutoff=False)
    ovl = frame(make_mesh, inputs, kind, k_cutoff=False, overlap=True)
    return {**{f"seq.{k}": v for k, v in seq.items()},
            **{f"ovl.{k}": v for k, v in ovl.items()}}


# --- cases ----------------------------------------------------------------------

def _register(name, fn, *args, **kw):
    CASES[name] = lambda make_mesh, inputs, out_dir: fn(make_mesh, inputs, *args, **kw)


for _kind in ("rsw", "twolayer", "swqg", "ty", "multilayer", "linborg", "modified",
              "quadheight"):
    _register(f"{_kind}_step", steps, _kind)
    _register(f"{_kind}_fields", fields, _kind)
for _kind in ("rsw", "twolayer", "swqg"):
    _register(f"{_kind}_frame", frame, _kind)
_register("rsw_overlap", _overlap_pair, "rsw")
_register("twolayer_overlap", _overlap_pair, "twolayer")
_register("twolayer_baroclinic_fields", fields, "twolayer", advect="baroclinic")
_register("swqg_bicubic_fields", fields, "swqg", interp="bicubic")
_register("rsw_frame3", frame, "rsw", flow_steps=3)


@case
def swqg_taps(make_mesh, inputs, out_dir):
    """The taps frame, the patch frame, and overlap refused with taps."""
    taps = frame(make_mesh, inputs, "swqg", rp_kw={"gather": "taps"})
    patch = frame(make_mesh, inputs, "swqg", rp_kw={"gather": "patch"})
    sh = _sharded(make_mesh, inputs, "swqg")
    try:
        sh.make_coupled_frame(_rp(sh.grid, gather="taps"), 5, overlap=True)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    return {**{f"taps.{k}": v for k, v in taps.items()},
            **{f"patch.{k}": v for k, v in patch.items()}, "refused": refused}


@case
def slab_fft(make_mesh, inputs, out_dir):
    """The slab FFT of ``field`` on a mesh of 2 (the first two ranks) and
    on the whole job -> each gathered spectrum and round trip."""
    from juliaraytracingsw_tpu_torch.parallel.fft import (slab_irfft2, slab_rfft2,
                                                          slab_sharding_physical)
    from juliaraytracingsw_tpu_torch.parallel.mesh import all_gather

    field = torch.as_tensor(inputs["field"])
    out = {}
    for tag, n in (("p2", 2), ("pall", None)):
        mesh = make_mesh(n)
        if mesh is None:
            continue
        slab = slab_sharding_physical(mesh).local(field)
        spec = slab_rfft2(slab, mesh)
        back = slab_irfft2(spec, field.shape[-1], mesh)
        out[f"{tag}.spec"] = _np(all_gather(spec, -1, mesh))
        out[f"{tag}.back"] = _np(all_gather(back, -2, mesh))
        small = slab_sharding_physical(mesh).local(torch.as_tensor(inputs["field_small"]))
        out[f"{tag}.small_back"] = _np(all_gather(
            slab_irfft2(slab_rfft2(small, mesh), small.shape[-1], mesh), -2, mesh))
        out[f"{tag}.size"] = mesh.size
        out[f"{tag}.all_to_all"] = mesh.counts["all_to_all"]
    return out


@case
def sharded_rays(make_mesh, inputs, out_dir):
    """Each rank's packets through the replicated fields; the gathered
    packets and the ranks' block sizes."""
    from juliaraytracingsw_tpu_torch.parallel.mesh import gather_packets, shard_packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih, raytrace

    mesh = make_mesh(2)
    if mesh is None:
        return None
    grid = _grid(inputs)
    f = fields_from_psih(torch.as_tensor(inputs["psih"]), grid)
    local = shard_packets(_packets(inputs), mesh)
    out = raytrace(local, f, f, 0.0, 0.1, _rp(grid), nsubsteps=4)
    full = gather_packets(out, mesh)
    return {"x": _np(full.x), "k": _np(full.k), "local_n": local.n}


@case
def gradient_all_reduce(make_mesh, inputs, out_dir):
    """d mean(k^2 + l^2) / d psih with each rank's packets, the loss
    summed by the differentiable all_reduce and the gradient over the
    ranks."""
    import torch.distributed.nn.functional as dist_fn

    from juliaraytracingsw_tpu_torch.parallel.mesh import shard_packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih, raytrace

    mesh = make_mesh(2)
    if mesh is None:
        return None
    grid = _grid(inputs)
    psih = torch.as_tensor(inputs["psih"]).requires_grad_(True)
    packets = _packets(inputs)
    f = fields_from_psih(psih, grid)
    out = raytrace(shard_packets(packets, mesh), f, f, 0.0, 0.1, _rp(grid), nsubsteps=2)
    loss = dist_fn.all_reduce((out.k ** 2 + out.l ** 2).sum(), group=mesh.group) / packets.n
    (g,) = torch.autograd.grad(loss, psih)
    g = torch.view_as_real(g).contiguous()
    dist.all_reduce(g, group=mesh.group)
    return {"loss": float(loss), "grad": _np(torch.view_as_complex(g / mesh.size))}


@case
def dryrun(make_mesh, inputs, out_dir):
    from juliaraytracingsw_tpu_torch.parallel.dryrun import dryrun_multichip

    out = {}
    for tag, n in (("p2", 2), ("pall", None)):
        mesh = make_mesh(n)
        if mesh is None:
            continue
        res = dryrun_multichip(mesh)
        out.update({f"{tag}.loss": res["loss"], f"{tag}.grad": _np(res["grad"]),
                    f"{tag}.slab_err": res["slab_err"], f"{tag}.n": res["n_packets"],
                    f"{tag}.size": mesh.size})
    return out


@case
def mesh_helpers(make_mesh, inputs, out_dir):
    """shard_packets / gather_packets round trip, replicate from rank 0,
    the uneven split refused, the finite flag reduced over the ranks."""
    from juliaraytracingsw_tpu_torch.parallel.mesh import (all_reduce_finite, gather_packets,
                                                           replicate, shard_packets)
    from juliaraytracingsw_tpu_torch.rays.packets import Packets

    mesh = make_mesh()
    packets = _packets(inputs)
    local = shard_packets(packets, mesh)
    back = gather_packets(local, mesh)
    mine = torch.full((3,), float(mesh.rank)) + 1j * mesh.rank
    rep = replicate({"a": mine, "t": (mine.real,)}, mesh)
    uneven = Packets(*(a[:-1] for a in packets))
    try:
        shard_packets(uneven, mesh)
        refused = ""
    except ValueError as exc:
        refused = str(exc)
    bad = torch.tensor([float("nan") if mesh.rank == mesh.size - 1 else 0.0])
    return {"equal": all(torch.equal(a, b) for a, b in zip(back, packets)),
            "local_n": local.n, "rep_a": _np(rep["a"]), "rep_t": _np(rep["t"][0]),
            "refused": refused, "finite_ok": all_reduce_finite(mesh, torch.zeros(2)),
            "finite_bad": all_reduce_finite(mesh, bad)}


@case
def cli_restore(make_mesh, inputs, out_dir):
    """The port's ``--sharded`` command line on every rank: restored from
    the reference's checkpoint, writing its own."""
    from juliaraytracingsw_tpu_torch.experiments.__main__ import run

    argv = [str(a) for a in inputs["cli_argv"]]
    run(argv + ["--out-dir", os.path.join(out_dir, "cli_restore"), "--restore",
                str(inputs["cli_restore"]), "--checkpoint",
                os.path.join(out_dir, "port_ckpt.npz")], log_fn=lambda line: None)
    return {"out_dir": os.path.join(out_dir, "cli_restore"),
            "checkpoint": os.path.join(out_dir, "port_ckpt.npz")}


@case
def rsw_interop(make_mesh, inputs, out_dir):
    """The reference's sharded state after one frame, carried in as numpy
    (``interop.sharded_state_from_numpy``), one more frame, carried out."""
    from juliaraytracingsw_tpu_torch.interop import (sharded_state_from_numpy,
                                                     sharded_state_to_numpy)

    sh = _sharded(make_mesh, inputs, "rsw")
    state = {k[len("jax_state."):]: v for k, v in inputs.items()
             if k.startswith("jax_state.")}
    sol, clock, sstate, pk = sharded_state_from_numpy(state, sh)
    fr = sh.make_coupled_frame(_rp(sh.grid), 5, k_cutoff=300.0, k0=float(np.sqrt(3.0) * 3.0))
    return sharded_state_to_numpy(sh, *fr(sol, clock, sstate, pk))
