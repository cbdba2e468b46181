"""The port's slab-sharded RSW on 2 gloo ranks, against the JAX package's
``ShardedRSW`` on a mesh of 2 virtual CPU devices and the port's
replicated RSW (the port's counterpart of ``tests/test_sharded_rsw.py``),
and ``--sharded`` checkpoints across the packages and mesh sizes.

One job of 2 spawned ranks runs every case (``tests/torch_parallel_worker.py``).
The flow is the JAX tests' (dt 2e-3, the band IC of seed 1234) at 64^2
with 64 packets. Tolerances are the JAX tests': the state to atol 2e-5 of
its largest mode and rtol 2e-4, packets to rtol 5e-4 and atol 5e-5,
``overlap=True`` against the sequential frame to rtol 1e-6 and atol 1e-7.
The command-line runs (32^2, 256 packets, 'auto' -> patch) are held as
``tests/test_torch_cli.py`` holds a run: diagnostics to rtol 1e-5, the
last snapshot to 1e-5 of its largest mode, packets to 1e-4.
"""
import glob
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.core.steppers import zero_clock as jzero_clock  # noqa: E402
from juliaraytracingsw_tpu.coupled.driver import derive_nu  # noqa: E402
from juliaraytracingsw_tpu.coupled.initial_conditions import band_geo_wave_ic  # noqa: E402
from juliaraytracingsw_tpu.experiments.__main__ import main as jmain  # noqa: E402
from juliaraytracingsw_tpu.models import rsw as jrsw  # noqa: E402
from juliaraytracingsw_tpu.parallel import mesh as jmesh  # noqa: E402
from juliaraytracingsw_tpu.parallel.sharded_rsw import ShardedRSW as JShardedRSW  # noqa: E402
from juliaraytracingsw_tpu.rays.packets import lattice_packets as jlattice  # noqa: E402
from juliaraytracingsw_tpu.rays.raytrace import RayParams as JRayParams  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.core.steppers import zero_clock  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled.driver import (SimState,  # noqa: E402
                                                        make_coupled_frame)
from juliaraytracingsw_tpu_torch.experiments import __main__ as tcli  # noqa: E402
from juliaraytracingsw_tpu_torch.models import rsw  # noqa: E402
from juliaraytracingsw_tpu_torch.models.base import build_stepper  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.packets import Packets  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.raytrace import (RayParams,  # noqa: E402
                                                       fields_from_psih)
from torch_parallel_worker import Ranks  # noqa: E402

NX, F, CG, DT = 64, 3.0, 1.0, 2e-3
NU = derive_nu(1.0, NX, 4, DT)
K0 = float(np.sqrt(3.0) * F / CG)
K_CUTOFF = 100.0 * F / CG
CLI = ["rsw", "--nx", "32", "--sqrt-npackets", "16", "--seed", "3", "--spinup-T", "0.03",
       "--T", "0.15", "--output-dt", "0.03", "--max-writes", "3", "--sharded"]
CASES = ["rsw_step", "rsw_fields", "rsw_frame", "rsw_overlap", "rsw_frame3", "rsw_interop",
         "cli_restore"]


def _jax_cli(argv, mesh_size=2):
    """The JAX command line with its mesh cut to ``mesh_size`` devices."""
    real = jmesh.make_mesh
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmesh, "make_mesh", lambda n=None, **kw: real(mesh_size, **kw))
        jmain(argv)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_rsw")
    g = jmake_grid(NX)
    sol0 = np.asarray(band_geo_wave_ic(g, np.random.default_rng(1234), Kg=(4, 7), Kw=(0, 3),
                                       ag=0.3, aw=0.05, f=F, Cg=CG))
    packets = jlattice(8, g.Lx, g.Ly, k0=K0, k_ring=True)
    # the reference's --sharded run on a mesh of 2 writes the checkpoint
    # the ranks restore
    ckpt = str(tmp / "jax_ckpt.npz")
    _jax_cli(CLI + ["--out-dir", str(tmp / "jax_first"), "--checkpoint", ckpt])
    # the reference's sharded state after one frame, gathered to numpy
    jsol, jclock, jstate, jpk = _jax_frame(sol0, 5, whole=True)
    jax_state = {"sol": jsol, "N1": np.asarray(jstate.N1)[..., :NX // 2 + 1],
                 "N2": np.asarray(jstate.N2)[..., :NX // 2 + 1], "clock.t": np.asarray(jclock.t),
                 "clock.step": np.asarray(jclock.step),
                 **{f"packets.{n}": np.asarray(getattr(jpk, n))
                    for n in ("x", "y", "k", "l", "sign")}}
    inputs = {"nx": NX, "dt": DT, "nu": NU, "sol.rsw": sol0,
              **{f"jax_state.{k}": v for k, v in jax_state.items()},
              "cli_argv": np.asarray(CLI + ["--platform", "cpu"]), "cli_restore": ckpt,
              **{f"packets.{n}": np.asarray(getattr(packets, n))
                 for n in ("x", "y", "k", "l", "sign")}}
    job = Ranks.start(2, CASES, inputs, str(tmp))
    yield job, inputs, tmp
    job.close()


def _jax_sharded():
    g = jmake_grid(NX)
    model = jrsw.make_model(g, nu=NU, nnu=4, f=F, Cg=CG)
    mesh = jmesh.make_mesh(2)
    return g, model, mesh, JShardedRSW(g, model.params, mesh, dt=DT)


def _torch_case(inputs):
    g = make_grid(NX, device="cpu")
    model = rsw.make_model(g, nu=NU, nnu=4, f=F, Cg=CG)

    def psih_fn(sol):
        qh = g.ik * sol[1] - g.il * sol[0] - F * sol[2]
        return -qh / (g.Krsq + F ** 2 / CG ** 2)

    packets = Packets(*(torch.as_tensor(np.array(inputs[f"packets.{n}"]))
                        for n in ("x", "y", "k", "l", "sign")))
    return g, model, psih_fn, torch.as_tensor(np.array(inputs["sol.rsw"])), packets


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5 * np.abs(want).max(),
                               rtol=2e-4)


def _close_packets(got, want):
    for n in "xykl":
        np.testing.assert_allclose(got[n], np.asarray(getattr(want, n)), rtol=5e-4,
                                   atol=5e-5, err_msg=n)


def _jax_frame(sol0, flow_steps, whole=False, start=None):
    """The reference's sharded frame on a mesh of 2 from ``sol0`` (or from
    ``start`` = (sol, clock, AB3 state, packets), sharded) -> the gathered
    state, clock and packets (``whole``: also the AB3 state)."""
    g, model, mesh, jsh = _jax_sharded()
    rp = JRayParams(f=F, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]), dx=g.dx, dy=g.dy)
    frame = jsh.make_coupled_frame(rp, flow_steps, k_cutoff=K_CUTOFF, k0=K0)
    if start is None:
        pk = jmesh.shard_packets(jlattice(8, g.Lx, g.Ly, k0=K0, k_ring=True), mesh)
        init_s, _ = jsh.stepper()
        s = jsh.shard_solution(jnp.asarray(sol0))
        start = (s, jzero_clock(), init_s(s), pk)
    sol, clock, sstate, out = jax.block_until_ready(frame(*start))
    if whole:
        return jsh.unshard(sol), clock, sstate, out
    return jsh.unshard(sol), clock, out


class TestShardedFlow:
    def test_sharded_step_matches_replicated(self, ranks):
        job, inputs, _ = ranks
        _, _, _, jsh = _jax_sharded()
        init_s, step_s = jsh.stepper()
        s = jsh.shard_solution(jnp.asarray(inputs["sol.rsw"]))
        c, st = jzero_clock(), init_s(s)
        g, model, _, sol, _ = _torch_case(inputs)
        init_r, step_r = build_stepper(model, "IFMAB3", dt=DT)
        clock, state = zero_clock(device="cpu"), init_r(sol)
        for _ in range(10):
            s, c, st = step_s(s, c, st)
            sol, clock, state = step_r(sol, clock, state)
        got = job.result("rsw_step")
        _close(got["sol"], jsh.unshard(s))
        _close(got["sol"], sol.numpy())
        # pad columns stay identically zero (nkr 33 pads to 34 on 2 ranks)
        assert int(got["nkr_pad"]) == 34 and np.abs(got["pad"]).max() == 0.0

    def test_sharded_fields_match_replicated(self, ranks):
        job, inputs, _ = ranks
        _, _, _, jsh = _jax_sharded()
        want_jax = np.asarray(jsh.fields(jsh.shard_solution(jnp.asarray(inputs["sol.rsw"]))))
        g, _, psih_fn, sol, _ = _torch_case(inputs)
        got = job.result("rsw_fields")["fields"]
        _close(got, want_jax)
        _close(got, fields_from_psih(psih_fn(sol), g).numpy())


class TestShardedCoupled:
    def test_sharded_coupled_frame_matches_replicated(self, ranks):
        job, inputs, _ = ranks
        jsol, jclock, jpk = _jax_frame(inputs["sol.rsw"], 5)
        g, model, psih_fn, sol, packets = _torch_case(inputs)
        init_r, step_r = build_stepper(model, "IFMAB3", dt=DT)
        rp = RayParams(f=F, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]), dx=g.dx, dy=g.dy)
        rep = make_coupled_frame(model, step_r, psih_fn, rp, 5, k_cutoff=K_CUTOFF, k0=K0)(
            SimState(sol, zero_clock(device="cpu"), init_r(sol), packets,
                     fields_from_psih(psih_fn(sol), g)))
        got = job.result("rsw_frame")
        _close(got["sol"], jsol)
        _close(got["sol"], rep.sol.numpy())
        _close_packets(got, jpk)
        _close_packets(got, rep.packets)
        assert int(got["step"]) == int(jclock.step) == 5


def test_overlap_frame_matches_sequential(ranks):
    """The pipelined (overlap=True) frame advances the packets through the
    same field pairs as the sequential frame: the same trajectories."""
    got = ranks[0].result("rsw_overlap")
    np.testing.assert_array_equal(got["seq.sol"], got["ovl.sol"])
    for n in "xykl":
        np.testing.assert_allclose(got[f"ovl.{n}"], got[f"seq.{n}"], rtol=1e-6, atol=1e-7)
    assert int(got["ovl.step"]) == 5 and np.isclose(got["ovl.t"], got["seq.t"])


def test_table_kernel_path_matches_the_pallas_kernel_over_the_mesh(ranks, monkeypatch):
    """Each rank's RK4 ray step goes through the table substep
    (``ops/ray_step.table_substep``: ``csrc/ray_step.cu`` on the card, its
    twin here) on its own packets; the reference runs the fused Pallas
    substep (interpret mode) partitioned over its mesh of 2. The two
    sharded frames agree."""
    monkeypatch.setenv("JRSW_FUSED", "interpret")
    jax.clear_caches()
    try:
        jsol, _, jpk = _jax_frame(ranks[1]["sol.rsw"], 3)
    finally:
        monkeypatch.delenv("JRSW_FUSED")
        jax.clear_caches()
    got = ranks[0].result("rsw_frame3")
    _close(got["sol"], jsol)
    _close_packets(got, jpk)
    assert int(got["step"]) == 3


# --- --sharded checkpoints across the packages and mesh sizes --------------------

def _datasets(run_dir):
    out = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "*.h5"))):
        data = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda n, o: data.__setitem__(n, o[()])
                         if isinstance(o, h5py.Dataset) else None)
        out[os.path.basename(path)] = data
    return out


def _assert_runs_match(tdir, jdir):
    jd, td = _datasets(jdir), _datasets(tdir)
    assert sorted(td) == sorted(jd) and "diagnostics.h5" in jd
    last = max(int(k.rsplit("/", 1)[1]) for f in jd.values() for k in f
               if k.startswith("snapshots/sol/"))
    for name, data in jd.items():
        assert sorted(td[name]) == sorted(data), name
        for key, want in data.items():
            got = td[name][key]
            if name == "diagnostics.h5":
                np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=key)
            elif key == f"snapshots/sol/{last}":
                assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
            elif key.startswith("p/") and key.split("/")[1] in "xkug":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=key)
            elif key.startswith(("grid/", "params/", "clock/", "p/t/", "snapshots/t/")):
                np.testing.assert_array_equal(got, want, err_msg=key)


def test_jax_sharded_checkpoint_restores_at_p1_and_p2(ranks):
    """The reference's --sharded checkpoint (written on a mesh of 2)
    restores in the port on 2 ranks and on 1, and each run goes on as the
    reference's own restored run does."""
    job, inputs, tmp = ranks
    ckpt = str(inputs["cli_restore"])
    _jax_cli(CLI + ["--out-dir", str(tmp / "jax_restored"), "--restore", ckpt])
    tcli.run(CLI + ["--platform", "cpu", "--out-dir", str(tmp / "port_p1"), "--restore", ckpt],
             log_fn=lambda line: None)
    _assert_runs_match(str(tmp / "port_p1"), str(tmp / "jax_restored"))
    got = job.result("cli_restore")
    _assert_runs_match(str(got["out_dir"]), str(tmp / "jax_restored"))


def test_port_sharded_checkpoint_restores_in_jax(ranks):
    """The port's --sharded checkpoint (written by 2 ranks) restores in the
    reference's --sharded run on a mesh of 2, and in the port's on one
    rank: the two runs agree."""
    job, _, tmp = ranks
    ckpt = str(job.result("cli_restore")["checkpoint"])
    with np.load(ckpt) as f:
        paths = bytes(f["__treepaths__"]).decode().split("\n")
    assert paths[0] == "['N1']" and paths[-1] == "['sol']"
    _jax_cli(CLI + ["--out-dir", str(tmp / "jax_from_port"), "--restore", ckpt])
    tcli.run(CLI + ["--platform", "cpu", "--out-dir", str(tmp / "port_from_port"),
                    "--restore", ckpt], log_fn=lambda line: None)
    _assert_runs_match(str(tmp / "port_from_port"), str(tmp / "jax_from_port"))


def test_jax_sharded_state_carried_into_the_ranks(ranks):
    """``interop.sharded_state_from_numpy``: the reference's sharded state
    after one frame (its AB3 history and clock included), gathered to
    numpy, becomes the ranks' blocks; one more frame on each side agrees,
    and ``sharded_state_to_numpy`` carries the result back out."""
    job, inputs, _ = ranks
    g, model, mesh, jsh = _jax_sharded()
    state = {k[len("jax_state."):]: v for k, v in inputs.items() if k.startswith("jax_state.")}
    from juliaraytracingsw_tpu.core.steppers import AB3State, Clock
    from juliaraytracingsw_tpu.rays.packets import Packets as JPackets

    start = (jsh.shard_solution(jnp.asarray(state["sol"])),
             Clock(jnp.asarray(state["clock.t"]), jnp.asarray(state["clock.step"])),
             AB3State(jsh.shard_solution(jnp.asarray(state["N1"])),
                      jsh.shard_solution(jnp.asarray(state["N2"]))),
             jmesh.shard_packets(JPackets(*(jnp.asarray(state[f"packets.{n}"])
                                            for n in ("x", "y", "k", "l", "sign"))), mesh))
    jsol, jclock, jstate, jpk = _jax_frame(None, 5, whole=True, start=start)
    got = job.result("rsw_interop")
    assert int(got["clock.step"]) == int(jclock.step) == 10
    np.testing.assert_allclose(got["clock.t"], np.asarray(jclock.t), rtol=1e-6)
    _close(got["sol"], jsol)
    for name in ("N1", "N2"):
        _close(got[name], jsh.unshard(getattr(jstate, name)))
    _close_packets({n: got[f"packets.{n}"] for n in "xykl"}, jpk)
