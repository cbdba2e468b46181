"""The port's ``parallel/`` on 4 gloo ranks and in one process, against the
JAX package (the port's counterpart of ``tests/test_parallel.py`` and
``tests/test_launcher.py``): the slab FFT on meshes of 2 and 4, packets
split over the ranks, the all-reduced gradient, the dry run, the mesh
helpers, and the launcher's pure resolution logic.

One job of 4 spawned ranks runs every multi-process case
(``tests/torch_parallel_worker.py``); cases on a mesh of 2 run on its
first two ranks (``make_mesh(2)``, as the reference takes its first two
devices). The reference's dense-DFT cases and its graft-entry compile are
TPU-only and have no counterpart. Tolerances: the JAX tests' (the
spectrum to 1e-3 absolute, the round trip to 1e-5, sharded against
unsharded rays to 1e-5 and gradients to 1e-6); against the JAX package,
whose FFTs round differently, 1e-5 of the largest value for the spectrum
and the packets and 1e-4 for gradients (float32).
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.coupled.initial_conditions import (  # noqa: E402
    random_band_psih as jrandom_band_psih)
from juliaraytracingsw_tpu.parallel import launcher as jl  # noqa: E402
from juliaraytracingsw_tpu.parallel.fft import slab_rfft2 as jslab_rfft2  # noqa: E402
from juliaraytracingsw_tpu.parallel.fft import slab_sharding_physical  # noqa: E402
from juliaraytracingsw_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from juliaraytracingsw_tpu.rays import raytrace as jrt  # noqa: E402
from juliaraytracingsw_tpu.rays.packets import lattice_packets as jlattice  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.parallel import dryrun  # noqa: E402
from juliaraytracingsw_tpu_torch.parallel import launcher as tl  # noqa: E402
from juliaraytracingsw_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from juliaraytracingsw_tpu_torch.parallel.fft import padded_nkr  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import raytrace as trt  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.packets import Packets  # noqa: E402
from torch_parallel_worker import Ranks  # noqa: E402

CASES = ["slab_fft", "sharded_rays", "gradient_all_reduce", "dryrun", "mesh_helpers"]


def _inputs():
    rng = np.random.default_rng(1234)
    g = jmake_grid(32)
    psih = np.asarray(jrandom_band_psih(g, rng, amp=0.05))
    packets = jlattice(8, g.Lx, g.Ly, k0=5.0)     # 64 packets
    return {"nx": 32, "field": rng.standard_normal((3, 32, 32)).astype(np.float32),
            "field_small": rng.standard_normal((1, 32, 32)).astype(np.float32),
            "psih": psih, **{f"packets.{n}": np.asarray(getattr(packets, n))
                             for n in ("x", "y", "k", "l", "sign")}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = _inputs()
    job = Ranks.start(4, CASES, inputs, str(tmp_path_factory.mktemp("parallel")))
    yield job, inputs
    job.close()


def _rp(g, mod):
    return mod.RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]), dx=g.dx, dy=g.dy)


class TestSlabFFT:
    def test_roundtrip_and_match(self, ranks):
        job, inputs = ranks
        f = inputs["field"]
        ref = np.fft.rfft2(f, axes=(-2, -1))
        jspec = np.asarray(jslab_rfft2(jax.device_put(
            jnp.asarray(f), slab_sharding_physical(jmake_mesh(2))), jmake_mesh(2)))
        got = job.result("slab_fft")
        assert int(got["p2.size"]) == 2 and got["p2.spec"].shape == (3, 32, padded_nkr(32, 2))
        spec = got["p2.spec"][..., :17]
        np.testing.assert_allclose(np.abs(spec - ref).max(), 0.0, atol=1e-3)
        np.testing.assert_allclose(spec, jspec[..., :17], rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        assert np.abs(got["p2.spec"][..., 17:]).max() == 0.0   # the pad column
        np.testing.assert_allclose(got["p2.back"], f, atol=1e-5)
        # one all_to_all a transform (two round trips)
        assert int(got["p2.all_to_all"]) == 4

    def test_roundtrip_composes(self, ranks):
        got = ranks[0].result("slab_fft")
        np.testing.assert_allclose(got["p2.small_back"], ranks[1]["field_small"], atol=1e-5)

    def test_four_ranks_pad_nkr_17_to_20(self, ranks):
        job, inputs = ranks
        got = job.result("slab_fft")
        assert int(got["pall.size"]) == 4 and got["pall.spec"].shape[-1] == 20
        ref = np.fft.rfft2(inputs["field"], axes=(-2, -1))
        np.testing.assert_allclose(got["pall.spec"][..., :17], ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        assert np.abs(got["pall.spec"][..., 17:]).max() == 0.0
        np.testing.assert_allclose(got["pall.back"], inputs["field"], atol=1e-5)
        np.testing.assert_allclose(got["pall.small_back"], inputs["field_small"], atol=1e-5)


def _torch_setup(inputs):
    g = make_grid(32, device="cpu")
    packets = Packets(*(torch.as_tensor(np.array(inputs[f"packets.{n}"]))
                        for n in ("x", "y", "k", "l", "sign")))
    return g, packets, torch.as_tensor(np.array(inputs["psih"]))


class TestShardedRays:
    def test_sharded_matches_unsharded(self, ranks):
        job, inputs = ranks
        g, packets, psih = _torch_setup(inputs)
        f = trt.fields_from_psih(psih, g)
        ref = trt.raytrace(packets, f, f, 0.0, 0.1, _rp(g, trt), nsubsteps=4)
        jg = jmake_grid(32)
        jf = jrt.fields_from_psih(jnp.asarray(inputs["psih"]), jg)
        jref = jrt.raytrace(jlattice(8, jg.Lx, jg.Ly, k0=5.0), jf, jf, 0.0, 0.1,
                            _rp(jg, jrt), nsubsteps=4)
        got = job.result("sharded_rays")
        assert int(got["local_n"]) == 32
        np.testing.assert_allclose(got["x"], ref.x.numpy(), atol=1e-5)
        np.testing.assert_allclose(got["k"], ref.k.numpy(), atol=1e-5)
        np.testing.assert_allclose(got["x"], np.asarray(jref.x), atol=1e-5)
        np.testing.assert_allclose(got["k"], np.asarray(jref.k), atol=1e-5 * 5.0)

    def test_gradient_all_reduce_across_shards(self, ranks):
        """The gradient of a loss over packets split on 2 ranks, with
        respect to the replicated flow, equals the unsharded gradient (the
        reference's psum is the differentiable all_reduce here)."""
        job, inputs = ranks
        g, packets, psih = _torch_setup(inputs)
        psih = psih.requires_grad_(True)
        f = trt.fields_from_psih(psih, g)
        out = trt.raytrace(packets, f, f, 0.0, 0.1, _rp(g, trt), nsubsteps=2)
        loss = (out.k ** 2 + out.l ** 2).mean()
        (ref,) = torch.autograd.grad(loss, psih)
        jg = jmake_grid(32)

        def jloss(ph):
            jf = jrt.fields_from_psih(ph, jg)
            o = jrt.raytrace(jlattice(8, jg.Lx, jg.Ly, k0=5.0), jf, jf, 0.0, 0.1, _rp(jg, jrt),
                             nsubsteps=2)
            return jnp.mean(o.k ** 2 + o.l ** 2)

        # a real loss of a complex input: JAX's gradient is the conjugate
        # of PyTorch's
        jgrad = np.conj(np.asarray(jax.grad(jloss)(jnp.asarray(inputs["psih"]))))
        got = job.result("gradient_all_reduce")
        np.testing.assert_allclose(float(got["loss"]), float(loss.detach()), rtol=1e-6)
        np.testing.assert_allclose(np.abs(got["grad"] - ref.numpy()).max(), 0.0, atol=1e-6)
        np.testing.assert_allclose(got["grad"], jgrad, rtol=0,
                                   atol=1e-4 * np.abs(jgrad).max())


def test_dryrun_multichip_entrypoint(ranks):
    """The dry run on meshes of 2 and 4: the loss and the all-reduced
    gradient equal one process's over all the packets; the slab FFT round
    trip and the sharded frames' checks pass inside it."""
    got = ranks[0].result("dryrun")
    for tag, size in (("p2", 2), ("pall", 4)):
        assert int(got[f"{tag}.size"]) == size
        n = int(got[f"{tag}.n"])
        assert n % size == 0 and n >= 32 * size
        case = dryrun.build_case(32, int(np.sqrt(n)), "cpu")
        loss, grad, _, _ = dryrun.training_step(case, case[5], n)
        np.testing.assert_allclose(float(got[f"{tag}.loss"]), float(loss), rtol=1e-6)
        np.testing.assert_allclose(got[f"{tag}.grad"], grad.numpy(), rtol=0,
                                   atol=1e-5 * float(grad.abs().max()))
        assert float(got[f"{tag}.slab_err"]) < 1e-4


def test_mesh_helpers_shard_gather_replicate(ranks):
    """``shard_packets``/``gather_packets`` round trip; ``replicate``
    broadcasts rank 0's tree; an uneven split is refused; the finite flag
    is reduced over every rank."""
    got = ranks[0].result("mesh_helpers")
    assert bool(got["equal"]) and int(got["local_n"]) == 16
    np.testing.assert_array_equal(got["rep_a"], np.zeros(3, np.complex64))
    np.testing.assert_array_equal(got["rep_t"], np.zeros(3, np.float32))
    assert "not divisible by mesh size 4" in str(got["refused"])
    assert bool(got["finite_ok"]) and not bool(got["finite_bad"])


def test_mesh_on_the_card_needs_one(monkeypatch):
    """No card: a mesh on 'cuda' fails before any process group exists."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmesh.make_mesh(device="cuda")


# --- the launcher: the same spec as the reference's for every environment ------

ENVS = {
    "single": {},
    "explicit": {"JRSW_COORDINATOR": "10.0.0.1:1234", "JRSW_NUM_PROCESSES": "4",
                 "JRSW_PROCESS_ID": "3"},
    "explicit-no-coordinator": {"JRSW_NUM_PROCESSES": "2"},
    "slurm-brackets": {"SLURM_PROCID": "2", "SLURM_NTASKS": "8",
                       "SLURM_JOB_NODELIST": "gpu-[003-010,012]"},
    "slurm-list-port": {"SLURM_PROCID": "0", "SLURM_NTASKS": "2",
                        "SLURM_STEP_NODELIST": "nodeA,nodeB", "JRSW_PORT": "9000"},
    "slurm-single-task": {"SLURM_PROCID": "0", "SLURM_NTASKS": "1"},
    "mpi": {"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
            "JRSW_COORDINATOR": "h:1"},
    "tpu-single-host": {"TPU_WORKER_HOSTNAMES": "localhost"},
    "tpu-multi-host": {"TPU_WORKER_HOSTNAMES": "host0,host1,host2"},
    "tpu-task-id": {"CLOUD_TPU_TASK_ID": "3", "TPU_WORKER_HOSTNAMES": "localhost"},
}


@pytest.mark.parametrize("env", list(ENVS.values()), ids=list(ENVS))
def test_resolve_cluster_matches_jax(env):
    got, want = tl.resolve_cluster(env), jl.resolve_cluster(env)
    assert (got.coordinator, got.num_processes, got.process_id, got.source) == (
        want.coordinator, want.num_processes, want.process_id, want.source)


def test_resolve_single():
    assert tl.resolve_cluster({}) == tl.ClusterSpec(None, 1, 0, source="single")


def test_resolve_slurm_nodelist_expansion():
    spec = tl.resolve_cluster(ENVS["slurm-brackets"])
    assert spec.source == "slurm" and spec.coordinator == "gpu-003:8476"
    assert (spec.num_processes, spec.process_id) == (8, 2)
    assert tl.resolve_cluster(ENVS["slurm-list-port"]).coordinator == "nodeA:9000"
    for nodelist in ("gpu-[003-010,012]", "nodeA,nodeB", "n7", "a[1-4]"):
        assert tl._first_slurm_host(nodelist) == jl._first_slurm_host(nodelist)


def test_resolve_mpi_requires_coordinator():
    env = {"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1"}
    for mod in (tl, jl):
        with pytest.raises(RuntimeError, match="JRSW_COORDINATOR"):
            mod.resolve_cluster(env)


def test_initialize_single_process_noop():
    """A single process brings up no process group."""
    import torch.distributed as dist

    before = dist.is_initialized()
    assert tl.initialize_from_env({}).source == "single"
    assert tmesh.init_distributed(num_processes=1) == 0
    assert dist.is_initialized() == before


def test_initialize_refuses_a_tpu_pod():
    with pytest.raises(RuntimeError, match="TPU"):
        tl.initialize_from_env(ENVS["tpu-multi-host"])


def test_sweep_row_from_env():
    rows = [{"a": "1"}, {"a": "2"}, {"a": "3"}]
    for env in ({"JRSW_SWEEP_INDEX": "2"}, {"SLURM_ARRAY_TASK_ID": "1"}):
        assert tl.sweep_row_from_env(rows, env) == jl.sweep_row_from_env(rows, env)
    with pytest.raises(RuntimeError):
        tl.sweep_row_from_env(rows, {})


def test_launch_sweep_runs_rows(tmp_path):
    out = tmp_path / "sweep"
    script = tmp_path / "job.py"
    script.write_text(
        "import sys, os, json\n"
        "args = dict(zip(sys.argv[1::2], sys.argv[2::2]))\n"
        "os.makedirs(args['--out'], exist_ok=True)\n"
        "open(os.path.join(args['--out'], 'done.json'), 'w').write(\n"
        "    json.dumps({'ag': args['--ag'], 'idx': os.environ['JRSW_SWEEP_INDEX']}))\n")
    rows = [{"ag": "0.5"}, {"ag": "1.5"}, {"ag": "2.5"}]
    assert tl.launch_sweep([sys.executable, str(script)], rows, str(out),
                           max_parallel=2) == [0, 0, 0]
    for i, row in enumerate(rows):
        rec = json.loads((out / f"run{i:03d}" / "done.json").read_text())
        assert rec == {"ag": row["ag"], "idx": str(i)}


def test_launch_sweep_dry_run(capsys, tmp_path):
    assert tl.launch_sweep(["prog"], [{"x": "1"}], str(tmp_path), dry_run=True) == [0]
    assert "--x 1" in capsys.readouterr().out


def test_cli_sweep_picks_array_row(tmp_path):
    from juliaraytracingsw_tpu_torch.config.params import load_sweep_table

    table = tmp_path / "params.txt"
    table.write_text("ArrayTaskID ag\n1 0.5\n2 1.5\n")
    env = dict(os.environ, SLURM_ARRAY_TASK_ID="2")
    assert tl.sweep_row_from_env(load_sweep_table(str(table)), env)["ag"] == "1.5"


def test_every_public_name_has_a_counterpart():
    """Each public name of the reference's ``parallel/`` modules exists in
    the port's module of the same name; only the dense-DFT backend
    (``fft._dense_*``, TPU-only) is left out, and it is not public."""
    import importlib

    for name in ("mesh", "fft", "sharded", "sharded_rsw", "launcher"):
        ref = importlib.import_module(f"juliaraytracingsw_tpu.parallel.{name}")
        port = importlib.import_module(f"juliaraytracingsw_tpu_torch.parallel.{name}")
        missing = [n for n in ref.__all__ if not hasattr(port, n)]
        assert not missing and set(ref.__all__) <= set(port.__all__), (name, missing)


def test_dryrun_command_line_on_one_process():
    """``python -m juliaraytracingsw_tpu_torch.parallel.dryrun --platform
    cpu``: one process, a mesh of one, every check of the dry run."""
    import subprocess

    out = subprocess.run([sys.executable, "-m", "juliaraytracingsw_tpu_torch.parallel.dryrun",
                          "--platform", "cpu"], capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "dry run on a mesh of 1 (gloo)" in out.stdout and "36 packets" in out.stdout
