"""The port's Thomas-Yamada driver on the CPU, against the JAX package's:
the eigenbasis-projected initial condition from the same numpy seed, the
two-phase coarse -> fine run at 32^2 with its files and diagnostics, the
restart from a finished run's snapshots (of either package), a TY state
checkpointed by one package and restored by the other, and the sharded
driver against both packages' (a mesh of one process here; the
multi-process runs are ``tests/test_torch_sharded_models.py``'s).

Tolerances: the initial condition to 1e-6 of its largest mode (numpy
draws bit-equal, then one FFT round trip in each package: measured
1.5e-7); diagnostics and the last state of a run to 1e-5 relative
(measured 2e-7-5e-7 through 8 chunks of ETDRK4 steps).
"""
import os

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.core import steppers as jstep  # noqa: E402
from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.coupled import ty_driver as jty_driver  # noqa: E402
from juliaraytracingsw_tpu.coupled.initial_conditions import (  # noqa: E402
    ty_initial_condition as jty_ic)
from juliaraytracingsw_tpu.io import checkpoint as jck  # noqa: E402
from juliaraytracingsw_tpu_torch.core import steppers as tstep  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled import ty_driver as tty_driver  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled.initial_conditions import (  # noqa: E402
    ty_initial_condition as tty_ic)
from juliaraytracingsw_tpu_torch.io import checkpoint as tck  # noqa: E402
from juliaraytracingsw_tpu_torch.models import thomasyamada as tty  # noqa: E402
from juliaraytracingsw_tpu_torch.models.base import build_stepper, run  # noqa: E402

IC_RTOL = 1e-6
RUN_RTOL = 1e-5


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel_err(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("bands,amps", [(((2, 5), (6, 9)), (0.1, 0.2, 0.05)),
                                        (((2, 6), (2, 6)), (0.0, 0.0, 0.3))])
def test_initial_condition_matches_jax(bands, amps):
    got = tty_ic(tmake_grid(32, device="cpu"), np.random.default_rng(11), *bands, *amps)
    want = jty_ic(jmake_grid(32), np.random.default_rng(11), *bands, *amps)
    assert got.dtype == torch.complex64 and got.shape == (4, 32, 17)
    assert _rel_err(got, want) < IC_RTOL


def _cfgs(out_dir, **kw):
    """The same run configuration for both packages."""
    base = dict(nx=32, nu=1e-10, nnu=4, Ro=0.2, stepper="ETDRK4",
                startup_dt=2e-3, startup_nsteps=20, startup_nsubs=5,
                dt=1e-3, nsteps=20, nsubs=5,
                k0g_range=(2, 5), k0w_range=(0, 4), at=0.05, ag=0.05, aw=0.02,
                max_writes=100, log_fn=lambda *a: None)
    base.update(kw)
    return (jty_driver.TYRunConfig(out_dir=os.path.join(out_dir, "jax"), **base),
            tty_driver.TYRunConfig(out_dir=os.path.join(out_dir, "torch"), device="cpu",
                                   **base))


def _files(run_dir):
    out = {}
    for name in sorted(os.listdir(run_dir)):
        with h5py.File(os.path.join(run_dir, name), "r") as f:
            data = {}
            f.visititems(lambda n, o: data.__setitem__(n, o[()])
                         if isinstance(o, h5py.Dataset) else None)
        out[name] = data
    return out


def test_two_phase_run_matches_jax(tmp_path):
    jcfg, tcfg = _cfgs(str(tmp_path))
    sol_j, clock_j, diags_j = jty_driver.run_thomasyamada(jcfg)
    sol_t, clock_t, diags_t = tty_driver.run_thomasyamada(tcfg)
    assert clock_t.step == int(clock_j.step) == 40
    assert float(clock_t.t) == float(clock_j.t)
    assert _rel_err(sol_t, sol_j) < RUN_RTOL
    assert sorted(diags_t) == sorted(diags_j)
    for key, want in diags_j.items():
        assert len(diags_t[key]) == len(want) == 8
        np.testing.assert_allclose(diags_t[key], want, rtol=RUN_RTOL, err_msg=key)
    jf, tf = _files(jcfg.out_dir), _files(tcfg.out_dir)
    assert sorted(tf) == sorted(jf) == ["diagnostics.h5", "startup.000000.h5", "ty.000000.h5"]
    for name, data in jf.items():
        assert sorted(tf[name]) == sorted(data), name
        for key, want in data.items():
            got = tf[name][key]
            assert np.asarray(got).dtype == np.asarray(want).dtype, (name, key)
            if key.startswith("snapshots/sol/") or name == "diagnostics.h5":
                assert _rel_err(got, want) < RUN_RTOL, (name, key)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {key}")


def test_restart_from_either_package(tmp_path):
    """Each package restarts from the JAX run's last snapshot; the two
    restarted runs agree, and the port's loader returns that snapshot."""
    jcfg, tcfg = _cfgs(str(tmp_path / "first"))
    sol1, _, _ = jty_driver.run_thomasyamada(jcfg)
    first = os.path.join(jcfg.out_dir, "ty")
    loaded, step = tty_driver.ty_restart_solution(first, device="cpu")
    assert step == 40 and loaded.dtype == torch.complex64
    np.testing.assert_array_equal(_np(loaded), np.asarray(sol1))
    jcfg2, tcfg2 = _cfgs(str(tmp_path / "second"), restart_file=first, restart_frame=30)
    sol_j, _, diags_j = jty_driver.run_thomasyamada(jcfg2)
    sol_t, _, diags_t = tty_driver.run_thomasyamada(tcfg2)
    assert _rel_err(sol_t, sol_j) < RUN_RTOL
    np.testing.assert_allclose(diags_t["geo_ke"], diags_j["geo_ke"], rtol=RUN_RTOL)


def test_ty_checkpoint_restores_in_either_package(tmp_path):
    """A TY stepping state (sol, clock, ETDRK4's empty stepper state) saved
    by one package loads in the other, leaf for leaf."""
    tg = tmake_grid(32, device="cpu")
    sol = tty_ic(tg, np.random.default_rng(3), (2, 5), (0, 4), 0.05, 0.05, 0.02)
    model = tty.make_model(tg)
    init, step = build_stepper(model, "ETDRK4", 1e-3)
    sol, clock, state = run(step, sol, tstep.zero_clock(device="cpu"), init(sol), 3)
    tree_t = {"sol": sol, "clock": clock, "state": state}
    tck.save_checkpoint(str(tmp_path / "t.npz"), tree_t)
    like_j = {"sol": jnp.zeros((4, 32, 17), jnp.complex64), "clock": jstep.zero_clock(),
              "state": jstep.EmptyState()}
    got_j = jck.load_checkpoint(str(tmp_path / "t.npz"), like_j)
    np.testing.assert_array_equal(np.asarray(got_j["sol"]), _np(sol))
    assert int(got_j["clock"].step) == 3 and float(got_j["clock"].t) == float(clock.t)
    jck.save_checkpoint(str(tmp_path / "j.npz"), got_j)
    got_t = tck.load_checkpoint(str(tmp_path / "j.npz"), tree_t)
    assert torch.equal(got_t["sol"], sol) and got_t["clock"].step == 3
    assert got_t["state"] == tstep.EmptyState()


def test_sharded_driver_names_its_item(tmp_path):
    """The sharded two-phase run (a mesh of one process) against the JAX
    package's sharded driver on a mesh of 2 (both IF-AB3 whatever the
    configuration's stepper), and against the port's replicated driver
    stepping IF-AB3: the same files, diagnostics and final state."""
    from juliaraytracingsw_tpu.parallel.mesh import make_mesh as jmake_mesh
    from juliaraytracingsw_tpu_torch.parallel.mesh import make_mesh

    jcfg, tcfg = _cfgs(str(tmp_path / "sharded"))
    sol_j, clock_j, diags_j = jty_driver.run_thomasyamada_sharded(jcfg, jmake_mesh(2))
    sol_t, clock_t, diags_t = tty_driver.run_thomasyamada_sharded(
        tcfg, make_mesh(device="cpu"))
    assert clock_t.step == int(clock_j.step) == 40 and sol_t.shape == (4, 32, 17)
    assert _rel_err(sol_t, sol_j) < RUN_RTOL
    for key, want in diags_j.items():
        np.testing.assert_allclose(diags_t[key], want, rtol=RUN_RTOL, err_msg=key)
    jf, tf = _files(jcfg.out_dir), _files(tcfg.out_dir)
    assert sorted(tf) == sorted(jf) == ["diagnostics.h5", "startup.000000.h5", "ty.000000.h5"]
    for name, data in jf.items():
        assert sorted(tf[name]) == sorted(data), name
    _, rcfg = _cfgs(str(tmp_path / "replicated"), stepper="IFMAB3")
    sol_r, _, diags_r = tty_driver.run_thomasyamada(rcfg)
    assert _rel_err(sol_t, sol_r) < RUN_RTOL
    np.testing.assert_allclose(diags_t["wave_ke"], diags_r["wave_ke"], rtol=RUN_RTOL)
