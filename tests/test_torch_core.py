"""Parity of the PyTorch port's flow half with the JAX package on the CPU.

The same numpy inputs go through the JAX function and its counterpart in
``juliaraytracingsw_tpu_torch``; every comparison states its tolerance.
Grid arrays, the expm tables and the filter are built by the same numpy
code in both packages and must agree exactly. Transforms go through two
different FFT libraries (XLA's and PyTorch's), so they agree to float32
round-off: relative 2e-6 of the field's largest magnitude for one
transform, looser where steps accumulate it.
"""
import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.core import grid as jgrid  # noqa: E402
from juliaraytracingsw_tpu.core import spectral as jspec  # noqa: E402
from juliaraytracingsw_tpu.core import steppers as jstep  # noqa: E402
from juliaraytracingsw_tpu.core.filters import make_filter as jmake_filter  # noqa: E402
from juliaraytracingsw_tpu.coupled import initial_conditions as jic  # noqa: E402
from juliaraytracingsw_tpu.models import base as jbase  # noqa: E402
from juliaraytracingsw_tpu.models import rsw as jrsw  # noqa: E402
from juliaraytracingsw_tpu_torch.core import grid as tgrid  # noqa: E402
from juliaraytracingsw_tpu_torch.core import spectral as tspec  # noqa: E402
from juliaraytracingsw_tpu_torch.core import steppers as tstep  # noqa: E402
from juliaraytracingsw_tpu_torch.core.filters import make_filter as tmake_filter  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled import initial_conditions as tic  # noqa: E402
from juliaraytracingsw_tpu_torch.models import base as tbase  # noqa: E402
from juliaraytracingsw_tpu_torch.models import rsw as trsw  # noqa: E402

PORT = Path(__file__).resolve().parent.parent / "juliaraytracingsw_tpu_torch"

# one forward or inverse transform: float32 round-off of two FFT libraries
FFT_RTOL = 2e-6


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel_err(a, b):
    """max |a - b| over max |b|: one number per comparison."""
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _grids(nx, ny=None, Ly=None):
    kw = dict(ny=ny, Ly=Ly)
    return jgrid.make_grid(nx, **kw), tgrid.make_grid(nx, **kw, device="cpu")


def _ic(nx, seed=3):
    jg, tg = _grids(nx)
    sol_j = jic.band_geo_wave_ic(jg, np.random.default_rng(seed), ag=0.5, aw=0.05)
    sol_t = tic.band_geo_wave_ic(tg, np.random.default_rng(seed), ag=0.5, aw=0.05)
    return jg, tg, sol_j, sol_t


@pytest.mark.parametrize("shape", [(32, None, None), (48, 32, 4.0)])
def test_grid_arrays_exact(shape):
    jg, tg = _grids(*shape)
    assert (tg.nx, tg.ny, tg.nkr, tg.nl) == (jg.nx, jg.ny, jg.nkr, jg.nl)
    assert (tg.Lx, tg.Ly, tg.dx, tg.dy) == (jg.Lx, jg.Ly, jg.dx, jg.dy)
    for name in ("x", "y", "kr", "l", "Krsq", "invKrsq", "dealias_mask"):
        a, b = _np(getattr(tg, name)), _np(getattr(jg, name))
        assert a.dtype == np.float32 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert float(tg.invKrsq[0, 0]) == 0.0
    for name in ("ik", "il"):
        a, b = _np(getattr(tg, name)), _np(getattr(jg, name))
        assert a.dtype == np.complex64 and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    field = np.random.default_rng(0).standard_normal(jg.spectral_shape)
    np.testing.assert_array_equal(
        _np(tg.dealias(torch.as_tensor(field.astype(np.complex64)))),
        _np(jg.dealias(jnp.asarray(field, jnp.complex64))))


def test_transforms_match():
    jg, tg = _grids(64)
    rng = np.random.default_rng(1)
    phys = rng.standard_normal((3, 64, 64)).astype(np.float32)
    spec = np.fft.rfft2(phys).astype(np.complex64)
    pj, pt = jnp.asarray(phys), torch.as_tensor(phys)
    sj, st = jnp.asarray(spec), torch.as_tensor(spec)
    cases = {
        "rfft2": (tspec.rfft2(pt), jspec.rfft2(pj)),
        "irfft2": (tspec.irfft2(st, 64), jspec.irfft2(sj, 64)),
        "rfft2_dealiased": (tspec.rfft2_dealiased(pt, tg),
                            jspec.rfft2_dealiased(pj, jg)),
        "irfft2_dealiased": (tspec.irfft2_dealiased(st, tg),
                             jspec.irfft2_dealiased(sj, jg)),
        "enforce_reality": (tspec.enforce_reality(st, tg),
                            jspec.enforce_reality(sj, jg)),
    }
    for name, (t, j) in cases.items():
        assert t.dtype in (torch.float32, torch.complex64), name
        assert _rel_err(t, j) < FFT_RTOL, (name, _rel_err(t, j))
    for t, j in zip(tspec.spectral_gradients(st[0], tg),
                    jspec.spectral_gradients(sj[0], jg)):
        np.testing.assert_array_equal(_np(t), _np(j))
    # Parseval sums reduce 64*33 modes: float32 sums in another order
    for fn in ("parseval_sum2", "parseval_sum"):
        t, j = getattr(tspec, fn)(st, tg), getattr(jspec, fn)(sj, jg)
        np.testing.assert_allclose(_np(t), _np(j), rtol=1e-5)


def test_expm_tables_and_filter_exact():
    jg, tg = _grids(32)
    params = jrsw.RSWParams(nu=1e-6, nnu=2, f=3.0, Cg2=1.0)
    Lj = jrsw.build_L(jg, params)
    Lt = trsw.build_L(tg, trsw.RSWParams(**vars(params)))
    np.testing.assert_array_equal(_np(Lt), Lj)
    for e_t, e_j in zip(tstep.expm_tables(Lt, 1e-3), jstep.expm_tables(Lj, 1e-3)):
        assert e_t.dtype == torch.complex64
        np.testing.assert_array_equal(_np(e_t), e_j)
    # the diagonal branch
    d = np.random.default_rng(2).standard_normal((32, 17)).astype(np.complex64)
    for e_t, e_j in zip(tstep.expm_tables(d, 0.1), jstep.expm_tables(d, 0.1)):
        np.testing.assert_array_equal(_np(e_t), e_j)
    np.testing.assert_array_equal(_np(tmake_filter(tg)), _np(jmake_filter(jg)))


def test_initial_conditions_same_seed():
    jg, tg, sol_j, sol_t = _ic(64)
    assert sol_t.dtype == torch.complex64 and tuple(sol_t.shape) == (3, 64, 33)
    # identical numpy spectra; enforce_reality is one FFT round trip
    assert _rel_err(sol_t, sol_j) < 2 * FFT_RTOL
    psi_t = tic.random_band_psih(tg, np.random.default_rng(4))
    psi_j = jic.random_band_psih(jg, np.random.default_rng(4))
    assert _rel_err(psi_t, psi_j) < FFT_RTOL


def test_rsw_calcN_and_energies():
    jg, tg, sol_j, sol_t = _ic(64)
    mj = jrsw.make_model(jg, nu=1e-8, nnu=4, f=3.0, Cg=1.0)
    mt = trsw.make_model(tg, nu=1e-8, nnu=4, f=3.0, Cg=1.0)
    # 7 inverse and 4 forward transforms around a product (measured 2e-7)
    assert _rel_err(mt.calcN(sol_t, 0.0), mj.calcN(sol_j, 0.0)) < 1e-6
    for t, j in zip(trsw.updatevars(sol_t, tg, mt.params),
                    jrsw.updatevars(sol_j, jg, mj.params)):
        assert _rel_err(t, j) < 4 * FFT_RTOL
    for name in ("kinetic_energy", "total_energy"):
        args_t = (sol_t, tg) + ((mt.params,) if name == "total_energy" else ())
        args_j = (sol_j, jg) + ((mj.params,) if name == "total_energy" else ())
        np.testing.assert_allclose(float(getattr(trsw, name)(*args_t)),
                                   float(getattr(jrsw, name)(*args_j)), rtol=1e-5)
    np.testing.assert_allclose(
        float(trsw.potential_energy(sol_t, tg, mt.params)),
        float(jrsw.potential_energy(sol_j, jg, mj.params)), rtol=1e-5)


@pytest.mark.parametrize("nsteps,tol", [(1, 1e-6), (20, 2e-6)])
def test_ifab3_steps_match(nsteps, tol):
    """1 step runs the forward-Euler bootstrap; 20 steps run AB3 from step 3
    on. Measured 2e-7 after either; the tolerance grows with the steps that
    accumulate round-off."""
    dt = 2e-3
    jg, tg, sol_j, sol_t = _ic(64)
    mj = jrsw.make_model(jg, nu=1e-8, nnu=4, f=3.0, Cg=1.0)
    mt = trsw.make_model(tg, nu=1e-8, nnu=4, f=3.0, Cg=1.0)
    ij, sj = jbase.build_stepper(mj, "IFMAB3", dt)
    it, s_t = tbase.build_stepper(mt, "IFMAB3", dt)
    out_j = jbase.run(sj, sol_j, jstep.zero_clock(), ij(sol_j), nsteps)
    out_t = tbase.run(s_t, sol_t, tstep.zero_clock(device="cpu"), it(sol_t), nsteps)
    assert out_t[1].step == nsteps == int(out_j[1].step)
    assert out_t[1].t.dtype == torch.float32
    assert float(out_t[1].t) == float(out_j[1].t)   # float32 accumulation
    assert _rel_err(out_t[0], out_j[0]) < tol
    for a, b in zip(out_t[2], out_j[2]):            # AB3 history N1, N2
        assert _rel_err(a, b) < tol


def test_stepper_registry():
    _, tg = _grids(16)
    mt = trsw.make_model(tg)
    with pytest.raises(ValueError, match="IFMAB3"):
        tbase.build_stepper(mt, "NoSuchStepper")
    assert set(tbase.STEPPERS) <= set(jbase.STEPPERS)
    init, step = tbase.build_stepper(mt, "ETDAB3", 1e-3, use_filter=True)
    sol = torch.zeros((3, 16, 9), dtype=torch.complex64)
    out, clock, _ = step(sol, tstep.zero_clock(device="cpu"), init(sol))
    assert clock.step == 1 and torch.count_nonzero(out) == 0


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax():
    """AST scan (``sys.modules`` cannot tell: jax may be imported already
    by the interpreter's start-up). The port imports neither jax nor the
    JAX package, directly or through a helper of that package."""
    files = sorted(PORT.rglob("*.py"))
    assert len(files) >= 15
    bad = []
    for f in files:
        for name in _imports(ast.parse(f.read_text(), str(f))):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "juliaraytracingsw_tpu"):
                bad.append(f"{f.relative_to(PORT)}: {name}")
    assert not bad, bad


@pytest.mark.parametrize("entry", ["core.grid.make_grid", "core.steppers.zero_clock",
                                   "rays.packets.lattice_packets",
                                   "interop.sim_state_from_numpy",
                                   "analysis.suite.analyze_run",
                                   "coupled.ty_driver.ty_restart_solution",
                                   "coupled.ty_driver.TYRunConfig",
                                   "experiments.__main__.build_parser"])
def test_entry_points_default_to_the_card(entry):
    """A caller who names no device runs on the card; the CPU is asked for
    (``device=``, or the command line's ``--platform``)."""
    module, name = entry.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"juliaraytracingsw_tpu_torch.{module}"), name)
    if name == "build_parser":
        for argv in (["rsw"], ["swqg"], ["analyze", "run"], ["twolayer"], ["thomasyamada"],
                     ["twolayer-simulation"], ["single-wave"]):
            assert fn().parse_args(argv).platform == "cuda"
        return
    assert inspect.signature(fn).parameters["device"].default == "cuda"
