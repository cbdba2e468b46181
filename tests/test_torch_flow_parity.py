"""The flow's remaining pieces and longer parity runs of the port against
the JAX package on the CPU:

- 300 IF-AB3 steps of inviscid RSW at 128^2 (the physics anchor's CI
  configuration: dt 5e-4, amplitude 0.2): ``sol`` within 2e-6 of its
  largest mode (measured 2.7e-7), and the torch twin of
  ``benchmarks/hw_validation/physics_anchors.anchor_energy_drift``: the
  nonlinear energy drifts less than its 2e-3;
- IF-AB3 with ``use_filter=True`` on a non-zero solution, 20 steps;
- ``forcing=`` on ``rsw`` and each variant (``linborg``, ``modified_sw``,
  ``quadheight``): calcN (1e-6, the variants with a pressure 1e-5, as
  ``tests/test_torch_models_qg.py`` holds them) and 5 forced steps;
- ``rsw.set_solution``, ``rays/raytrace.fields_from_velocity_spectra``
  for each interp, ``coupled/initial_conditions.upsample_snapshot``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu.core import steppers as jstep  # noqa: E402
from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.coupled import initial_conditions as jic  # noqa: E402
from juliaraytracingsw_tpu.models import base as jbase  # noqa: E402
from juliaraytracingsw_tpu.models import linborg as jlinborg  # noqa: E402
from juliaraytracingsw_tpu.models import modified_sw as jmodified  # noqa: E402
from juliaraytracingsw_tpu.models import quadheight as jquad  # noqa: E402
from juliaraytracingsw_tpu.models import rsw as jrsw  # noqa: E402
from juliaraytracingsw_tpu.rays import raytrace as jrt  # noqa: E402
from juliaraytracingsw_tpu_torch.core import steppers as tstep  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.core.spectral import irfft2  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled import initial_conditions as tic  # noqa: E402
from juliaraytracingsw_tpu_torch.models import base as tbase  # noqa: E402
from juliaraytracingsw_tpu_torch.models import linborg as tlinborg  # noqa: E402
from juliaraytracingsw_tpu_torch.models import modified_sw as tmodified  # noqa: E402
from juliaraytracingsw_tpu_torch.models import quadheight as tquad  # noqa: E402
from juliaraytracingsw_tpu_torch.models import rsw as trsw  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import raytrace as trt  # noqa: E402

F0, CG = 3.0, 1.0
DRIFT_TOL = 2e-3     # benchmarks/hw_validation/physics_anchors.DRIFT_TOL


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel_err(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _ic(nx, amp=0.5, seed=1):
    """(JAX grid, port grid, the same band IC in each)."""
    jg, tg = jmake_grid(nx), tmake_grid(nx, device="cpu")
    sol_j = jic.band_geo_wave_ic(jg, np.random.default_rng(seed), Kg=(10, 13), Kw=(0, 5),
                                 ag=amp, aw=amp / 10, f=F0, Cg=CG)
    sol_t = torch.as_tensor(np.array(sol_j))
    return jg, tg, sol_j, sol_t


def _run(mod_base, model, stepper, dt, sol, clock, n, use_filter=False):
    init, step = mod_base.build_stepper(model, stepper, dt, use_filter=use_filter)
    return mod_base.run(step, sol, clock, init(sol), n)


@functools.lru_cache(maxsize=None)
def _inviscid_300():
    """The physics anchor's CI run in both packages: (JAX sol, port sol,
    port initial sol, port grid)."""
    jg, tg, sol_j, sol_t = _ic(128, amp=0.2, seed=42)
    mj = jrsw.make_model(jg, nu=0.0, nnu=4, f=F0, Cg=CG)
    mt = trsw.make_model(tg, nu=0.0, nnu=4, f=F0, Cg=CG)
    out_j = _run(jbase, mj, "IFMAB3", 5e-4, sol_j, jstep.zero_clock(), 300)
    out_t = _run(tbase, mt, "IFMAB3", 5e-4, sol_t, tstep.zero_clock(device="cpu"), 300)
    assert out_t[1].step == 300 == int(out_j[1].step)
    return out_j[0], out_t[0], sol_t, tg


def test_ifab3_300_steps_at_128_match_jax():
    sol_j, sol_t, _, _ = _inviscid_300()
    assert _rel_err(sol_t, sol_j) < 2e-6


def _nonlinear_energy(sol, grid, Cg=CG):
    """mean[(1 + eta)(u^2 + v^2)/2 + Cg^2 eta^2/2], the inviscid RSW
    invariant, summed in float64."""
    u, v, eta = irfft2(sol, grid.nx).double()
    return float(((1.0 + eta) * (u * u + v * v) / 2.0 + Cg ** 2 * eta * eta / 2.0).mean())


def test_inviscid_energy_drift_small():
    """The torch twin of ``anchor_energy_drift(nx=128, nsteps=300,
    dt=5e-4)``."""
    _, sol_t, sol0, grid = _inviscid_300()
    e0, e1 = _nonlinear_energy(sol0, grid), _nonlinear_energy(sol_t, grid)
    assert np.isfinite(e1) and abs(e1 - e0) / abs(e0) < DRIFT_TOL


def test_filtered_ifab3_on_a_nonzero_solution_matches_jax():
    jg, tg, sol_j, sol_t = _ic(64)
    mj = jrsw.make_model(jg, nu=0.0, nnu=4, f=F0, Cg=CG)
    mt = trsw.make_model(tg, nu=0.0, nnu=4, f=F0, Cg=CG)
    out_j = _run(jbase, mj, "IFMAB3", 2e-3, sol_j, jstep.zero_clock(), 20, use_filter=True)
    out_t = _run(tbase, mt, "IFMAB3", 2e-3, sol_t, tstep.zero_clock(device="cpu"), 20,
                 use_filter=True)
    assert _rel_err(out_t[0], out_j[0]) < 2e-6
    # the filter acts: the unfiltered run differs at the largest wavenumbers
    plain = _run(tbase, mt, "IFMAB3", 2e-3, sol_t, tstep.zero_clock(device="cpu"), 20)
    assert _rel_err(out_t[0], plain[0]) > 1e-6


VARIANTS = {"rsw": (jrsw, trsw), "linborg": (jlinborg, tlinborg),
            "modified": (jmodified, tmodified), "quadheight": (jquad, tquad)}


def _forcing(shape, seed=6):
    """A band of random spectral forcing, pulsing in time, for each
    package: Fh cos(5 t)."""
    rng = np.random.default_rng(seed)
    Fh = (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(np.complex64) * 0.3
    Fh[..., 8:] = 0.0
    Fj, Ft = jnp.asarray(Fh), torch.as_tensor(Fh)
    return (lambda sol, t: Fj * jnp.cos(5.0 * t)), (lambda sol, t: Ft * torch.cos(5.0 * t))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_forcing_matches_jax(name):
    """``make_model(forcing=)``: calcN gains the forcing, and 5 forced
    IF-AB3 steps agree with the JAX package's."""
    jmod, tmod = VARIANTS[name]
    jg, tg, sol_j, sol_t = _ic(32)
    if name == "quadheight":
        sol_j = jmod.set_solution(sol_j[0], sol_j[1], sol_j[2], jg)
        sol_t = torch.as_tensor(np.array(sol_j))
    fj, ft = _forcing(tuple(sol_t.shape))
    mj = jmod.make_model(jg, nu=1e-8, nnu=4, f=F0, Cg=CG, forcing=fj)
    mt = tmod.make_model(tg, nu=1e-8, nnu=4, f=F0, Cg=CG, forcing=ft)
    plain = tmod.make_model(tg, nu=1e-8, nnu=4, f=F0, Cg=CG)
    t = torch.tensor(0.3)
    assert torch.allclose(mt.calcN(sol_t, t) - plain.calcN(sol_t, t), ft(sol_t, t), atol=1e-5)
    # as tests/test_torch_models_qg.py holds calcN: the variants' pressure
    # carries a mean of ~Cg^2 into the forward transform (measured 3e-6)
    tol = 1e-6 if name in ("rsw", "linborg") else 1e-5
    assert _rel_err(mt.calcN(sol_t, t), mj.calcN(sol_j, jnp.float32(0.3))) < tol
    out_j = _run(jbase, mj, "IFMAB3", 2e-3, sol_j, jstep.zero_clock(), 5)
    out_t = _run(tbase, mt, "IFMAB3", 2e-3, sol_t, tstep.zero_clock(device="cpu"), 5)
    assert _rel_err(out_t[0], out_j[0]) < 2e-6


def test_rsw_set_solution():
    _, _, _, sol = _ic(16)
    assert torch.equal(trsw.set_solution(sol[0], sol[1], sol[2]), sol)
    np.testing.assert_array_equal(_np(trsw.set_solution(*sol)),
                                  np.asarray(jrsw.set_solution(*map(jnp.asarray, _np(sol)))))


@pytest.mark.parametrize("interp", ["bilinear", "bspline", "bicubic"])
def test_fields_from_velocity_spectra_matches_jax(interp):
    jg, tg, sol_j, sol_t = _ic(32)
    got = trt.fields_from_velocity_spectra(sol_t[0], sol_t[1], tg, interp)
    ref = jrt.fields_from_velocity_spectra(sol_j[0], sol_j[1], jg, interp)
    assert got.shape == (5, 32, 32) and _rel_err(got, ref) < 2e-6


def test_upsample_snapshot_matches_jax():
    jg, tg, sol_j, sol_t = _ic(32)
    jbig, tbig = jmake_grid(64), tmake_grid(64, device="cpu")
    got = tic.upsample_snapshot(sol_t, tbig)
    np.testing.assert_array_equal(_np(got), np.asarray(jic.upsample_snapshot(sol_j, jbig)))
    assert got.shape == (3, 64, 33) and got.device.type == "cpu"
    # the finer grid carries the same physical field
    coarse, fine = irfft2(sol_t, 32), irfft2(got, 64)
    assert torch.allclose(fine[:, ::2, ::2], coarse, atol=1e-5 * float(coarse.abs().max()))
