"""The port's steppers on the CPU, against the JAX package.

- ``_etdrk4_coeffs``: the Kassam-Trefethen contour means, float64 on the
  host in both packages, equal to 1e-12 of each table's largest value
  (the same numpy code: measured bit-equal);
- every stepper name of the registry, 20 steps at 64^2 from one numpy
  state, on a block-L model (RSW, ``(3, 3, nl, nkr)``) and a diagonal-L
  model (Thomas-Yamada, ``(4, nl, nkr)``): ``sol`` within 1e-5 of its
  largest mode (two FFT libraries in float32: measured 1e-7-6e-7);
  ETDRK4 takes a diagonal L only, as in the reference;
- the always-filtered names filter whatever ``use_filter`` says;
- ``apply_L`` on a block and on a diagonal operator of the state's rank;
- an unknown name raises ``ValueError`` naming the registry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.core import steppers as jstep  # noqa: E402
from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.models import base as jbase  # noqa: E402
from juliaraytracingsw_tpu.models import rsw as jrsw  # noqa: E402
from juliaraytracingsw_tpu.models import thomasyamada as jty  # noqa: E402
from juliaraytracingsw_tpu_torch.core import steppers as tstep  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled.initial_conditions import (  # noqa: E402
    band_geo_wave_ic, ty_initial_condition)
from juliaraytracingsw_tpu_torch.models import base as tbase  # noqa: E402
from juliaraytracingsw_tpu_torch.models import rsw as trsw  # noqa: E402
from juliaraytracingsw_tpu_torch.models import thomasyamada as tty  # noqa: E402

NX, DT, NSTEPS = 64, 1e-3, 20
STEP_RTOL = 1e-5
COEFF_RTOL = 1e-12
BLOCK_STEPPERS = ["IFMAB3", "ETDAB3", "IFRK4", "AB3", "FilteredAB3", "RK4", "FilteredRK4"]
DIAGONAL_STEPPERS = BLOCK_STEPPERS + ["ETDRK4", "FilteredETDRK4"]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel_err(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _models(kind):
    """(JAX model, port model, one state as numpy) on a 64^2 grid."""
    jg, tg = jmake_grid(NX), tmake_grid(NX, device="cpu")
    rng = np.random.default_rng(9)
    if kind == "rsw":
        kw = dict(nu=1e-12, nnu=4, f=3.0, Cg=1.0)
        sol = _np(band_geo_wave_ic(tg, rng, ag=0.5, aw=0.1, f=3.0, Cg=1.0))
        return jrsw.make_model(jg, **kw), trsw.make_model(tg, **kw), sol
    sol = _np(ty_initial_condition(tg, rng, (2, 6), (0, 4), 0.1, 0.1, 0.05))
    return jty.make_model(jg), tty.make_model(tg), sol


def test_registry_is_the_reference():
    assert set(tbase.STEPPERS) == set(jbase.STEPPERS)
    assert tbase._ALWAYS_FILTERED == jbase._ALWAYS_FILTERED
    for name, factory in tbase.STEPPERS.items():
        assert factory.__name__ == jbase.STEPPERS[name].__name__, name


def test_unknown_stepper_raises():
    mt = trsw.make_model(tmake_grid(16, device="cpu"))
    with pytest.raises(ValueError, match="unknown stepper 'NoSuchStepper'.*ETDRK4"):
        tbase.build_stepper(mt, "NoSuchStepper")


@pytest.mark.parametrize("dtype", [np.float64, np.complex128, np.float32])
def test_etdrk4_coeffs_match_jax(dtype):
    """A real stiff diagonal (hyperviscosity, down to -1e4 dt) and a complex
    one (advection + hyperviscosity) through both packages' contour means."""
    g = tmake_grid(32, device="cpu")
    K2 = g.Krsq.numpy().astype(np.float64)
    kr = g.kr.numpy().astype(np.float64)[None, :]
    L = -1e-2 * K2 ** 2
    if dtype == np.complex128:
        L = L - 0.7j * kr
    L = np.stack([L, 0.5 * L]).astype(dtype)
    for dt in (1e-3, 5e-2):
        got = tstep._etdrk4_coeffs(L, dt)
        want = jstep._etdrk4_coeffs(L, dt)
        for name, a, b in zip(("E", "E2", "Q", "f1", "f2", "f3"), got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert _rel_err(a, b) <= COEFF_RTOL, (name, dt)


@pytest.mark.parametrize("kind,stepper",
                         [("rsw", s) for s in BLOCK_STEPPERS]
                         + [("ty", s) for s in DIAGONAL_STEPPERS])
def test_stepper_matches_jax(kind, stepper):
    mj, mt, sol = _models(kind)
    ij, sj = jbase.build_stepper(mj, stepper, DT)
    it, s_t = tbase.build_stepper(mt, stepper, DT)
    sol_j, sol_t = jnp.asarray(sol), torch.as_tensor(sol)
    out_j = jbase.run(sj, sol_j, jstep.zero_clock(), ij(sol_j), NSTEPS)
    out_t = tbase.run(s_t, sol_t, tstep.zero_clock(device="cpu"), it(sol_t), NSTEPS)
    assert out_t[1].step == NSTEPS == int(out_j[1].step)
    assert float(out_t[1].t) == float(out_j[1].t)
    assert out_t[0].dtype == torch.complex64
    err = _rel_err(out_t[0], out_j[0])
    assert err < STEP_RTOL, err
    assert type(out_t[2]).__name__ == type(out_j[2]).__name__
    for a, b in zip(out_t[2], out_j[2]):       # the AB3 history, where kept
        assert _rel_err(a, b) < STEP_RTOL


@pytest.mark.parametrize("name,plain", [("FilteredAB3", "AB3"), ("FilteredRK4", "RK4"),
                                        ("FilteredETDRK4", "ETDRK4")])
def test_always_filtered_names(name, plain):
    """``Filtered*`` equals its plain name with ``use_filter=True`` and
    differs from it without: the filter is applied whatever the caller
    asks."""
    _, mt, sol = _models("ty")
    sol = torch.as_tensor(sol)

    def one_step(stepper, use_filter):
        init, step = tbase.build_stepper(mt, stepper, DT, use_filter=use_filter)
        return step(sol, tstep.zero_clock(device="cpu"), init(sol))[0]

    filtered = one_step(name, False)
    assert torch.equal(filtered, one_step(name, True))
    assert torch.equal(filtered, one_step(plain, True))
    assert not torch.equal(filtered, one_step(plain, False))


def test_apply_L_block_and_diagonal():
    """A (3, 3, nl, nkr) block contracts the channel axis; a (4, nl, nkr)
    operator of the state's rank is diagonal."""
    rng = np.random.default_rng(2)

    def c(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    for L, sol in ((c(3, 3, 8, 5), c(3, 8, 5)), (c(4, 8, 5), c(4, 8, 5))):
        got = tstep.apply_L(torch.as_tensor(L), torch.as_tensor(sol))
        want = jstep.apply_L(jnp.asarray(L), jnp.asarray(sol))
        assert got.shape == tuple(want.shape) == sol.shape
        assert _rel_err(got, want) < 1e-6


def test_etdrk4_tables_take_L_precision():
    """float64 L gives double tables (a complex128 state stays complex128);
    float32 L single ones (a complex64 state stays complex64)."""
    g = tmake_grid(16, device="cpu", dtype=torch.float64)
    D = (-1e-3 * g.Krsq ** 2)[None]

    def calcN(sol, t):
        return 0.1 * sol

    for L, sdtype in ((D, torch.complex128), (D.float(), torch.complex64)):
        init, step = tstep.make_etdrk4(L, calcN, 1e-2)
        sol = torch.ones((1, 16, 9), dtype=sdtype)
        out = step(sol, tstep.zero_clock(device="cpu"), init(sol))[0]
        assert out.dtype == sdtype
        # d sol/dt = (L + 0.1) sol: exp((L + 0.1) dt) per mode, to the
        # scheme's and the contour's error (6.5e-10 measured with double
        # tables, float32 rounding with single ones)
        want = torch.exp((L.double() + 0.1) * 1e-2).to(sdtype)
        assert _rel_err(out, want) < (1e-8 if sdtype == torch.complex128 else 1e-6)


@pytest.mark.parametrize("name", ["ETDRK4", "FilteredETDRK4"])
def test_etdrk4_refuses_a_block_operator(name):
    """ETDRK4's phi-functions are formed for a diagonal L: the two-layer
    model's (2, 2, nl, nkr) block L is refused where the stepper is built
    (32^2, q from seed 4, dt 2e-3), as the reference's ``run`` raises for
    the same model; a diagonal L (Thomas-Yamada) still steps."""
    from juliaraytracingsw_tpu.models import twolayerqg as j2l
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import random_band_psih
    from juliaraytracingsw_tpu_torch.models import twolayerqg as t2l

    kw = dict(U=0.3, mu=1e-2, nu=1e-8, nnu=4, f0=3.0, Cg=1.0, drho_rho0=0.2)
    tg = tmake_grid(32, device="cpu")
    mt = t2l.make_model(tg, **kw)
    rng = np.random.default_rng(4)
    q = t2l.pv_from_streamfunction(torch.stack([random_band_psih(tg, rng) for _ in range(2)]),
                                   tg, mt.params)
    with pytest.raises(ValueError, match=r"diagonal linear operator.*\(2, 2\) block"):
        tbase.build_stepper(mt, name, dt=2e-3)
    mj = j2l.make_model(jmake_grid(32), **kw)
    ij, sj = jbase.build_stepper(mj, name, dt=2e-3)
    qj = jnp.asarray(_np(q))
    with pytest.raises(TypeError):
        jbase.run(sj, qj, jstep.zero_clock(), ij(qj), 2)
    _, mty, sol = _models("ty")
    it, st = tbase.build_stepper(mty, name, DT)
    sol = torch.as_tensor(sol)
    assert st(sol, tstep.zero_clock(device="cpu"), it(sol))[0].shape == sol.shape
