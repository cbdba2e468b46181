"""The port's two-layer, n-layer, Thomas-Yamada and RSW-variant models on
the CPU, against the JAX package, in the classes of
``tests/test_models_extended.py``.

One numpy state goes through both packages' functions. Tolerances, each
measured on these inputs first:

- linear operators, bases and the elementwise conversions: built from the
  same float32 grid arrays in float64 and rounded once, bit-equal or within
  float32 rounding (rtol 1e-6);
- nonlinear terms (inverse and forward transforms through XLA's and
  PyTorch's FFTs): 1e-6 of the largest mode, as ``test_torch_core.py``
  holds RSW's (measured 1e-7-3e-7); 1e-5 for the modified and
  quadratic-height variants, whose pressure Cg^2 (3/2 - ...) carries a
  mean of ~Cg^2 into the forward transform, whose rounding then falls on
  a term of ~1/8 its size (measured 3.1e-6);
- 20 IF-AB3 (or ETDRK4) steps: 1e-5 of the largest mode (measured
  2e-7-6e-7);
- energies: rtol 1e-5 (float32 sums of the same modes in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.core import steppers as jstep  # noqa: E402
from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.models import base as jbase  # noqa: E402
from juliaraytracingsw_tpu.models import linborg as jlinborg  # noqa: E402
from juliaraytracingsw_tpu.models import modified_sw as jmodified  # noqa: E402
from juliaraytracingsw_tpu.models import multilayerqg as jml  # noqa: E402
from juliaraytracingsw_tpu.models import quadheight as jquad  # noqa: E402
from juliaraytracingsw_tpu.models import thomasyamada as jty  # noqa: E402
from juliaraytracingsw_tpu.models import twolayerqg as j2l  # noqa: E402
from juliaraytracingsw_tpu_torch.core import steppers as tstep  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled.initial_conditions import (  # noqa: E402
    band_geo_wave_ic, random_band_psih, ty_initial_condition)
from juliaraytracingsw_tpu_torch.models import base as tbase  # noqa: E402
from juliaraytracingsw_tpu_torch.models import linborg as tlinborg  # noqa: E402
from juliaraytracingsw_tpu_torch.models import modified_sw as tmodified  # noqa: E402
from juliaraytracingsw_tpu_torch.models import multilayerqg as tml  # noqa: E402
from juliaraytracingsw_tpu_torch.models import quadheight as tquad  # noqa: E402
from juliaraytracingsw_tpu_torch.models import rsw as trsw  # noqa: E402
from juliaraytracingsw_tpu_torch.models import thomasyamada as tty  # noqa: E402
from juliaraytracingsw_tpu_torch.models import twolayerqg as t2l  # noqa: E402

NX = 32
ELEMENTWISE_RTOL = 1e-6
CALCN_RTOL = 1e-6
STEPS_RTOL = 1e-5
ENERGY_RTOL = 1e-5
PRESSURE_CALCN_RTOL = 1e-5


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel_err(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _grids(nx=NX):
    return jmake_grid(nx), tmake_grid(nx, device="cpu")


def _both(a):
    """A numpy array as (jax array, cpu tensor)."""
    return jnp.asarray(a), torch.as_tensor(np.ascontiguousarray(a))


def _psih(tg, n, seed=4, amp=0.1):
    rng = np.random.default_rng(seed)
    return np.stack([_np(random_band_psih(tg, rng, kband=(2, 8), amp=amp)) for _ in range(n)])


def _steps(mj, mt, sol, stepper="IFMAB3", dt=2e-3, n=20):
    ij, sj = jbase.build_stepper(mj, stepper, dt)
    it, s_t = tbase.build_stepper(mt, stepper, dt)
    sj_, st_ = _both(sol)
    out_j = jbase.run(sj, sj_, jstep.zero_clock(), ij(sj_), n)[0]
    out_t = tbase.run(s_t, st_, tstep.zero_clock(device="cpu"), it(st_), n)[0]
    return out_t, out_j


class TestTwoLayerQG:
    KW = dict(U=0.3, mu=1e-2, nu=1e-8, nnu=4, f0=3.0, Cg=1.0, drho_rho0=0.2)

    def _case(self):
        jg, tg = _grids()
        mj, mt = j2l.make_model(jg, **self.KW), t2l.make_model(tg, **self.KW)
        return jg, tg, mj, mt, _psih(tg, 2)

    def test_params_and_L(self):
        _, _, mj, mt, _ = self._case()
        assert vars(mt.params) == vars(mj.params) and mt.name == mj.name
        assert mt.L.shape == (2, 2, NX, NX // 2 + 1) and mt.L.dtype == torch.complex64
        np.testing.assert_array_equal(_np(mt.L), _np(mj.L))

    def test_pv_psi_conversions(self):
        jg, tg, mj, mt, psih = self._case()
        pj, pt = _both(psih)
        qt = t2l.pv_from_streamfunction(pt, tg, mt.params)
        qj = j2l.pv_from_streamfunction(pj, jg, mj.params)
        assert _rel_err(qt, qj) < ELEMENTWISE_RTOL
        back_t = t2l.streamfunction_from_pv(qt, tg, mt.params)
        back_j = j2l.streamfunction_from_pv(jnp.asarray(_np(qt)), jg, mj.params)
        assert _rel_err(back_t, back_j) < ELEMENTWISE_RTOL
        # the round trip returns psi but for the mean mode
        psih[:, 0, 0] = 0
        assert _rel_err(back_t, psih) < 1e-5

    def test_calcN_steps_and_energies(self):
        jg, tg, mj, mt, psih = self._case()
        q = _np(t2l.pv_from_streamfunction(torch.as_tensor(psih), tg, mt.params))
        qj, qt = _both(q)
        assert _rel_err(mt.calcN(qt, None), mj.calcN(qj, None)) < CALCN_RTOL
        out_t, out_j = _steps(mj, mt, q)
        assert _rel_err(out_t, out_j) < STEPS_RTOL
        for got, want in zip(t2l.kinetic_energy(out_t, tg, mt.params),
                             j2l.kinetic_energy(out_j, jg, mj.params)):
            np.testing.assert_allclose(float(got), float(want), rtol=ENERGY_RTOL)
        np.testing.assert_allclose(float(t2l.potential_energy(out_t, tg, mt.params)),
                                   float(j2l.potential_energy(out_j, jg, mj.params)),
                                   rtol=ENERGY_RTOL)


class TestMultiLayerQG:
    def test_two_layer_equivalence(self):
        """The n-layer model with ``two_layer_defaults`` is the two-layer
        model: the same L and nonlinear term (to float32 rounding)."""
        _, tg = _grids()
        kw = tml.two_layer_defaults(U=0.3, mu=1e-2, nu=1e-8, nnu=4)
        m2 = tml.make_model(tg, **kw)
        ref = t2l.make_model(tg, U=0.3, mu=1e-2, nu=1e-8, nnu=4)
        assert _rel_err(m2.L, ref.L) < ELEMENTWISE_RTOL
        q = t2l.pv_from_streamfunction(torch.as_tensor(_psih(tg, 2)), tg, ref.params)
        assert _rel_err(tml.pv_from_streamfunction(
            t2l.streamfunction_from_pv(q, tg, ref.params), tg, m2.params), q) < 1e-5
        assert _rel_err(m2.calcN(q, None), ref.calcN(q, None)) < 1e-5

    @pytest.mark.parametrize("n", [2, 3])
    def test_against_jax(self, n):
        jg, tg = _grids()
        kw = dict(U=tuple(np.linspace(0.3, -0.3, n)), beta=0.5, mu=1e-2, nu=1e-8, nnu=4,
                  Fcoup=tuple(9.0 for _ in range(n - 1)))
        mj, mt = jml.make_model(jg, **kw), tml.make_model(tg, **kw)
        assert vars(mt.params) == vars(mj.params)
        np.testing.assert_allclose(tml._sinv(tg, mt.params), jml._sinv(jg, mj.params),
                                   rtol=1e-12, atol=0)
        np.testing.assert_array_equal(_np(mt.L), _np(mj.L))
        psih = _psih(tg, n)
        pj, pt = _both(psih)
        qt = tml.pv_from_streamfunction(pt, tg, mt.params)
        qj = jml.pv_from_streamfunction(pj, jg, mj.params)
        assert _rel_err(qt, qj) < ELEMENTWISE_RTOL
        q = _np(qt)
        assert _rel_err(tml.streamfunction_from_pv(qt, tg, mt.params),
                        jml.streamfunction_from_pv(jnp.asarray(q), jg, mj.params)) < 1e-6
        assert _rel_err(mt.extras["psi_from_q"](qt),
                        mj.extras["psi_from_q"](jnp.asarray(q))) < 1e-6
        assert _rel_err(mt.calcN(qt, None), mj.calcN(jnp.asarray(q), None)) < CALCN_RTOL
        out_t, out_j = _steps(mj, mt, q)
        assert _rel_err(out_t, out_j) < STEPS_RTOL
        for fn in ("kinetic_energy", "potential_energy"):
            got = getattr(tml, fn)(out_t, tg, mt.params)
            want = getattr(jml, fn)(out_j, jg, mj.params)
            assert len(got) == len(want) == (n if fn == "kinetic_energy" else n - 1)
            np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want],
                                       rtol=ENERGY_RTOL)


class TestThomasYamada:
    def _case(self, seed=6):
        jg, tg = _grids()
        sol = _np(ty_initial_condition(tg, np.random.default_rng(seed), (2, 6), (0, 4),
                                       0.1, 0.1, 0.05))
        return jg, tg, jty.make_model(jg), tty.make_model(tg), sol

    def test_L_and_bases(self):
        jg, tg, mj, mt, _ = self._case()
        assert vars(mt.params) == vars(mj.params)
        # the port raises K^2 to nnu in float64: float32 rounding apart
        assert mt.L.shape == tuple(mj.L.shape) and mt.L.dtype == torch.float32
        np.testing.assert_allclose(_np(mt.L), _np(mj.L), rtol=1e-6)
        for got, want in zip(tty.ty_bases(tg), jty.ty_bases(jg)):
            np.testing.assert_array_equal(_np(got), want)

    def test_L_finite_where_float32_powers_overflow(self):
        """At 384^2 K^16 exceeds float32 (max K^2 = 36,864 x 2); the port's L
        and its ETDRK4 tables stay finite."""
        mt = tty.make_model(tmake_grid(384, device="cpu"))
        L = _np(mt.L)
        assert np.isfinite(L).all() and L.min() < -1e10
        assert all(np.isfinite(a).all() for a in tstep._etdrk4_coeffs(L[0], 1e-3))

    def test_decomposition_and_energies(self):
        jg, tg, mj, mt, sol = self._case()
        sj, st = _both(sol)
        for got, want in zip(tty.decompose_balanced_wave(st, tg),
                             jty.decompose_balanced_wave(sj, jg)):
            assert _rel_err(got, want) < ELEMENTWISE_RTOL
        Gh, Wh = tty.decompose_balanced_wave(st, tg)
        assert _rel_err(Gh + Wh, st[1:]) < 1e-5     # the basis is complete
        np.testing.assert_allclose(float(tty.barotropic_energy(st, tg)),
                                   float(jty.barotropic_energy(sj, jg)), rtol=ENERGY_RTOL)
        np.testing.assert_allclose([float(e) for e in tty.baroclinic_energy(st, tg)],
                                   [float(e) for e in jty.baroclinic_energy(sj, jg)],
                                   rtol=ENERGY_RTOL)
        got = tty.wave_geostrophic_energy(st, tg)
        want = jty.wave_geostrophic_energy(sj, jg)
        np.testing.assert_allclose([float(e) for pair in got for e in pair],
                                   [float(e) for pair in want for e in pair],
                                   rtol=ENERGY_RTOL)

    def test_calcN_and_etdrk4_steps(self):
        jg, tg, mj, mt, sol = self._case()
        sj, st = _both(sol)
        assert _rel_err(mt.calcN(st, None), mj.calcN(sj, None)) < CALCN_RTOL
        out_t, out_j = _steps(mj, mt, sol, "ETDRK4", dt=5e-3)
        assert _rel_err(out_t, out_j) < STEPS_RTOL


class TestRSWVariants:
    MODELS = {"linborg": (jlinborg, tlinborg), "modified": (jmodified, tmodified),
              "quadheight": (jquad, tquad)}
    KW = dict(nu=1e-12, nnu=4, f=3.0, Cg=1.0)

    def _case(self, name):
        jg, tg = _grids()
        jm, tm = self.MODELS[name]
        sol = band_geo_wave_ic(tg, np.random.default_rng(8), ag=0.5, aw=0.1, f=3.0, Cg=1.0)
        if name == "quadheight":
            sol = tquad.set_solution(sol[0], sol[1], sol[2], tg)
        return jg, tg, jm.make_model(jg, **self.KW), tm.make_model(tg, **self.KW), _np(sol)

    @pytest.mark.parametrize("name", list(MODELS))
    def test_L_calcN_and_steps(self, name):
        jg, tg, mj, mt, sol = self._case(name)
        assert mt.name == mj.name and vars(mt.params) == vars(mj.params)
        np.testing.assert_array_equal(_np(mt.L), _np(mj.L))
        sj, st = _both(sol)
        tol = CALCN_RTOL if name == "linborg" else PRESSURE_CALCN_RTOL
        assert _rel_err(mt.calcN(st, None), mj.calcN(sj, None)) < tol
        out_t, out_j = _steps(mj, mt, sol)
        assert _rel_err(out_t, out_j) < STEPS_RTOL

    def test_linborg_advects_with_the_rotational_flow(self):
        """Linborg's term differs from RSW's where the flow diverges."""
        _, tg, _, mt, sol = self._case("linborg")
        st = torch.as_tensor(sol)
        ref = trsw.make_model(tg, **self.KW).calcN(st, None)
        assert _rel_err(mt.calcN(st, None), ref) > 1e-3
        assert torch.equal(trsw._advection_N(st, tg), ref)

    def test_quadheight_conversions_and_energies(self):
        jg, tg, mj, mt, sol = self._case("quadheight")
        eta = band_geo_wave_ic(tg, np.random.default_rng(8), ag=0.5, aw=0.1, f=3.0, Cg=1.0)
        ej = jnp.asarray(_np(eta))
        assert _rel_err(sol, jquad.set_solution(ej[0], ej[1], ej[2], jg)) < 1e-6
        sj, st = _both(sol)
        for got, want in zip(tquad.updatevars(st, tg), jquad.updatevars(sj, jg)):
            assert _rel_err(got, want) < 1e-5
        np.testing.assert_allclose(float(tquad.kinetic_energy(st, tg)),
                                   float(jquad.kinetic_energy(sj, jg)), rtol=ENERGY_RTOL)
        np.testing.assert_allclose(float(tquad.potential_energy(st, tg, mt.params)),
                                   float(jquad.potential_energy(sj, jg, mj.params)),
                                   rtol=ENERGY_RTOL)
        # m = 1/(1 + eta): the mean of m is near 1 for a small eta
        assert abs(float(tquad.potential_energy(st, tg, mt.params)) - 0.5) < 0.05
