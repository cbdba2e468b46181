"""Parity of the port's one-layer SWQG model with the JAX package on the CPU.

One PV spectrum, of a band-limited numpy streamfunction, goes through both
packages' ``models/swqg``. The elementwise PV inversions agree to float32
round-off (rtol 1e-6), each package's own spectrum to 2e-6 of its largest
mode (one transform apart). The
nonlinear term runs 3 inverse and 2 forward transforms through two FFT
libraries (XLA's and PyTorch's): relative 1e-6 of its largest mode, as
``tests/test_torch_core.py`` holds the RSW term; 20 IF-AB3 steps 2e-6.
The energetics reduce 32 x 17 modes in float32 in another order (rtol
1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.core import steppers as jstep  # noqa: E402
from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.coupled.initial_conditions import (  # noqa: E402
    random_band_psih as jpsih)
from juliaraytracingsw_tpu.models import base as jbase  # noqa: E402
from juliaraytracingsw_tpu.models import swqg as jswqg  # noqa: E402
from juliaraytracingsw_tpu_torch.core import steppers as tstep  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled.initial_conditions import (  # noqa: E402
    random_band_psih as tpsih)
from juliaraytracingsw_tpu_torch.models import base as tbase  # noqa: E402
from juliaraytracingsw_tpu_torch.models import swqg as tswqg  # noqa: E402

NX = 32
ENERGETICS = ["kinetic_energy", "potential_energy", "energy", "enstrophy",
              "energy_dissipation", "enstrophy_dissipation"]


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rel_err(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _case(nu=1e-8, nnu=2, f=2.0, Cg=1.0, seed=3):
    """Both packages' grid and model, and one PV spectrum (of a
    band-limited streamfunction) handed to both."""
    jg, tg = jmake_grid(NX), tmake_grid(NX, device="cpu")
    mj = jswqg.make_model(jg, nu=nu, nnu=nnu, f=f, Cg=Cg)
    mt = tswqg.make_model(tg, nu=nu, nnu=nnu, f=f, Cg=Cg)
    qt = tswqg.pv_from_streamfunction(tpsih(tg, np.random.default_rng(seed), amp=0.3),
                                      tg, mt.params)
    return jg, tg, mj, mt, jnp.asarray(_np(qt)), qt


def test_params_and_inversion_match():
    jg, tg, mj, mt, _, qt = _case()
    assert vars(mt.params) == vars(mj.params) and mt.name == mj.name == "swqg"
    np.testing.assert_array_equal(_np(mt.L), _np(mj.L))
    # each package's own streamfunction (one transform apart) and inversion
    psi_t = tpsih(tg, np.random.default_rng(3), amp=0.3)
    qj = jswqg.pv_from_streamfunction(jpsih(jg, np.random.default_rng(3), amp=0.3), jg,
                                      mj.params)
    assert qt.dtype == torch.complex64
    np.testing.assert_allclose(_np(qt), _np(qj), rtol=1e-6, atol=2e-6 * np.abs(_np(qj)).max())
    np.testing.assert_array_equal(
        _np(tswqg.pv_from_streamfunction(psi_t, tg, mt.params)),
        _np(jswqg.pv_from_streamfunction(jnp.asarray(_np(psi_t)), jg, mj.params)))
    back_t = tswqg.streamfunction_from_pv(qt, tg, mt.params)
    back_j = jswqg.streamfunction_from_pv(jnp.asarray(_np(qt)), jg, mj.params)
    np.testing.assert_allclose(_np(back_t), _np(back_j), rtol=1e-6,
                               atol=1e-6 * np.abs(_np(back_j)).max())


def test_calcN_matches():
    _, _, mj, mt, qj, qt = _case()
    out = mt.calcN(qt, 0.0)
    assert out.dtype == torch.complex64 and tuple(out.shape) == (NX, NX // 2 + 1)
    assert _rel_err(out, mj.calcN(qj, 0.0)) < 1e-6


@pytest.mark.parametrize("nnu", [2, 4])
def test_ifab3_steps_match(nnu):
    """20 steps: the forward-Euler bootstrap, then AB3."""
    dt = 1e-2
    _, _, mj, mt, qj, qt = _case(nu=1e-8 if nnu == 2 else 1e-16, nnu=nnu)
    ij, sj = jbase.build_stepper(mj, "IFMAB3", dt)
    it, s_t = tbase.build_stepper(mt, "IFMAB3", dt)
    out_j = jbase.run(sj, qj, jstep.zero_clock(), ij(qj), 20)
    out_t = tbase.run(s_t, qt, tstep.zero_clock(device="cpu"), it(qt), 20)
    assert float(out_t[1].t) == float(out_j[1].t) and out_t[1].step == 20
    assert _rel_err(out_t[0], out_j[0]) < 2e-6
    assert _rel_err(out_t[0], qt) > 1e-3          # the flow evolved


@pytest.mark.parametrize("name", ENERGETICS)
def test_energetics_match(name):
    jg, tg, mj, mt, qj, qt = _case()
    t = getattr(tswqg, name)(qt, tg, mt.params)
    j = getattr(jswqg, name)(qj, jg, mj.params)
    assert t.ndim == 0 and float(j) != 0.0
    np.testing.assert_allclose(float(t), float(j), rtol=1e-5)


def test_float64_model_keeps_double_precision():
    """A float64 grid gives a complex128 state; the step agrees with the
    float32 one to float32 round-off over 5 steps."""
    dt = 1e-2
    results = {}
    for dtype in (torch.float32, torch.float64):
        g = tmake_grid(NX, dtype=dtype, device="cpu")
        m = tswqg.make_model(g, nu=1e-8, nnu=2, f=2.0)
        q = tswqg.pv_from_streamfunction(tpsih(g, np.random.default_rng(3), amp=0.3,
                                               dtype=dtype), g, m.params)
        init, step = tbase.build_stepper(m, "IFMAB3", dt)
        results[dtype] = tbase.run(step, q, tstep.zero_clock(dtype, device="cpu"), init(q), 5)
    q64, clock64, _ = results[torch.float64]
    assert q64.dtype == torch.complex128 and clock64.t.dtype == torch.float64
    assert _rel_err(results[torch.float32][0], q64) < 1e-5
