"""Parity of the PyTorch port's coupled driver with the JAX package on the
CPU: one coupled frame (fixed-step and adaptive), the ``CoupledDriver``
lifecycle, and a state that JAX produced carried across by ``interop``.

The configuration is the hero's (``bench.py``) cut to 64^2 and 1,024
packets. Tolerances: the flow state agrees to 2e-6 of its largest mode
(two FFT libraries, measured 2e-7); packets agree to 1e-5 absolute with
float32 tables (the JAX package sums the substep's terms in another order
on the CPU; measured 1e-6). With bfloat16 tables both packages round the
same float32 fields to nearest even, but a 1-ulp difference in a field
from the FFTs can flip one stored value by a bfloat16 ulp. A flipped
gradient tap of size |grad u| ~ 6 moves k by up to h * 2^-8 * 6 * |k|
= 2e-3 * 0.023 * 5.2 = 2.4e-4 per flow step; 5e-4 allows two such flips
(measured 7.3e-5 in k, 2.4e-7 in x).

The adaptive frames take the hero's ray options. With loop 'while' the
port runs the fused attempt's formulation (patch-local error scaling),
which the JAX package runs on the CPU only with ``JRSW_FUSED=jnp``, so
that frame sets it; the driver test takes the default loop 'scan', the
per-stage formulation in both.
"""
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.core.steppers import zero_clock as jzero_clock  # noqa: E402
from juliaraytracingsw_tpu.coupled import driver as jdrv  # noqa: E402
from juliaraytracingsw_tpu.coupled.initial_conditions import (  # noqa: E402
    band_geo_wave_ic as jic)
from juliaraytracingsw_tpu.models import rsw as jrsw  # noqa: E402
from juliaraytracingsw_tpu.models.base import build_stepper as jbuild  # noqa: E402
from juliaraytracingsw_tpu.rays import packets as jpk  # noqa: E402
from juliaraytracingsw_tpu.rays import raytrace as jrt  # noqa: E402
from juliaraytracingsw_tpu_torch import interop  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.core.steppers import zero_clock as tzero_clock  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled import driver as tdrv  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled.initial_conditions import (  # noqa: E402
    band_geo_wave_ic as tic)
from juliaraytracingsw_tpu_torch.models import rsw as trsw  # noqa: E402
from juliaraytracingsw_tpu_torch.models.base import build_stepper as tbuild  # noqa: E402
from juliaraytracingsw_tpu_torch.ops import ray_step as tops  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import packets as tpk  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import raytrace as trt  # noqa: E402

F, CG, DT = 3.0, 1.0, 2e-3
K0 = float(np.sqrt(3.0) * F / CG)
KCUT = 100.0 * F / CG
NX = 64
PACKET_ATOL = {"float32": 1e-5, "bfloat16": 5e-4}


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _psih_maker(grid, params):
    def psih_fn(sol):
        qh = grid.ik * sol[1] - grid.il * sol[0] - params.f * sol[2]
        return -qh / (grid.Krsq + params.f ** 2 / params.Cg2)
    return psih_fn


def _setup(table_dtype="float32", interp="bilinear", nx=NX, sqrtp=32):
    """(JAX, port) dicts of grid, model, psih_fn, rp, sol0 and packets."""
    out = []
    for mk_grid, mod_rsw, mod_rt, mod_pk, ic, kw in (
            (jmake_grid, jrsw, jrt, jpk, jic, {}),
            (tmake_grid, trsw, trt, tpk, tic, {"device": "cpu"})):
        grid = mk_grid(nx, **kw)
        model = mod_rsw.make_model(grid, nu=tdrv.derive_nu(1.0, nx, 4, DT),
                                   nnu=4, f=F, Cg=CG)
        rp = mod_rt.RayParams(f=F, Cg=CG, x0=float(grid.x[0]), y0=float(grid.y[0]),
                              dx=grid.dx, dy=grid.dy, interp=interp,
                              table_dtype=table_dtype)
        sol0 = ic(grid, np.random.default_rng(1), Kg=(10, 13), Kw=(0, 5),
                  ag=0.5, aw=0.05, f=F, Cg=CG)
        packets = mod_pk.lattice_packets(sqrtp, grid.Lx, grid.Ly, k0=K0,
                                         k_ring=True, **kw)
        out.append(dict(grid=grid, model=model, rp=rp, sol0=sol0,
                        packets=packets, psih_fn=_psih_maker(grid, model.params)))
    return out


def _rel_err(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _assert_states_match(st, sj, table_dtype="float32"):
    assert st.clock.step == int(sj.clock.step)
    assert float(st.clock.t) == float(sj.clock.t)
    assert _rel_err(st.sol, sj.sol) < 2e-6
    assert _rel_err(st.fields, sj.fields) < 2e-6
    for name in ("x", "y", "k", "l", "sign"):
        np.testing.assert_allclose(_np(getattr(st.packets, name)),
                                   _np(getattr(sj.packets, name)),
                                   rtol=0, atol=PACKET_ATOL[table_dtype],
                                   err_msg=name)


def test_derive_dt_nu():
    assert tdrv.derive_dt(0.3, 1.5, 0.01) == jdrv.derive_dt(0.3, 1.5, 0.01)
    assert tdrv.derive_nu(1.0, 512, 4, 1e-3) == jdrv.derive_nu(1.0, 512, 4, 1e-3)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_coupled_frame_matches_jax(table_dtype):
    """One 5-step coupled frame at 64^2 x 1,024 packets."""
    j, t = _setup(table_dtype)
    sims = []
    for d, mod, build, zclock in ((j, jdrv, jbuild, jzero_clock()),
                                  (t, tdrv, tbuild, tzero_clock(device="cpu"))):
        init, step = build(d["model"], "IFMAB3", DT)
        frame = mod.make_coupled_frame(d["model"], step, d["psih_fn"], d["rp"], 5,
                                       k_cutoff=KCUT, k0=K0)
        fields = (jrt if mod is jdrv else trt).fields_from_psih(
            d["psih_fn"](d["sol0"]), d["grid"], "bilinear")
        sim = mod.SimState(d["sol0"], zclock, init(d["sol0"]), d["packets"], fields)
        sims.append(frame(sim))
    sj, st = sims
    assert st.sol.dtype == torch.complex64 and st.packets.x.dtype == torch.float32
    _assert_states_match(st, sj, table_dtype)
    moved = np.abs(_np(st.packets.x) - _np(t["packets"].x)).max()
    assert moved > 1e-3


HERO_ADAPTIVE = dict(rtol=1e-3, atol=1e-6, max_steps=16, init_substeps=1, loop="while")


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_adaptive_coupled_frame_matches_jax(table_dtype):
    """One 5-step adaptive DP5(4) frame at 64^2 x 1,024 packets."""
    j, t = _setup(table_dtype)
    sims, infos = [], []
    os.environ["JRSW_FUSED"] = "jnp"
    try:
        jax.clear_caches()
        for d, mod, build, zclock in ((j, jdrv, jbuild, jzero_clock()),
                                      (t, tdrv, tbuild, tzero_clock(device="cpu"))):
            init, step = build(d["model"], "IFMAB3", DT)
            # the port hands each flow step's info to ray_info_fn
            sink = dict(ray_info_fn=infos.append) if mod is tdrv else {}
            frame = mod.make_coupled_frame(d["model"], step, d["psih_fn"], d["rp"], 5,
                                           ray_method="adaptive", ray_opts=HERO_ADAPTIVE,
                                           k_cutoff=KCUT, k0=K0, **sink)
            fields = (jrt if mod is jdrv else trt).fields_from_psih(
                d["psih_fn"](d["sol0"]), d["grid"], "bilinear")
            sims.append(frame(mod.SimState(d["sol0"], zclock, init(d["sol0"]),
                                           d["packets"], fields)))
    finally:
        del os.environ["JRSW_FUSED"]
        jax.clear_caches()
    sj, st = sims
    _assert_states_match(st, sj, table_dtype)
    # one accepted attempt per flow step, as on the hero
    assert [(int(i["n_accepted"]), int(i["n_rejected"])) for i in infos] == [(1, 0)] * 5
    assert np.abs(_np(st.packets.x) - _np(t["packets"].x)).max() > 1e-3


def test_frozen_flow_frame_matches_jax():
    j, t = _setup()
    out = []
    for d, mod, build, zclock in ((j, jdrv, jbuild, jzero_clock()),
                                  (t, tdrv, tbuild, tzero_clock(device="cpu"))):
        init, step = build(d["model"], "IFMAB3", DT)
        frame = mod.make_coupled_frame(d["model"], step, d["psih_fn"], d["rp"], 3,
                                       frozen_flow=True, dt=DT)
        fields = (jrt if mod is jdrv else trt).fields_from_psih(
            d["psih_fn"](d["sol0"]), d["grid"], "bilinear")
        out.append(frame(mod.SimState(d["sol0"], zclock, init(d["sol0"]),
                                      d["packets"], fields)))
    sj, st = out
    assert torch.equal(st.sol, t["sol0"])
    _assert_states_match(st, sj)


def _drivers(table_dtype="float32", rp_gather="patch", **kw):
    j, t = _setup(table_dtype, sqrtp=16)
    common = dict(dt=DT, k_cutoff=KCUT, k0=K0, log_fn=lambda s: None, **kw)
    dj = jdrv.CoupledDriver(model=j["model"], psih_fn=j["psih_fn"],
                            rp=j["rp"]._replace(gather=rp_gather), **common)
    dt_ = tdrv.CoupledDriver(model=t["model"], psih_fn=t["psih_fn"],
                             rp=t["rp"]._replace(gather=rp_gather), **common)
    dj.init(j["sol0"], j["packets"])
    dt_.init(t["sol0"], t["packets"])
    return dj, dt_


def test_driver_init_spinup_run_matches_jax():
    dj, dt_ = _drivers()
    launches = dict(tops.launches)
    _assert_states_match(dt_.sim, dj.sim)
    for d in (dj, dt_):
        d.spinup(12, chunk=5)
    _assert_states_match(dt_.sim, dj.sim)
    assert dt_.sim.clock.step == 12
    for d in (dj, dt_):
        d.run(n_frames=2, flow_steps_per_frame=3)
    _assert_states_match(dt_.sim, dj.sim)
    assert dt_.sim.clock.step == 18
    assert tops.launches == launches      # CPU tensors run the twin


@pytest.mark.parametrize("ray_method", ["adaptive", "adaptive7", "dopri5"])
def test_driver_ray_methods_match_jax(ray_method):
    """init/spinup/run with the adaptive DP5(4), Fehlberg 7(8) and
    fixed-step DP5 rays (default ray options)."""
    dj, dt_ = _drivers(ray_method=ray_method)
    for d in (dj, dt_):
        d.spinup(4)
        d.run(n_frames=2, flow_steps_per_frame=2)
    _assert_states_match(dt_.sim, dj.sim)
    assert dt_.sim.clock.step == 8
    # the last run's adaptive integrations, one per flow step
    assert len(dt_.ray_infos) == (0 if ray_method == "dopri5" else 4)
    assert all(float(i["t_reached"]) > 0 for i in dt_.ray_infos)


def test_driver_taps_frame_matches_jax():
    """The frame's taps branch: fixed-step RK4 through the field stacks."""
    dj, dt_ = _drivers(rp_gather="taps")
    for d in (dj, dt_):
        d.run(n_frames=1, flow_steps_per_frame=3)
    _assert_states_match(dt_.sim, dj.sim)


def test_interop_carries_jax_state_across():
    """A state that the JAX driver produced goes on in the port: one more
    frame in both must agree."""
    dj, dt_ = _drivers()
    dj.spinup(5)
    dj.run(n_frames=1, flow_steps_per_frame=3)
    d = interop.sim_state_to_numpy(dj.sim)
    assert set(d) >= {"sol", "clock.t", "clock.step", "stepper_state.N1",
                      "stepper_state.N2", "fields", "packets.x", "packets.sign"}
    dt_.sim = interop.sim_state_from_numpy(d, device="cpu")
    assert dt_.sim.clock.step == 8 and dt_.sim.clock.t.dtype == torch.float32
    # the round trip is exact
    for key, val in interop.sim_state_to_numpy(dt_.sim).items():
        np.testing.assert_array_equal(val, d[key], err_msg=key)
    for drv in (dj, dt_):
        drv.run(n_frames=1, flow_steps_per_frame=3)
    _assert_states_match(dt_.sim, dj.sim)


@pytest.mark.parametrize("option,item", [
    (dict(ray_method="midpoint"), "item 15"),
    (dict(remat=True), "item 14"),
    (dict(birth_death=True), "item 16"),
    (dict(packet_writer=object()), "item 21"),
    (dict(diagnostics={"E": trsw.total_energy}), "item 11"),
])
def test_driver_unported_options_raise(option, item):
    _, t = _setup(sqrtp=2, nx=16)
    with pytest.raises(NotImplementedError, match=item):
        tdrv.CoupledDriver(model=t["model"], psih_fn=t["psih_fn"], rp=t["rp"],
                           dt=DT, **option)


def test_driver_taps_gather_raises():
    """'patch' and 'taps' are ported; 'auto', whose crossover was measured
    on a TPU, is not."""
    _, t = _setup(sqrtp=2, nx=16)
    with pytest.raises(NotImplementedError, match="item 13"):
        tdrv.CoupledDriver(model=t["model"], psih_fn=t["psih_fn"],
                           rp=t["rp"]._replace(gather="auto"), dt=DT)


def test_driver_nan_guard():
    _, t = _setup(sqrtp=2, nx=16)
    drv = tdrv.CoupledDriver(model=t["model"], psih_fn=t["psih_fn"], rp=t["rp"],
                             dt=DT, log_fn=lambda s: None)
    sol = t["sol0"].clone()
    sol[0, 1, 1] = float("nan")
    drv.init(sol, t["packets"])
    with pytest.raises(FloatingPointError, match="spinup"):
        drv.spinup(1)
