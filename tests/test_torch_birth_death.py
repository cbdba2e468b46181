"""Birth/death resampling of the port against the JAX package on the CPU.

- ``rays/prng``: Threefry-2x32 against the published known-answer vectors,
  ``split`` and ``uniform`` bit-equal to ``jax.random`` for several keys
  and sizes (float32; float64 under ``jax_enable_x64``, where a range
  whose width is no power of two may round an ulp of its bound apart: the
  reference fuses the multiply-add);
- ``init_birth_death`` and 5 chained ``weibull_birth_death`` calls at
  4,096 packets against the reference under ``jax.jit`` (as its frame runs
  it): positions, branches, wavenumbers, the dead mask, the key and the
  birth count bit-equal; lifetimes and ages within rtol 1e-6 (the
  reference's float32 ``log`` and ``pow`` against the port's float64 ones
  rounded once: measured 3e-7);
- a 64^2 x 1,024 coupled frame with birth/death against
  ``make_coupled_frame``: packets within 1e-5 as
  ``tests/test_torch_driver.py`` holds them, the population as above;
- ``CoupledDriver(birth_death=True)``: the population telemetry
  (``p/births``, ``p/mean_age``) equal; a checkpoint of a birth/death run
  restores across the packages both ways and the next frame agrees.
"""
import functools

import h5py
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.coupled import driver as jdrv  # noqa: E402
from juliaraytracingsw_tpu.io.checkpoint import (load_checkpoint as jload,  # noqa: E402
                                                 save_checkpoint as jsave)
from juliaraytracingsw_tpu.io.output import SequencedWriter as JWriter  # noqa: E402
from juliaraytracingsw_tpu.models.base import build_stepper as jbuild  # noqa: E402
from juliaraytracingsw_tpu.rays import raytrace as jrt  # noqa: E402
from juliaraytracingsw_tpu.rays import resample as jres  # noqa: E402
from juliaraytracingsw_tpu.rays.packets import Packets as JPackets  # noqa: E402
from juliaraytracingsw_tpu_torch import interop  # noqa: E402
from juliaraytracingsw_tpu_torch.core.steppers import zero_clock as tzero_clock  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled import driver as tdrv  # noqa: E402
from juliaraytracingsw_tpu_torch.io.checkpoint import (load_checkpoint as tload,  # noqa: E402
                                                       save_checkpoint as tsave)
from juliaraytracingsw_tpu_torch.io.output import SequencedWriter as TWriter  # noqa: E402
from juliaraytracingsw_tpu_torch.models.base import build_stepper as tbuild  # noqa: E402
from juliaraytracingsw_tpu_torch.ops import birth_death as tbd  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import prng  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import raytrace as trt  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import resample as tres  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.packets import Packets as TPackets  # noqa: E402
from test_torch_driver import (CG, DT, K0, KCUT, F, _assert_states_match,  # noqa: E402
                               _psih_maker, _setup, jic, jmake_grid, jpk, jrsw, tic,
                               tmake_grid, tpk, trsw)

L = 2 * np.pi
N = 4096
LIFE_RTOL = 1e-6


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# Random123's known-answer vectors for threefry2x32_20: (key, counter, out)
KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
       ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
       ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))]


@pytest.mark.parametrize("key,ctr,out", KAT)
def test_threefry_known_answers(key, ctr, out):
    x0, x1 = prng.threefry2x32(key[0], key[1], torch.tensor([ctr[0]]), torch.tensor([ctr[1]]))
    assert (int(x0), int(x1)) == out


def _keys(seed):
    """The PRNGKey of ``seed`` and a key split off it, in both packages."""
    kj = jax.random.PRNGKey(seed)
    kt = prng.prng_key(seed, device="cpu")
    return [(kj, kt), (jax.random.split(kj, 3)[2], prng.split(kt, 3)[2])]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_prng_matches_jax_random(seed, n):
    np.testing.assert_array_equal(_np(prng.prng_key(seed, device="cpu")),
                                  np.asarray(jax.random.PRNGKey(seed)))
    for kj, kt in _keys(seed):
        np.testing.assert_array_equal(_np(prng.split(kt, n)), np.asarray(jax.random.split(kj, n)))
        for lo, hi in ((0.0, 1.0), (1e-12, 1.0), (-2.0, 3.0)):
            uj = np.asarray(jax.random.uniform(kj, (n,), minval=lo, maxval=hi))
            ut = _np(prng.uniform(kt, n, torch.float32, lo, hi))
            assert ut.dtype == np.float32
            np.testing.assert_array_equal(ut, uj, err_msg=f"[{lo}, {hi})")


@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_prng_float64_matches_jax_random_x64(x64, n):
    for kj, kt in _keys(5):
        np.testing.assert_array_equal(_np(prng.split(kt, n)), np.asarray(jax.random.split(kj, n)))
        uj = np.asarray(jax.random.uniform(kj, (n,), dtype=jnp.float64))
        np.testing.assert_array_equal(_np(prng.uniform(kt, n, torch.float64)), uj)
        for lo, hi in ((1e-12, 1.0), (-2.0, 3.0)):
            uj = np.asarray(jax.random.uniform(kj, (n,), dtype=jnp.float64, minval=lo,
                                               maxval=hi))
            ut = _np(prng.uniform(kt, n, torch.float64, lo, hi))
            # two roundings against one: an ulp of the range's bound
            assert np.abs(ut - uj).max() <= np.spacing(max(abs(lo), abs(hi))), f"[{lo}, {hi})"


def test_uniform_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float32 or float64"):
        prng.uniform(prng.prng_key(0, device="cpu"), 4, torch.float16)


def _assert_population(st, sj, dead_t=None, dead_j=None):
    np.testing.assert_array_equal(_np(st.key), np.asarray(sj.key))
    assert st.key.dtype == torch.uint32
    assert st.births.dtype == torch.int32 and int(st.births) == int(sj.births)
    np.testing.assert_allclose(_np(st.lifetime), np.asarray(sj.lifetime), rtol=LIFE_RTOL)
    np.testing.assert_allclose(_np(st.age), np.asarray(sj.age), rtol=LIFE_RTOL, atol=1e-6)
    if dead_t is not None:
        np.testing.assert_array_equal(_np(dead_t), np.asarray(dead_j))


@pytest.mark.parametrize("stagger", [True, False])
def test_init_birth_death_matches_jax(stagger):
    sj = jres.init_birth_death(jax.random.PRNGKey(3), N, 1.5, 10.0, stagger=stagger)
    st = tres.init_birth_death(prng.prng_key(3, device="cpu"), N, 1.5, 10.0, stagger=stagger)
    _assert_population(st, sj)
    assert st.age.dtype == st.lifetime.dtype == torch.float32
    assert bool((st.age < st.lifetime).all()) and bool((st.lifetime > 0).all())


def _packets(seed=0, n=N):
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(-np.pi, np.pi, n), rng.uniform(-np.pi, np.pi, n),
            rng.normal(size=n), rng.normal(size=n), np.where(rng.uniform(size=n) < 0.5, 1, -1)]
    cols = [c.astype(np.float32) for c in cols]
    return JPackets(*map(jnp.asarray, cols)), TPackets(*map(torch.as_tensor, cols))


@functools.lru_cache(maxsize=None)
def _jitted_bd():
    return jax.jit(jres.weibull_birth_death,
                   static_argnames=("Lx", "Ly", "k0", "k_shape", "lam", "x0", "y0"))


@pytest.mark.parametrize("k_shape", [1.5, 2.0, 1.0])
def test_weibull_birth_death_chain_matches_jax(k_shape):
    """Five chained steps with a dt that kills ~25-40% of the ensemble a
    step; k_shape 2 and 1 take the exponents PyTorch's pow takes apart."""
    pj, pt = _packets()
    sj = jres.init_birth_death(jax.random.PRNGKey(11), N, k_shape, 10.0)
    st = tres.init_birth_death(prng.prng_key(11, device="cpu"), N, k_shape, 10.0)
    consts = dict(Lx=L, Ly=L, k0=5.0, k_shape=k_shape, lam=10.0, x0=-np.pi, y0=-np.pi)
    born = 0
    for _ in range(5):
        pj, sj, dj = _jitted_bd()(pj, sj, 2.5, **consts)
        before = tuple(t.clone() for t in pt)
        pt_new, st, dt_ = tres.weibull_birth_death(pt, st, 2.5, **consts)
        assert all(torch.equal(a, b) for a, b in zip(pt, before))   # inputs untouched
        pt = pt_new
        for name in TPackets._fields:
            np.testing.assert_array_equal(_np(getattr(pt, name)), np.asarray(getattr(pj, name)),
                                          err_msg=name)
        _assert_population(st, sj, dt_, dj)
        born += int(dt_.sum())
    assert int(st.births) == born > N
    assert torch.all(pt.k[dt_] == 5.0) and torch.all(pt.l[dt_] == 0.0)


def test_birth_death_on_the_cpu_runs_the_twin():
    """CPU tensors take the plain version and count no launch."""
    _, pt = _packets(n=64)
    st = tres.init_birth_death(prng.prng_key(0, device="cpu"), 64)
    tbd.reset_launches()
    out = tbd.birth_death(*pt, *st, 3.0, Lx=L, Ly=L, k0=5.0, k_shape=1.5, lam=10.0,
                          x0=-np.pi, y0=-np.pi)
    ref = tbd.birth_death_torch(*pt, *st, 3.0, Lx=L, Ly=L, k0=5.0, k_shape=1.5, lam=10.0,
                                x0=-np.pi, y0=-np.pi)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert tbd.launches["birth_death"] == 0


def test_birth_death_gradient_matches_jax():
    """The gradient of a weighted sum of the outputs: a live packet's
    cotangents pass through (its age's also to dt), a dead one's are 0, as
    ``jax.grad`` of the reference gives them; through ``birth_death``'s
    ``autograd.Function`` (the twin forward, its own backward) and through
    autograd of the twin."""
    pj, pt = _packets(seed=3)
    sj = jres.init_birth_death(jax.random.PRNGKey(5), N)
    st = tres.init_birth_death(prng.prng_key(5, device="cpu"), N)
    consts = dict(Lx=L, Ly=L, k0=5.0, k_shape=1.5, lam=10.0, x0=-np.pi, y0=-np.pi)
    w = np.random.default_rng(6).normal(size=(7, N)).astype(np.float32)

    def jloss(cols, dt):
        p, s, _ = jres.weibull_birth_death(JPackets(*cols[:5]), sj._replace(
            age=cols[5], lifetime=cols[6]), dt, **consts)
        return sum(jnp.sum(o * wi) for o, wi in zip((*p, s.age, s.lifetime), w))

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1)))((*pj, sj.age, sj.lifetime),
                                                   jnp.float32(2.5))
    gj = [*gj[0], gj[1]]
    for fn in (tbd.birth_death, tbd.birth_death_torch):
        ins = [t.clone().requires_grad_() for t in (*pt, st.age, st.lifetime)]
        dt = torch.tensor(2.5, requires_grad=True)
        out = fn(*ins, st.key, st.births, dt, **consts)
        assert 0 < int(out[9].sum()) < N
        loss = sum((o * torch.as_tensor(wi)).sum() for o, wi in zip(out[:7], w))
        gt = torch.autograd.grad(loss, [*ins, dt])
        for i, (a, b) in enumerate(zip(gt[:7], gj[:7])):
            np.testing.assert_array_equal(_np(a), np.asarray(b), err_msg=str(i))
        np.testing.assert_allclose(_np(gt[7]), np.asarray(gj[7]), rtol=1e-5)


def test_birth_death_float64_matches_jax_x64(x64):
    """float64 packets and ensemble: the reference's 64-bit draws."""
    rng = np.random.default_rng(2)
    cols = [rng.uniform(-np.pi, np.pi, N), rng.uniform(-np.pi, np.pi, N), rng.normal(size=N),
            rng.normal(size=N), np.ones(N)]
    pj, pt = JPackets(*map(jnp.asarray, cols)), TPackets(*map(torch.as_tensor, cols))
    sj = jres.init_birth_death(jax.random.PRNGKey(4), N)
    st = tres.init_birth_death(prng.prng_key(4, device="cpu"), N, dtype=torch.float64)
    consts = dict(Lx=L, Ly=L, k0=5.0, k_shape=1.5, lam=10.0, x0=-np.pi, y0=-np.pi)
    for _ in range(3):
        pj, sj, dj = _jitted_bd()(pj, sj, 2.5, **consts)
        pt, st, dt_ = tres.weibull_birth_death(pt, st, 2.5, **consts)
        assert pt.x.dtype == st.lifetime.dtype == torch.float64
        for name in TPackets._fields:
            # float64 positions: the reference's fused multiply-add, the
            # port's two roundings
            np.testing.assert_allclose(_np(getattr(pt, name)), np.asarray(getattr(pj, name)),
                                       rtol=4e-16, atol=4e-16, err_msg=name)
        _assert_population(st, sj, dt_, dj)


def test_driver_birth_death_float64_matches_jax_x64(x64):
    """CoupledDriver on a float64 grid and packets keeps the population in
    float64, as the reference's does under x64, and two frames agree."""
    drivers = []
    for mk_grid, rsw, rt, pk, ic, mod, kw in (
            (jmake_grid, jrsw, jrt, jpk, jic, jdrv, dict(dtype=jnp.float64)),
            (tmake_grid, trsw, trt, tpk, tic, tdrv, dict(dtype=torch.float64, device="cpu"))):
        grid = mk_grid(32, **kw)
        model = rsw.make_model(grid, nu=tdrv.derive_nu(1.0, 32, 4, DT), nnu=4, f=F, Cg=CG)
        rp = rt.RayParams(f=F, Cg=CG, x0=float(grid.x[0]), y0=float(grid.y[0]), dx=grid.dx,
                          dy=grid.dy, gather="patch")
        sol0 = ic(grid, np.random.default_rng(1), Kg=(4, 6), Kw=(0, 3), ag=0.5, aw=0.05, f=F,
                  Cg=CG)
        d = mod.CoupledDriver(model=model, psih_fn=_psih_maker(grid, model.params), rp=rp,
                              dt=DT, k_cutoff=KCUT, k0=K0, log_fn=lambda s: None,
                              birth_death=True, bd_k_shape=1.5, bd_lam=0.01, bd_seed=9)
        d.init(sol0, pk.lattice_packets(8, grid.Lx, grid.Ly, k0=K0, k_ring=True, **kw))
        d.run(n_frames=2, flow_steps_per_frame=2)
        drivers.append(d)
    dj, dt_ = drivers
    assert dt_.sim.bd.age.dtype == dt_.sim.bd.lifetime.dtype == torch.float64
    assert int(dt_.sim.bd.births) > 0
    _assert_population(dt_.sim.bd, dj.sim.bd)
    for name in TPackets._fields:
        np.testing.assert_allclose(_np(getattr(dt_.sim.packets, name)),
                                   np.asarray(getattr(dj.sim.packets, name)), rtol=0,
                                   atol=1e-12, err_msg=name)


BD = dict(k_shape=1.5, lam=0.05)


def _bd_frame_sims(steps=5):
    j, t = _setup(sqrtp=32)
    sims = []
    for d, mod, build, zclock, bd in (
            (j, jdrv, jbuild, jdrv.zero_clock(),
             jres.init_birth_death(jax.random.PRNGKey(2), 1024, **BD)),
            (t, tdrv, tbuild, tzero_clock(device="cpu"),
             tres.init_birth_death(prng.prng_key(2, device="cpu"), 1024, **BD))):
        init, step = build(d["model"], "IFMAB3", DT)
        frame = mod.make_coupled_frame(d["model"], step, d["psih_fn"], d["rp"], steps,
                                       k_cutoff=KCUT, k0=K0, birth_death=BD)
        fields = (jrt if mod is jdrv else trt).fields_from_psih(
            d["psih_fn"](d["sol0"]), d["grid"], "bilinear")
        sims.append(frame(mod.SimState(d["sol0"], zclock, init(d["sol0"]), d["packets"],
                                       fields, bd)))
    return sims


def test_birth_death_coupled_frame_matches_jax():
    """One 5-step coupled frame at 64^2 x 1,024 packets with birth/death."""
    sj, st = _bd_frame_sims()
    _assert_states_match(st, sj)
    _assert_population(st.bd, sj.bd)
    # lifetimes of ~0.05 against the frame's t = 0.01: a third of the
    # ensemble is reborn (345 births in both packages)
    assert int(st.bd.births) > 250


def test_coupled_frame_without_bd_state_raises():
    _, t = _setup(sqrtp=4, nx=16)
    init, step = tbuild(t["model"], "IFMAB3", DT)
    frame = tdrv.make_coupled_frame(t["model"], step, t["psih_fn"], t["rp"], 1,
                                    k_cutoff=KCUT, k0=K0, birth_death=BD)
    fields = trt.fields_from_psih(t["psih_fn"](t["sol0"]), t["grid"], "bilinear")
    with pytest.raises(ValueError, match="SimState.bd"):
        frame(tdrv.SimState(t["sol0"], tzero_clock(device="cpu"), init(t["sol0"]),
                            t["packets"], fields))


def _bd_drivers(tmp_path=None, **kw):
    j, t = _setup(sqrtp=16)
    common = dict(dt=DT, k_cutoff=KCUT, k0=K0, log_fn=lambda s: None, birth_death=True,
                  bd_k_shape=1.5, bd_lam=0.01, bd_seed=9, **kw)
    writers = {}
    if tmp_path is not None:
        writers = {pkg: dict(packet_writer=W(str(tmp_path / pkg / "packets"), 10))
                   for pkg, W in (("jax", JWriter), ("torch", TWriter))}
    dj = jdrv.CoupledDriver(model=j["model"], psih_fn=j["psih_fn"],
                            rp=j["rp"]._replace(gather="patch"), **common,
                            **writers.get("jax", {}))
    dt_ = tdrv.CoupledDriver(model=t["model"], psih_fn=t["psih_fn"],
                             rp=t["rp"]._replace(gather="patch"), **common,
                             **writers.get("torch", {}))
    dj.init(j["sol0"], j["packets"])
    dt_.init(t["sol0"], t["packets"])
    return dj, dt_


def _population_telemetry(path):
    out = {}
    with h5py.File(path, "r") as f:
        for group in ("births", "mean_age"):
            for step in f["p"][group]:
                out[f"{group}/{step}"] = f["p"][group][step][()]
    return out


def test_driver_birth_death_telemetry_matches_jax(tmp_path):
    dj, dt_ = _bd_drivers(tmp_path)
    _assert_population(dt_.sim.bd, dj.sim.bd)
    for d in (dj, dt_):
        d.run(n_frames=3, flow_steps_per_frame=2)
        d.close()
    _assert_states_match(dt_.sim, dj.sim)
    _assert_population(dt_.sim.bd, dj.sim.bd)
    tel_j = _population_telemetry(tmp_path / "jax" / "packets.000000.h5")
    tel_t = _population_telemetry(tmp_path / "torch" / "packets.000000.h5")
    assert sorted(tel_t) == sorted(tel_j) and len(tel_t) == 6
    for key, val in tel_j.items():
        if key.startswith("births"):
            assert int(tel_t[key]) == int(val)
        else:
            np.testing.assert_allclose(tel_t[key], val, rtol=1e-6, err_msg=key)
    assert int(tel_t["births/6"]) == int(dt_.sim.bd.births) > 0


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_birth_death_checkpoint_crosses_packages(tmp_path, direction):
    """A birth/death run checkpointed by one package restores in the other
    (the key as uint32[2], births as int32), and one more frame in both
    agrees."""
    dj, dt_ = _bd_drivers()
    path = str(tmp_path / "bd.npz")
    if direction == "jax_to_port":
        dj.run(n_frames=1, flow_steps_per_frame=3)
        jsave(path, dj.sim)
        dt_.sim = tload(path, dt_.sim)
    else:
        dt_.run(n_frames=1, flow_steps_per_frame=3)
        tsave(path, dt_.sim)
        dj.sim = jload(path, dj.sim)
        # the port's state went the other way exactly
        for key, val in interop.sim_state_to_numpy(dt_.sim).items():
            np.testing.assert_array_equal(interop.sim_state_to_numpy(dj.sim)[key], val,
                                          err_msg=key)
    with np.load(path) as data:
        paths = bytes(data["__treepaths__"]).decode().split("\n")
        key_leaf = data[f"leaf_{paths.index('.bd.key')}"]
    assert paths[-4:] == [".bd.age", ".bd.lifetime", ".bd.key", ".bd.births"]
    assert key_leaf.dtype == np.uint32 and key_leaf.shape == (2,)
    assert dt_.sim.bd.key.dtype == torch.uint32 and dt_.sim.bd.births.dtype == torch.int32
    for d in (dj, dt_):
        d.run(n_frames=1, flow_steps_per_frame=3)
    _assert_states_match(dt_.sim, dj.sim)
    _assert_population(dt_.sim.bd, dj.sim.bd)


def test_interop_carries_the_population():
    dj, dt_ = _bd_drivers()
    dj.run(n_frames=1, flow_steps_per_frame=2)
    d = interop.sim_state_to_numpy(dj.sim)
    assert d["bd.key"].dtype == np.uint32 and d["bd.births"].dtype == np.int32
    dt_.sim = interop.sim_state_from_numpy(d, device="cpu")
    for key, val in interop.sim_state_to_numpy(dt_.sim).items():
        np.testing.assert_array_equal(val, d[key], err_msg=key)
    for drv in (dj, dt_):
        drv.run(n_frames=1, flow_steps_per_frame=2)
    _assert_population(dt_.sim.bd, dj.sim.bd)


def test_driver_birth_death_with_remat_matches_plain():
    """remat recomputes each step in the backward pass: the forward, the
    population included, is unchanged."""
    _, plain = _bd_drivers()
    _, remat = _bd_drivers(remat=True)
    for d in (plain, remat):
        d.run(n_frames=1, flow_steps_per_frame=3)
    for a, b in zip(remat.sim.packets + remat.sim.bd, plain.sim.packets + plain.sim.bd):
        assert torch.equal(a, b)
