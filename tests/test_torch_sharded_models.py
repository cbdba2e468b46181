"""The port's slab-sharded two-layer, SWQG, Thomas-Yamada, n-layer and RSW
variant models on 2 gloo ranks, against the JAX package's sharded models
on a mesh of 2 virtual CPU devices and against the port's replicated
models (the port's counterpart of ``tests/test_sharded_models.py``).

One job of 2 spawned ranks runs every case of this file
(``tests/torch_parallel_worker.py``); each test holds the gathered result
of its case. The inputs are the JAX tests' (64^2, dt 1e-3, the same
numpy-seeded initial conditions). Tolerances are the JAX tests': states
and fields to atol 2e-5 of their largest value and rtol 2e-4 (two FFT
pipelines in float32), packets to rtol 5e-4 and atol 5e-5, the taps
frame against the patch frame to rtol 5e-5 and atol 5e-6; the pad
columns of a state stay exactly zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.core.spectral import rfft2 as jrfft2  # noqa: E402
from juliaraytracingsw_tpu.core.steppers import zero_clock as jzero_clock  # noqa: E402
from juliaraytracingsw_tpu.coupled.driver import derive_nu  # noqa: E402
from juliaraytracingsw_tpu.coupled.initial_conditions import band_geo_wave_ic  # noqa: E402
from juliaraytracingsw_tpu.models import linborg as jlinborg  # noqa: E402
from juliaraytracingsw_tpu.models import modified_sw as jmodified  # noqa: E402
from juliaraytracingsw_tpu.models import multilayerqg as jmlqg  # noqa: E402
from juliaraytracingsw_tpu.models import quadheight as jquadheight  # noqa: E402
from juliaraytracingsw_tpu.models import swqg as jswqg  # noqa: E402
from juliaraytracingsw_tpu.models import thomasyamada as jty  # noqa: E402
from juliaraytracingsw_tpu.models import twolayerqg as jtlqg  # noqa: E402
from juliaraytracingsw_tpu.parallel import sharded as jsharded  # noqa: E402
from juliaraytracingsw_tpu.parallel import sharded_rsw as jsharded_rsw  # noqa: E402
from juliaraytracingsw_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from juliaraytracingsw_tpu.parallel.mesh import shard_packets as jshard_packets  # noqa: E402
from juliaraytracingsw_tpu.rays.packets import lattice_packets as jlattice  # noqa: E402
from juliaraytracingsw_tpu.rays.raytrace import RayParams as JRayParams  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.core.steppers import zero_clock  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled.driver import (SimState,  # noqa: E402
                                                        make_coupled_frame)
from juliaraytracingsw_tpu_torch.models import linborg, modified_sw, multilayerqg  # noqa: E402
from juliaraytracingsw_tpu_torch.models import quadheight, swqg, thomasyamada  # noqa: E402
from juliaraytracingsw_tpu_torch.models import twolayerqg  # noqa: E402
from juliaraytracingsw_tpu_torch.models.base import build_stepper  # noqa: E402
from juliaraytracingsw_tpu_torch.core.spectral import irfft2, rfft2  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.packets import Packets  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.raytrace import (RayParams,  # noqa: E402
                                                       fields_from_psih)
from torch_parallel_worker import Ranks  # noqa: E402

NX, DT, F0, CG = 64, 1e-3, 3.0, 1.0
NU = derive_nu(1.0, NX, 4, DT)
K0 = float(np.sqrt(3.0) * F0 / CG)
K_CUTOFF = 100.0 * F0 / CG
CASES = ["twolayer_step", "twolayer_fields", "twolayer_baroclinic_fields", "twolayer_frame",
         "twolayer_overlap", "swqg_step", "swqg_fields", "swqg_frame", "ty_step", "ty_fields",
         "multilayer_step", "multilayer_fields", "linborg_step", "modified_step",
         "quadheight_step", "quadheight_fields", "swqg_taps", "swqg_bicubic_fields"]


def _band_ic(grid, rng, nfields, amp):
    """The JAX tests' random band-limited spectral IC."""
    phys = rng.standard_normal((nfields, grid.ny, grid.nx)).astype(np.float32)
    sol = jrfft2(jnp.asarray(phys)) * jnp.exp(-(grid.Krsq / 8.0 ** 2)) * grid.dealias_mask
    return np.asarray((sol * (amp / (jnp.abs(sol).max() + 1e-30))).astype(jnp.complex64))


def _inputs():
    g = jmake_grid(NX)
    variant = np.asarray(band_geo_wave_ic(g, np.random.default_rng(23), Kg=(4, 7), Kw=(0, 3),
                                          ag=0.2, aw=0.02, f=F0, Cg=CG))
    quad = np.asarray(jquadheight.set_solution(variant[0], variant[1], variant[2], g))
    packets = jlattice(8, g.Lx, g.Ly, k0=K0, k_ring=True)
    d = {"nx": NX, "dt": DT, "nu": NU,
         "sol.twolayer": _band_ic(g, np.random.default_rng(7), 2, 0.5),
         "sol.swqg": _band_ic(g, np.random.default_rng(11), 1, 0.5)[0],
         "sol.ty": _band_ic(g, np.random.default_rng(13), 4, 0.3),
         "sol.multilayer": _band_ic(g, np.random.default_rng(17), 3, 0.4),
         "sol.linborg": variant, "sol.modified": variant, "sol.quadheight": quad}
    for n in ("x", "y", "k", "l", "sign"):
        d[f"packets.{n}"] = np.asarray(getattr(packets, n))
    return d


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = _inputs()
    job = Ranks.start(2, CASES, inputs, str(tmp_path_factory.mktemp("sharded_models")))
    yield job, inputs
    job.close()


# --- the two packages' models of each kind --------------------------------------

def _jax_model(kind):
    g = jmake_grid(NX)
    if kind == "twolayer":
        return g, jtlqg.make_model(g, U=0.2, mu=1e-2, nu=NU, nnu=4, f0=F0, Cg=CG,
                                   drho_rho0=0.2), jsharded.ShardedTwoLayerQG
    if kind == "swqg":
        return g, jswqg.make_model(g, nu=NU, nnu=4, f=F0, Cg=CG), jsharded.ShardedSWQG
    if kind == "ty":
        return g, jty.make_model(g, nu=1e-18, nnu=4, Ro=0.2), jsharded.ShardedThomasYamada
    if kind == "multilayer":
        return g, jmlqg.make_model(g, U=(0.2, 0.0, -0.2), beta=0.5, mu=1e-2, nu=NU, nnu=4,
                                   Fcoup=(4.0, 4.0)), jsharded.ShardedMultiLayerQG
    module = {"linborg": jlinborg, "modified": jmodified, "quadheight": jquadheight}[kind]
    cls = {"linborg": jsharded_rsw.ShardedLinborg, "modified": jsharded_rsw.ShardedModifiedSW,
           "quadheight": jsharded_rsw.ShardedQuadHeight}[kind]
    return g, module.make_model(g, nu=NU, nnu=4, f=F0, Cg=CG), cls


def _torch_model(kind):
    g = make_grid(NX, device="cpu")
    if kind == "twolayer":
        return g, twolayerqg.make_model(g, U=0.2, mu=1e-2, nu=NU, nnu=4, f0=F0, Cg=CG,
                                        drho_rho0=0.2)
    if kind == "swqg":
        return g, swqg.make_model(g, nu=NU, nnu=4, f=F0, Cg=CG)
    if kind == "ty":
        return g, thomasyamada.make_model(g, nu=1e-18, nnu=4, Ro=0.2)
    if kind == "multilayer":
        return g, multilayerqg.make_model(g, U=(0.2, 0.0, -0.2), beta=0.5, mu=1e-2, nu=NU,
                                          nnu=4, Fcoup=(4.0, 4.0))
    module = {"linborg": linborg, "modified": modified_sw, "quadheight": quadheight}[kind]
    return g, module.make_model(g, nu=NU, nnu=4, f=F0, Cg=CG)


def _torch_psih(kind, g, model, sol, advect="barotropic"):
    """The port's replicated advecting streamfunction of each kind."""
    if kind == "twolayer":
        p = twolayerqg.streamfunction_from_pv(sol, g, model.params)
        return 0.5 * (p[0] + (p[1] if advect == "barotropic" else -p[1]))
    if kind == "swqg":
        return swqg.streamfunction_from_pv(sol, g, model.params)
    if kind == "ty":
        return -sol[0] * g.invKrsq
    if kind == "multilayer":
        w = torch.as_tensor(np.asarray(model.params.delta, np.float32))[:, None, None]
        return (w * model.extras["psi_from_q"](sol)).sum(0)
    eta = sol[2]
    if kind == "quadheight":
        eta = rfft2(1.0 / irfft2(sol[2], g.nx) - 1.0)
    qh = g.ik * sol[1] - g.il * sol[0] - F0 * eta
    return -qh / (g.Krsq + F0 ** 2 / CG ** 2)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5 * np.abs(want).max(),
                               rtol=2e-4)


def _close_packets(got: dict, want, rtol=5e-4, atol=5e-5, prefix=""):
    for n in "xykl":
        np.testing.assert_allclose(got[f"{prefix}{n}"], np.asarray(getattr(want, n)),
                                   rtol=rtol, atol=atol, err_msg=n)


def _check_steps(ranks, kind, nsteps=10):
    job, inputs = ranks
    sol0 = inputs[f"sol.{kind}"]
    jg, jmodel, jcls = _jax_model(kind)
    jsh = jcls(jg, jmodel.params, jmake_mesh(2), dt=DT)
    init_s, step_s = jsh.stepper()
    s = jsh.shard_solution(jnp.asarray(sol0))
    c, st = jzero_clock(), init_s(s)
    for _ in range(nsteps):
        s, c, st = step_s(s, c, st)
    want_jax = jsh.unshard(s)
    g, model = _torch_model(kind)
    init_r, step_r = build_stepper(model, "IFMAB3", dt=DT)
    sol = torch.as_tensor(np.array(sol0))
    clock, state = zero_clock(device="cpu"), init_r(sol)
    for _ in range(nsteps):
        sol, clock, state = step_r(sol, clock, state)
    got = job.result(f"{kind}_step")
    assert got["sol"].shape == want_jax.shape == tuple(sol.shape)
    _close(got["sol"], want_jax)
    _close(got["sol"], sol.numpy())
    assert got["pad"].size == 0 or np.abs(got["pad"]).max() == 0.0
    assert int(got["step"]) == nsteps
    return got


def _check_fields(ranks, kind, advect="barotropic"):
    job, inputs = ranks
    sol0 = inputs[f"sol.{kind}"]
    jg, jmodel, jcls = _jax_model(kind)
    kw = {"advect": advect} if kind == "twolayer" else {}
    jsh = jcls(jg, jmodel.params, jmake_mesh(2), dt=DT, **kw)
    want_jax = np.asarray(jsh.fields(jsh.shard_solution(jnp.asarray(sol0))))
    g, model = _torch_model(kind)
    want = fields_from_psih(_torch_psih(kind, g, model, torch.as_tensor(np.array(sol0)), advect),
                            g)
    name = f"{kind}_baroclinic_fields" if advect == "baroclinic" else f"{kind}_fields"
    got = job.result(name)["fields"]
    _close(got, want_jax)
    _close(got, want.numpy())


def _rps(g):
    return (JRayParams(f=F0, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]), dx=g.dx, dy=g.dy),
            RayParams(f=F0, Cg=CG, x0=float(g.x[0]), y0=float(g.y[0]), dx=g.dx, dy=g.dy))


def _check_frame(ranks, kind):
    job, inputs = ranks
    sol0 = inputs[f"sol.{kind}"]
    jg, jmodel, jcls = _jax_model(kind)
    mesh = jmake_mesh(2)
    jsh = jcls(jg, jmodel.params, mesh, dt=DT)
    jrp, rp = _rps(jg)
    jpk = jlattice(8, jg.Lx, jg.Ly, k0=K0, k_ring=True)
    init_s, _ = jsh.stepper()
    s = jsh.shard_solution(jnp.asarray(sol0))
    js, jc, _, jp = jsh.make_coupled_frame(jrp, 5, k_cutoff=K_CUTOFF, k0=K0)(
        s, jzero_clock(), init_s(s), jshard_packets(jpk, mesh))
    g, model = _torch_model(kind)
    init_r, step_r = build_stepper(model, "IFMAB3", dt=DT)

    def psih_fn(sol):
        return _torch_psih(kind, g, model, sol)

    sol = torch.as_tensor(np.array(sol0))
    packets = Packets(*(torch.as_tensor(np.array(inputs[f"packets.{n}"]))
                        for n in ("x", "y", "k", "l", "sign")))
    rep = make_coupled_frame(model, step_r, psih_fn, rp, 5, k_cutoff=K_CUTOFF, k0=K0)(
        SimState(sol, zero_clock(device="cpu"), init_r(sol), packets,
                 fields_from_psih(psih_fn(sol), g)))
    got = job.result(f"{kind}_frame")
    _close(got["sol"], jsh.unshard(js))
    _close(got["sol"], rep.sol.numpy())
    _close_packets(got, jp)
    _close_packets(got, rep.packets)
    assert int(got["step"]) == int(jc.step) == 5


def _check_overlap(ranks, kind):
    got = ranks[0].result(f"{kind}_overlap")
    np.testing.assert_array_equal(got["seq.sol"], got["ovl.sol"])
    for n in "xykl":
        np.testing.assert_allclose(got[f"ovl.{n}"], got[f"seq.{n}"], rtol=1e-6, atol=1e-7)
    assert int(got["ovl.step"]) == 5 and np.isclose(got["ovl.t"], got["seq.t"])
    moved = np.abs(got["seq.x"] - ranks[1]["packets.x"]).max()
    assert moved > 1e-4


class TestShardedTwoLayerQG:
    def test_step_matches_replicated(self, ranks):
        _check_steps(ranks, "twolayer")

    def test_fields_match_replicated(self, ranks):
        _check_fields(ranks, "twolayer")

    def test_baroclinic_advect_fields(self, ranks):
        _check_fields(ranks, "twolayer", advect="baroclinic")

    def test_coupled_frame_matches_replicated(self, ranks):
        _check_frame(ranks, "twolayer")

    def test_overlap_frame_matches_sequential(self, ranks):
        _check_overlap(ranks, "twolayer")


class TestShardedSWQG:
    def test_step_matches_replicated(self, ranks):
        got = _check_steps(ranks, "swqg")
        # the channel-less layout round-trips
        assert tuple(got["roundtrip_shape"]) == ranks[1]["sol.swqg"].shape

    def test_fields_match_replicated(self, ranks):
        _check_fields(ranks, "swqg")

    def test_coupled_frame_matches_replicated(self, ranks):
        _check_frame(ranks, "swqg")


class TestShardedThomasYamada:
    def test_step_matches_replicated(self, ranks):
        _check_steps(ranks, "ty")

    def test_fields_match_replicated(self, ranks):
        _check_fields(ranks, "ty")


class TestShardedMultiLayerQG:
    def test_step_matches_replicated(self, ranks):
        _check_steps(ranks, "multilayer")

    def test_fields_match_replicated(self, ranks):
        _check_fields(ranks, "multilayer")


class TestShardedRSWVariants:
    def test_linborg_step_matches_replicated(self, ranks):
        _check_steps(ranks, "linborg")

    def test_modified_step_matches_replicated(self, ranks):
        _check_steps(ranks, "modified")

    def test_quadheight_step_and_fields_match(self, ranks):
        _check_steps(ranks, "quadheight")
        # the ray fields: eta recovered from m through a slab FFT round trip
        _check_fields(ranks, "quadheight")


def test_sharded_taps_gather_frame(ranks):
    """gather='taps' in the sharded frame matches the patch frame and the
    JAX package's sharded taps frame; overlap needs the patch path."""
    job, inputs = ranks
    jg, jmodel, jcls = _jax_model("swqg")
    mesh = jmake_mesh(2)
    jsh = jcls(jg, jmodel.params, mesh, dt=DT)
    jrp, _ = _rps(jg)
    init_s, _ = jsh.stepper()
    s = jsh.shard_solution(jnp.asarray(inputs["sol.swqg"]))
    _, _, _, jp = jsh.make_coupled_frame(jrp._replace(gather="taps"), 5, k_cutoff=K_CUTOFF,
                                         k0=K0)(
        s, jzero_clock(), init_s(s),
        jshard_packets(jlattice(8, jg.Lx, jg.Ly, k0=K0, k_ring=True), mesh))
    got = job.result("swqg_taps")
    for n in "xykl":
        np.testing.assert_allclose(got[f"taps.{n}"], got[f"patch.{n}"], rtol=5e-5, atol=5e-6)
    _close_packets(got, jp, prefix="taps.")
    assert int(got["taps.step"]) == 5
    assert "patch" in str(got["refused"])


def test_sharded_bicubic_fields_carry_the_derivative_blocks(ranks):
    """For bicubic the sharded fields are the replicated
    ``fields_from_psih`` stack of 20 channels ([f | fx | fy | fxy] of the
    5 fields), which the bicubic patch table reads; the JAX package's
    sharded fields stay at the 5 base channels there (ROADMAP queue 3,
    a property of the reference)."""
    job, inputs = ranks
    g, model = _torch_model("swqg")
    sol = torch.as_tensor(np.array(inputs["sol.swqg"]))
    want = fields_from_psih(_torch_psih("swqg", g, model, sol), g, "bicubic").numpy()
    got = job.result("swqg_bicubic_fields")["fields"]
    assert got.shape == want.shape == (20, NX, NX)
    _close(got, want)
