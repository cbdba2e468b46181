"""Gradients through the PyTorch port on the CPU, held against finite
differences and against ``jax.grad`` of the JAX package on the same inputs.

- The four classes of ``tests/test_gradients.py`` on the port, in float64:
  directional central differences (eps 1e-6) against the VJP, with the
  reference's tolerances (rtol 2e-4 interpolation, 5e-4 the flow, 1e-3 the
  rays), and the patch path's two backward formulations
  (``JRSW_PATCH_BWD``) against the taps path's gradients.
- Port against ``jax.grad`` (JAX in x64, toggled per test by the ``x64``
  fixture) for interpolation, the SWQG run, ``raytrace`` (patch and taps,
  with respect to the flow, the positions and ``t1``), implicit midpoint
  and ``raytrace_adaptive(loop='scan')``: rtol 5e-5, atol 1e-7 x max|g|,
  the reference's own bound between two formulations of one gradient
  (``tests/test_gradients.py:161-163``).
- The substep's VJP in float32: ``FusedSubstep`` against the JAX kernel's
  custom VJP in Pallas interpret mode (rtol 1e-5, atol 1e-6, the bound of
  ``tests/test_pallas_ray_step.py``); ``TableSubstep`` against plain
  autograd through its twin ``table_substep_torch`` (the same bound; with
  a bfloat16 table the table's cotangent accumulates in bfloat16, held to
  one bfloat16 rounding, 2^-7 of the largest).
- Implicit midpoint (the port of ``tests/test_rays.py``'s midpoint test),
  ``remat`` through ``run`` and ``make_coupled_frame``, and float32 calls
  that float64 support leaves untouched.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.core.spectral import rfft2 as jrfft2  # noqa: E402
from juliaraytracingsw_tpu.core.steppers import zero_clock as jzero_clock  # noqa: E402
from juliaraytracingsw_tpu.coupled.initial_conditions import (  # noqa: E402
    random_band_psih as jpsih)
from juliaraytracingsw_tpu.models import base as jbase  # noqa: E402
from juliaraytracingsw_tpu.models import swqg as jswqg  # noqa: E402
from juliaraytracingsw_tpu.ops import pallas_ray_step as jops  # noqa: E402
from juliaraytracingsw_tpu.rays import interp as jinterp  # noqa: E402
from juliaraytracingsw_tpu.rays import packets as jpk  # noqa: E402
from juliaraytracingsw_tpu.rays import patch as jpatch  # noqa: E402
from juliaraytracingsw_tpu.rays import raytrace as jrt  # noqa: E402
from juliaraytracingsw_tpu_torch import interop  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.core.spectral import rfft2 as trfft2  # noqa: E402
from juliaraytracingsw_tpu_torch.core.steppers import zero_clock as tzero_clock  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled import driver as tdrv  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled.initial_conditions import (  # noqa: E402
    band_geo_wave_ic as tic, random_band_psih as tpsih)
from juliaraytracingsw_tpu_torch.models import base as tbase  # noqa: E402
from juliaraytracingsw_tpu_torch.models import rsw as trsw  # noqa: E402
from juliaraytracingsw_tpu_torch.models import swqg as tswqg  # noqa: E402
from juliaraytracingsw_tpu_torch.ops import ray_step as tops  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import interp as tinterp  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import packets as tpk  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import patch as tpatch  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import raytrace as trt  # noqa: E402

F64 = torch.float64
CPU = "cpu"
L = 2 * np.pi


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _t(a):
    """A float64 CPU tensor of a numpy or JAX array."""
    return torch.as_tensor(np.asarray(a, np.float64))


def fd_check(f, x, seed=0, eps=1e-6, rtol=2e-4):
    """Directional FD vs VJP for a scalar function of a real tensor."""
    rng = np.random.default_rng(seed)
    d = torch.as_tensor(rng.standard_normal(tuple(x.shape)), dtype=x.dtype)
    xg = x.detach().clone().requires_grad_()
    (g,) = torch.autograd.grad(f(xg), xg)
    analytic = float(torch.sum(g * d))
    with torch.no_grad():
        fd = float((f(x + eps * d) - f(x - eps * d)) / (2 * eps))
    assert abs(analytic - fd) <= rtol * max(abs(fd), abs(analytic), 1e-12), (analytic, fd)


def _grads(f, *xs):
    """Gradients of the scalar ``f(*leaves)`` with respect to each input."""
    leaves = [x.detach().clone().requires_grad_() for x in xs]
    return torch.autograd.grad(f(*leaves), leaves)


def assert_grads_match(port, ref, rtol=5e-5, atol_of_max=1e-7):
    """The reference's bound between two formulations of one gradient."""
    for a, b in zip(port, ref):
        b = _np(b)
        scale = float(np.abs(b).max()) + 1e-30
        np.testing.assert_allclose(_np(a), b, rtol=rtol, atol=atol_of_max * scale)


# --- the four classes of tests/test_gradients.py, on the port -------------------

@pytest.mark.usefixtures("x64")
class TestInterpGradients:
    def test_bilinear_grad_wrt_field(self, rng):
        g = tmake_grid(16, dtype=F64, device=CPU)
        xq, yq = _t(rng.uniform(-2, 2, 9)), _t(rng.uniform(-2, 2, 9))

        def f(field):
            out = tinterp.bilinear(field, xq, yq, float(g.x[0]), float(g.y[0]), g.dx, g.dy)
            return torch.sum(out ** 2)

        fd_check(f, _t(rng.standard_normal((2, 16, 16))))

    def test_bspline_grad_wrt_positions(self, rng):
        g = tmake_grid(32, dtype=F64, device=CPU)
        field = _t(rng.standard_normal((1, 32, 32)))

        def f(q):
            out = tinterp.bspline(field, q[:5], q[5:], float(g.x[0]), float(g.y[0]), g.dx,
                                  g.dy)
            return torch.sum(torch.sin(out))

        fd_check(f, _t(rng.uniform(-2, 2, 10)))


def _swqg_loss(g, model, init, step, nsteps=5, remat=False):
    """The reference's flow loss: 1e-4 Re sum(sol conj(sol)) after nsteps
    IF-AB3 steps from the PV of a physical streamfunction."""

    def f(psi_real):
        qh = tswqg.pv_from_streamfunction(trfft2(psi_real), g, model.params)
        sol, _, _ = tbase.run(step, qh, tzero_clock(F64, device=CPU), init(qh), nsteps,
                              remat=remat)
        return torch.real(torch.sum(sol * torch.conj(sol))) * 1e-4

    return f


@pytest.mark.usefixtures("x64")
class TestFlowGradients:
    def test_swqg_step_grad_wrt_ic(self, rng):
        g = tmake_grid(32, dtype=F64, device=CPU)
        model = tswqg.make_model(g, nu=1e-8, nnu=2)
        init, step = tbase.build_stepper(model, "IFMAB3", dt=1e-2)
        psih0 = tpsih(g, rng, amp=0.3, dtype=F64)
        psi0 = torch.fft.irfft2(psih0, s=(g.ny, g.nx))
        fd_check(_swqg_loss(g, model, init, step), psi0, eps=1e-6, rtol=5e-4)


def _ray_setup(rng, interp_method="bspline", sqrtp=3, nx=32):
    g = tmake_grid(nx, dtype=F64, device=CPU)
    psih = tpsih(g, rng, amp=0.05, dtype=F64)
    rp = trt.RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]), dx=g.dx,
                       dy=g.dy, interp=interp_method)
    p = tpk.lattice_packets(sqrtp, g.Lx, g.Ly, k0=6.0, dtype=F64, device=CPU)
    return g, psih, rp, p


@pytest.mark.usefixtures("x64")
class TestRayGradients:
    def test_raytrace_grad_wrt_flow(self, rng):
        g, psih, rp, p = _ray_setup(rng)

        def f(psi_real):
            fields = trt.fields_from_psih(trfft2(psi_real), g, rp.interp)
            out = trt.raytrace(p, fields, fields, 0.0, 0.5, rp, nsubsteps=8)
            return torch.mean(out.k ** 2 + out.l ** 2)

        fd_check(f, torch.fft.irfft2(psih, s=(g.ny, g.nx)), eps=1e-6, rtol=1e-3)

    def test_raytrace_grad_wrt_initial_positions(self, rng):
        g, psih, rp, p = _ray_setup(rng)
        fields = trt.fields_from_psih(psih, g, rp.interp)

        def f(xy):
            pk = tpk.Packets(xy[: p.n], xy[p.n:], p.k, p.l, p.sign)
            out = trt.raytrace(pk, fields, fields, 0.0, 0.5, rp, nsubsteps=8)
            return torch.mean(out.k ** 2 + out.l ** 2)

        fd_check(f, torch.cat([p.x, p.y]), eps=1e-6, rtol=1e-3)

    def test_grad_through_time_blend(self, rng):
        g, psih, rp, p = _ray_setup(rng)
        psih2 = tpsih(g, np.random.default_rng(7), amp=0.05, dtype=F64)
        f_new = trt.fields_from_psih(psih2, g, rp.interp)

        def f(psi_real):
            f_old = trt.fields_from_psih(trfft2(psi_real), g, rp.interp)
            out = trt.raytrace(p, f_old, f_new, 0.0, 0.3, rp, nsubsteps=4)
            return torch.mean(out.x ** 2 + out.y ** 2)

        fd_check(f, torch.fft.irfft2(psih, s=(g.ny, g.nx)), eps=1e-6, rtol=1e-3)


def _patch_bwd_setup(rng):
    g = tmake_grid(32, dtype=F64, device=CPU)
    psih = tpsih(g, rng, amp=0.05, dtype=F64)
    psih2 = tpsih(g, np.random.default_rng(3), amp=0.05, dtype=F64)
    rp = trt.RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]), dx=g.dx,
                       dy=g.dy, interp="bilinear")
    p = tpk.lattice_packets(4, g.Lx, g.Ly, k0=6.0, dtype=F64, device=CPU)
    return (rp, p, trt.fields_from_psih(psih, g, rp.interp),
            trt.fields_from_psih(psih2, g, rp.interp))


def _patch_bwd_grads(rp, p, f_old, f_new):
    def loss(fo, fn, t1):
        out = trt.raytrace(p, fo, fn, 0.0, t1, rp, nsubsteps=3)
        return torch.mean(out.k ** 2 + out.l ** 2) + torch.mean(out.x ** 2)

    return _grads(loss, f_old, f_new, torch.tensor(0.3, dtype=F64))


@pytest.mark.usefixtures("x64")
class TestPatchBackwardFormulation:
    """The patch path's default backward (autograd through the table path,
    its forward ``TableSubstep``) matches the taps path's gradients, and
    ``JRSW_PATCH_BWD=taps`` (the taps formulation's VJP at the patch
    forward) agrees with both."""

    def test_patch_default_grad_matches_taps(self, rng):
        rp, p, f_old, f_new = _patch_bwd_setup(rng)
        g_patch = _patch_bwd_grads(rp, p, f_old, f_new)
        g_taps = _patch_bwd_grads(rp._replace(gather="taps"), p, f_old, f_new)
        assert_grads_match(g_patch, g_taps)

    def test_taps_custom_vjp_backward_agrees(self, rng, monkeypatch):
        rp, p, f_old, f_new = _patch_bwd_setup(rng)
        g_tab = _patch_bwd_grads(rp, p, f_old, f_new)
        monkeypatch.setenv("JRSW_PATCH_BWD", "taps")
        g_fb = _patch_bwd_grads(rp, p, f_old, f_new)
        assert_grads_match(g_fb, g_tab)
        assert float(g_fb[2]) != 0.0


# --- the port's gradients against jax.grad on the same inputs -------------------

def _jax_ray_setup(seed, interp="bspline", sqrtp=3, nx=32):
    """The same grid, streamfunction, ray parameters and packets in both
    packages, float64 (the numpy spectrum handed to both)."""
    g, psih, rp, p = _ray_setup(np.random.default_rng(seed), interp, sqrtp, nx)
    jg = jmake_grid(nx, dtype=jnp.float64)
    jrp = jrt.RayParams(*rp)
    jp = jpk.Packets(*(jnp.asarray(_np(a)) for a in p))
    return g, jg, rp, jrp, p, jp, _np(psih)


@pytest.mark.usefixtures("x64")
@pytest.mark.parametrize("method", ["bilinear", "bspline", "bicubic"])
def test_interp_grad_matches_jax(method):
    rng = np.random.default_rng(2)
    nch = 20 if method == "bicubic" else 5
    field = rng.standard_normal((nch, 16, 16))
    q = rng.uniform(-4, 4, (2, 11))
    args = (-L / 2, -L / 2, L / 16, L / 16)

    def loss_t(fl, qq):
        return torch.sum(torch.sin(tinterp.interpolate(fl, qq[0], qq[1], *args, method)))

    def loss_j(fl, qq):
        return jnp.sum(jnp.sin(jinterp.interpolate(fl, qq[0], qq[1], *args, method)))

    ref = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(field), jnp.asarray(q))
    assert_grads_match(_grads(loss_t, _t(field), _t(q)), ref)


@pytest.mark.usefixtures("x64")
def test_swqg_run_grad_matches_jax():
    g = tmake_grid(32, dtype=F64, device=CPU)
    model = tswqg.make_model(g, nu=1e-8, nnu=2)
    init, step = tbase.build_stepper(model, "IFMAB3", dt=1e-2)
    psi0 = torch.fft.irfft2(tpsih(g, np.random.default_rng(4), amp=0.3, dtype=F64),
                            s=(32, 32))
    jg = jmake_grid(32, dtype=jnp.float64)
    jmodel = jswqg.make_model(jg, nu=1e-8, nnu=2)
    jinit, jstep = jbase.build_stepper(jmodel, "IFMAB3", dt=1e-2)

    def loss_j(psi_real):
        qh = jswqg.pv_from_streamfunction(jrfft2(psi_real), jg, jmodel.params)
        sol, _, _ = jbase.run(jstep, qh, jzero_clock(jnp.float64), jinit(qh), 5)
        return jnp.real(jnp.sum(sol * jnp.conj(sol))) * 1e-4

    ref = jax.grad(loss_j)(jnp.asarray(_np(psi0)))
    assert_grads_match(_grads(_swqg_loss(g, model, init, step), psi0), [ref])


@pytest.mark.usefixtures("x64")
@pytest.mark.parametrize("wrt", ["flow", "positions", "t1"])
@pytest.mark.parametrize("gather", ["patch", "taps"])
def test_raytrace_grad_matches_jax(gather, wrt):
    g, jg, rp, jrp, p, jp, psih = _jax_ray_setup(5)
    rp, jrp = rp._replace(gather=gather), jrp._replace(gather=gather)
    psi0 = np.fft.irfft2(psih, s=(32, 32))
    psi2 = _np(torch.fft.irfft2(tpsih(g, np.random.default_rng(6), amp=0.05, dtype=F64),
                                s=(32, 32)))

    def loss(mod, rfft, P, grid, rpm, pk, mean):
        def f(psi_a, xy, t1):
            fo = mod.fields_from_psih(rfft(psi_a), grid, rpm.interp)
            fn = mod.fields_from_psih(rfft(psi2 if mod is jrt else _t(psi2)), grid, rpm.interp)
            n = pk.x.shape[0]
            start = P(xy[:n], xy[n:], pk.k, pk.l, pk.sign)
            out = mod.raytrace(start, fo, fn, 0.0, t1, rpm, nsubsteps=4)
            return mean(out.k ** 2 + out.l ** 2) + mean(out.x ** 2)
        return f

    xy = np.concatenate([_np(p.x), _np(p.y)])
    argnum = ("flow", "positions", "t1").index(wrt)
    ref = jax.grad(loss(jrt, jrfft2, jpk.Packets, jg, jrp, jp, jnp.mean), argnums=argnum)(
        jnp.asarray(psi0), jnp.asarray(xy), jnp.float64(0.3))
    port = _grads(loss(trt, trfft2, tpk.Packets, g, rp, p, torch.mean), _t(psi0), _t(xy),
                  torch.tensor(0.3, dtype=F64))[argnum]
    assert float(np.abs(_np(port)).max()) > 0
    assert_grads_match([port], [ref])


@pytest.mark.usefixtures("x64")
@pytest.mark.parametrize("gather", ["patch", "taps"])
def test_midpoint_grad_matches_jax(gather):
    """The converged solve and its implicit VJP (the reference's
    ``lax.custom_root`` with an 8-term Neumann tangent solve)."""
    g, jg, rp, jrp, p, jp, psih = _jax_ray_setup(8, interp="bilinear")
    rp, jrp = rp._replace(gather=gather), jrp._replace(gather=gather)
    fields = _np(trt.fields_from_psih(torch.as_tensor(psih), g, rp.interp))

    def loss_t(fl, t1):
        out = trt.raytrace(p, fl, fl, 0.0, t1, rp, nsubsteps=4, method="midpoint")
        return torch.mean(out.k ** 2 + out.x ** 2)

    def loss_j(fl, t1):
        out = jrt.raytrace(jp, fl, fl, 0.0, t1, jrp, nsubsteps=4, method="midpoint")
        return jnp.mean(out.k ** 2 + out.x ** 2)

    ref = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(fields), jnp.float64(0.4))
    assert_grads_match(_grads(loss_t, _t(fields), torch.tensor(0.4, dtype=F64)), ref)


@pytest.mark.usefixtures("x64")
@pytest.mark.parametrize("pair", ["dopri5", "rkf78"])
def test_adaptive_scan_grad_matches_jax(pair):
    """``loop='scan'`` is the adaptive integrator's differentiable form in
    both packages (its step-size control is differentiated too)."""
    g, jg, rp, jrp, p, jp, psih = _jax_ray_setup(9, interp="bilinear")
    f_old = _np(trt.fields_from_psih(torch.as_tensor(psih), g, rp.interp))
    f_new = 1.1 * f_old
    opts = dict(rtol=1e-6, atol=1e-8, max_steps=6, init_substeps=2, pair=pair, loop="scan")

    def loss_t(fo, t1):
        out, _ = trt.raytrace_adaptive(p, fo, _t(f_new), 0.0, t1, rp, **opts)
        return torch.mean(out.k ** 2 + out.l ** 2) + torch.mean(out.y ** 2)

    def loss_j(fo, t1):
        out, _ = jrt.raytrace_adaptive(jp, fo, jnp.asarray(f_new), 0.0, t1, jrp, **opts)
        return jnp.mean(out.k ** 2 + out.l ** 2) + jnp.mean(out.y ** 2)

    ref = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(f_old), jnp.float64(0.3))
    assert_grads_match(_grads(loss_t, _t(f_old), torch.tensor(0.3, dtype=F64)), ref)


# --- the substep's VJP (float32) -------------------------------------------------

NY = NX = 32


def _substep_setup(interp, n=256, seed=0, table_dtype="float32"):
    """Random (old, new) fields, a pair table, packets over three periods
    (cells wrap), as numpy float32; the port's T_pair, st (5, N), rp."""
    rng = np.random.default_rng(seed)
    nch = tops.n_channels(interp)
    fo, fn = (torch.as_tensor((rng.standard_normal((nch, NY, NX)) * 0.1).astype(np.float32))
              for _ in range(2))
    rp = trt.RayParams(f=3.0, Cg=1.0, x0=-L / 2, y0=-L / 2, dx=L / NX, dy=L / NY,
                       interp=interp, table_dtype=table_dtype)
    T_pair = trt.build_pair(fo, fn, rp)
    x, y = rng.uniform(-1.5 * L, 1.5 * L, (2, n))
    phase = rng.uniform(0, 2 * np.pi, n)
    sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    st = torch.as_tensor(np.stack([x, y, 5.2 * np.cos(phase), 5.2 * np.sin(phase), sign])
                         .astype(np.float32))
    return rp, T_pair, st


def _sub_loss(o):
    return torch.sum(o[2] ** 2 + o[3] ** 2) + torch.sum(o[0] * o[1])


def _fused_grads(interp):
    """The port's ``FusedSubstep`` gradients of ``_sub_loss`` with respect to
    (rows_T, st, scal), and the JAX-side inputs and loss of an output."""
    rp, T_pair, st5 = _substep_setup(interp)
    rows_T, st = tops.first_cut_inputs(T_pair, st5, rp, NY, NX)
    scal = torch.tensor([0.25, 0.01])
    port = _grads(lambda r, s, sc: _sub_loss(tops.fused_substep(r, s, sc, rp=rp,
                                                                interp=interp, da=0.5)),
                  rows_T, st, scal)
    assert float(port[0].abs().max()) > 0
    inputs = tuple(jnp.asarray(_np(a)) for a in (rows_T, st, scal))

    def loss_j(o):
        return jnp.sum(o[2] ** 2 + o[3] ** 2) + jnp.sum(o[0] * o[1])

    return port, inputs, loss_j, jrt.RayParams(*rp)


def test_fused_substep_vjp_matches_jax_interpret():
    """``FusedSubstep``'s backward against the JAX kernel's custom VJP,
    the kernel run in Pallas interpret mode (bilinear, as the reference's
    own test: the other interps take minutes to interpret)."""
    port, inputs, loss_j, jrp = _fused_grads("bilinear")
    kern = jops.make_fused_substep(jrp, "bilinear", da=0.5, block=128, impl="interpret")
    ref = jax.grad(lambda *a: loss_j(kern(*a)), argnums=(0, 1, 2))(*inputs)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("interp", ["bilinear", "bspline", "bicubic"])
def test_fused_substep_vjp_matches_jax_bwd(interp):
    """The same against the body of the reference's ``bwd``
    (``ops/pallas_ray_step.py:313-325``): ``jax.vjp`` of the per-stage
    formulation on ``rows_T.T``, for every interp."""
    port, inputs, loss_j, jrp = _fused_grads(interp)

    def formulation(rows_T, st, scal):
        x, y, kk, ll, sgn, bx, by = (st[i] for i in range(7))
        sample = jrt._patch_sampler_from_rows(rows_T.T, bx, by, jrp)
        out = jrt._step(jpk.Packets(x, y, kk, ll, sgn), sample, scal[0], 0.5, scal[1], jrp,
                        "rk4")
        return jnp.stack([out.x, out.y, out.k, out.l])

    ref = jax.grad(lambda *a: loss_j(formulation(*a)), argnums=(0, 1, 2))(*inputs)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interp", ["bilinear", "bspline", "bicubic"])
def test_table_substep_vjp_matches_twin_autograd(interp, table_dtype):
    """``TableSubstep``'s backward (the per-stage formulation) against plain
    autograd through the twin: cotangents of the table (through the row
    gather's ``index_select``, in the table's dtype), the state and the
    scalars; the forward is the twin itself and counts no launch."""
    rp, T_pair, st = _substep_setup(interp, table_dtype=table_dtype)
    scal = torch.tensor([0.25, 0.01])
    geo = dict(rp=rp, interp=interp, da=0.5, ny=NY, nx=NX)
    before = dict(tops.table_launches)
    out = tops.table_substep(T_pair, st, scal, **geo)
    assert torch.equal(out, tops.table_substep_torch(T_pair, st, scal, **geo))
    assert tops.table_launches == before
    port = _grads(lambda T, s, sc: _sub_loss(tops.table_substep(T, s, sc, **geo)),
                  T_pair, st, scal)
    ref = _grads(lambda T, s, sc: _sub_loss(tops.table_substep_torch(T, s, sc, **geo)),
                 T_pair, st, scal)
    assert port[0].dtype == T_pair.dtype
    rows = [(g != 0).any(dim=1) for g in (port[0], ref[0])]
    assert torch.equal(*rows) and bool(rows[0].any())
    table_tol = (dict(rtol=1e-5, atol=1e-6) if table_dtype == "float32"
                 else dict(rtol=2 ** -7, atol=2 ** -7 * float(ref[0].float().abs().max())))
    torch.testing.assert_close(port[0].float(), ref[0].float(), **table_tol)
    for a, b in zip(port[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.usefixtures("x64")
def test_table_substep_takes_float64_state_on_the_cpu():
    """float64 ``st``/``scal`` run the twin in float64 and differentiate;
    float16 is refused."""
    rp, T_pair, st = _substep_setup("bspline", n=64)
    scal = torch.tensor([0.0, 0.01], dtype=F64)
    geo = dict(rp=rp, interp="bspline", da=1.0, ny=NY, nx=NX)
    out = tops.table_substep(T_pair, st.double(), scal, **geo)
    assert out.dtype == F64
    torch.testing.assert_close(out.float(), tops.table_substep(T_pair, st, scal.float(), **geo),
                               rtol=1e-5, atol=1e-5)
    fd_check(lambda s: _sub_loss(tops.table_substep(T_pair, s, scal, **geo)), st.double(),
             rtol=1e-6)
    with pytest.raises(TypeError, match="float32"):
        tops.table_substep(T_pair, st.half(), scal, **geo)


# --- implicit midpoint ------------------------------------------------------------

def test_midpoint_convergence_control_and_implicit_grad():
    """The port of ``tests/test_rays.py``'s midpoint test: (a) maxit=1 and
    the converged solve differ (the loop iterates), (b) the converged
    solve agrees with a fine RK4 run, (c) its gradient agrees with RK4's to
    the integrators' difference."""
    g = tmake_grid(64, device=CPU)
    psih = tpsih(g, np.random.default_rng(11), amp=0.05)
    fields = trt.fields_from_psih(psih, g)
    p = tpk.lattice_packets(4, g.Lx, g.Ly, k0=6.0, k_ring=True, device=CPU)
    base = dict(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]), dx=g.dx, dy=g.dy)
    out_conv = trt.raytrace(p, fields, fields, 0.0, 1.0, trt.RayParams(**base,
                            midpoint_rtol=1e-7), nsubsteps=50, method="midpoint")
    out_1it = trt.raytrace(p, fields, fields, 0.0, 1.0, trt.RayParams(**base,
                           midpoint_maxit=1), nsubsteps=50, method="midpoint")
    assert float((out_conv.x - out_1it.x).abs().max()) > 1e-7
    ref = trt.raytrace(p, fields, fields, 0.0, 1.0, trt.RayParams(**base), nsubsteps=800,
                       method="rk4")
    for a, b in zip(out_conv[:4], ref[:4]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-3, atol=1e-4)

    def loss(fl, method):
        out = trt.raytrace(p, fl, fl, 0.0, 0.2, trt.RayParams(**base), nsubsteps=8,
                           method=method)
        return torch.mean(out.k ** 2 + out.x ** 2)

    (gm,) = _grads(lambda fl: loss(fl, "midpoint"), fields)
    (gr,) = _grads(lambda fl: loss(fl, "rk4"), fields)
    assert bool(torch.isfinite(gm).all())
    np.testing.assert_allclose(_np(gm), _np(gr), rtol=0.05,
                               atol=2e-3 * float(gr.abs().max()))


def _graph_size(t):
    """Autograd nodes reachable from ``t``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return len(seen)


def test_midpoint_gradient_does_not_unroll_the_solve():
    """The autograd graph of a midpoint step is the same whether the solve
    stops after 1 iteration or runs 20: no iteration is differentiated."""
    rp, T_pair, st = _substep_setup("bilinear", n=32)
    sizes = []
    for rtol, maxit in ((1e-7, 20), (1e-7, 1)):
        rpm = rp._replace(midpoint_rtol=rtol, midpoint_maxit=maxit)
        T = T_pair.clone().requires_grad_()
        out = trt.raytrace_tables(tpk.Packets(*st), T, 0.0, 0.05, rpm, NY, NX,
                                  method="midpoint")
        sizes.append(_graph_size(out.x))
        (gT,) = torch.autograd.grad(out.k.sum(), T)
        assert bool(torch.isfinite(gT).all()) and bool((gT != 0).any())
    assert sizes[0] == sizes[1]


# --- remat -------------------------------------------------------------------------

@pytest.mark.usefixtures("x64")
def test_run_remat_grad_equals_plain():
    g = tmake_grid(32, dtype=F64, device=CPU)
    model = tswqg.make_model(g, nu=1e-8, nnu=2)
    init, step = tbase.build_stepper(model, "IFMAB3", dt=1e-2)
    psi0 = torch.fft.irfft2(tpsih(g, np.random.default_rng(5), amp=0.3, dtype=F64),
                            s=(32, 32))
    plain, remat = (_grads(_swqg_loss(g, model, init, step, nsteps=6, remat=r), psi0)
                    for r in (False, True))
    torch.testing.assert_close(remat, plain, rtol=1e-12, atol=0)


def _frame_grad(ray_method, gather, remat, nx=32, sqrtp=8, steps=3):
    """d mean(k^2 + l^2) / d sol after one coupled RSW frame at nx^2."""
    g = tmake_grid(nx, device=CPU)
    model = trsw.make_model(g, nu=tdrv.derive_nu(1.0, nx, 4, 2e-3), nnu=4, f=3.0, Cg=1.0)
    sol0 = tic(g, np.random.default_rng(1), Kg=(3, 5), Kw=(0, 2), ag=0.5, aw=0.05, f=3.0,
               Cg=1.0)
    rp = trt.RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]), dx=g.dx, dy=g.dy,
                       gather=gather)

    def psih_fn(sol):
        qh = g.ik * sol[1] - g.il * sol[0] - 3.0 * sol[2]
        return -qh / (g.Krsq + 9.0)

    init, step = tbase.build_stepper(model, "IFMAB3", 2e-3)
    frame = tdrv.make_coupled_frame(model, step, psih_fn, rp, steps, ray_method=ray_method,
                                    k_cutoff=300.0, k0=5.2, remat=remat)
    p = tpk.lattice_packets(sqrtp, g.Lx, g.Ly, k0=5.2, k_ring=True, device=CPU)

    def loss(sol):
        fields = trt.fields_from_psih(psih_fn(sol), g, rp.interp)
        end = frame(tdrv.SimState(sol, tzero_clock(device=CPU), init(sol), p, fields))
        return torch.mean(end.packets.k ** 2 + end.packets.l ** 2)

    return _grads(loss, sol0)[0]


@pytest.mark.parametrize("ray_method,gather", [("rk4", "patch"), ("rk4", "taps"),
                                               ("midpoint", "patch"), ("dopri5", "patch")])
def test_coupled_frame_remat_grad_equals_plain(ray_method, gather):
    plain = _frame_grad(ray_method, gather, remat=False)
    remat = _frame_grad(ray_method, gather, remat=True)
    assert float(plain.abs().max()) > 0
    torch.testing.assert_close(remat, plain, rtol=1e-6, atol=1e-9 * float(plain.abs().max()))


# --- float64 support leaves float32 calls untouched ----------------------------------

@pytest.mark.usefixtures("x64")
def test_float64_entry_points_match_jax():
    """make_grid, lattice_packets and random_band_psih take the dtype; the
    grids and lattices are bit-equal to the JAX package's in x64."""
    tg, jg = tmake_grid(32, dtype=F64, device=CPU), jmake_grid(32, dtype=jnp.float64)
    for name in ("x", "y", "kr", "l", "Krsq", "invKrsq", "dealias_mask", "ik", "il"):
        a, b = _np(getattr(tg, name)), np.asarray(getattr(jg, name))
        assert a.dtype == b.dtype and a.dtype in (np.float64, np.complex128), name
        np.testing.assert_array_equal(a, b, err_msg=name)
    tp = tpk.lattice_packets(5, L, L, 6.0, k_ring=True, dtype=F64, device=CPU)
    jp = jpk.lattice_packets(5, L, L, 6.0, k_ring=True, dtype=jnp.float64)
    for a, b in zip(tp, jp):
        assert a.dtype == F64
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    pt = tpsih(tg, np.random.default_rng(2), dtype=F64)
    pj = jpsih(jg, np.random.default_rng(2), dtype=jnp.float64)
    assert pt.dtype == torch.complex128
    np.testing.assert_allclose(_np(pt), np.asarray(pj), rtol=0,
                               atol=1e-14 * float(np.abs(np.asarray(pj)).max()))
    assert tzero_clock(F64, device=CPU).t.dtype == F64


def test_float32_calls_unchanged():
    """The default calls still build float32 grids, packets and times, and
    a float32 RK4 ray step is bit-identical to the table substep's twin fed
    the float32 scalars it always got ([i * da, (t1 - t0) / n])."""
    g = tmake_grid(32, device=CPU)
    assert all(getattr(g, n).dtype == torch.float32 for n in ("x", "kr", "Krsq"))
    assert g.ik.dtype == torch.complex64
    p = tpk.lattice_packets(6, g.Lx, g.Ly, 5.2, k_ring=True, device=CPU)
    assert all(a.dtype == torch.float32 for a in p)
    assert tzero_clock(device=CPU).t.dtype == torch.float32
    assert tpsih(g, np.random.default_rng(1)).dtype == torch.complex64
    rp, T_pair, st = _substep_setup("bilinear", n=64)
    pk = tpk.Packets(*st)
    t0, t1 = torch.tensor(0.1), torch.tensor(0.37)
    out = trt.raytrace_tables(pk, T_pair, t0, t1, rp, NY, NX, nsubsteps=2)
    h = (t1 - t0) / 2
    q = pk
    for i in range(2):
        a0 = torch.full((), float(i), dtype=torch.float32) * 0.5
        o = tops.table_substep_torch(T_pair, torch.stack(list(q)), torch.stack([a0, h]),
                                     rp=rp, interp="bilinear", da=0.5, ny=NY, nx=NX)
        q = tpk.Packets(o[0], o[1], o[2], o[3], q.sign)
    for a, b in zip(out, q):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_interop_carries_float64_state():
    """Double arrays keep their precision across; single ones stay single."""
    rng = np.random.default_rng(0)
    for real, cplx in ((np.float32, np.complex64), (np.float64, np.complex128)):
        d = {"sol": (rng.standard_normal((3, 8, 5)) + 1j).astype(cplx),
             "clock.t": np.asarray(0.5, real), "clock.step": 4,
             "stepper_state.N1": np.zeros((3, 8, 5), cplx),
             "stepper_state.N2": np.ones((3, 8, 5), cplx),
             "fields": rng.standard_normal((5, 8, 8)).astype(real)}
        d.update({f"packets.{n}": rng.standard_normal(4).astype(real)
                  for n in ("x", "y", "k", "l", "sign")})
        sim = interop.sim_state_from_numpy(d, device=CPU)
        assert sim.sol.dtype == torch.from_numpy(np.zeros(1, cplx)).dtype
        assert sim.clock.t.dtype == sim.fields.dtype == sim.packets.x.dtype
        assert sim.fields.dtype == torch.from_numpy(np.zeros(1, real)).dtype
        back = interop.sim_state_to_numpy(sim)
        for key, val in d.items():
            np.testing.assert_array_equal(back[key], val, err_msg=key)


def test_patch_interpolate_matches_jax_split():
    """``patch_interpolate`` (one time level, the reference's 'split'
    oracle) against the JAX package's on the same rows; and the pair form
    at a = 0 and a = 1 equals it on each level's half of the pair rows."""
    rng = np.random.default_rng(4)
    for method in ("bilinear", "bspline", "bicubic"):
        ph, pw, _ = tpatch.PATCH_SHAPES[method]
        F = 20 if method == "bicubic" else 5
        rows = rng.standard_normal((37, 2 * F * ph * pw)).astype(np.float32)
        lx, ly = rng.uniform(0, 1, (2, 37)).astype(np.float32)
        kw = dict(method=method, deriv_scale=(0.2, 0.3))
        W = F * ph * pw
        t_rows, t_lx, t_ly = (torch.as_tensor(a) for a in (rows, lx, ly))
        for level in (0, 1):
            half = t_rows[:, level * W:(level + 1) * W]
            one = tpatch.patch_interpolate(half, t_lx, t_ly, **kw)
            ref = jpatch.patch_interpolate(jnp.asarray(_np(half)), jnp.asarray(lx),
                                           jnp.asarray(ly), **kw)
            np.testing.assert_allclose(_np(one), np.asarray(ref), rtol=1e-6, atol=1e-6)
            pair = tpatch.patch_interpolate_pair_shared(t_rows, t_lx, t_ly, float(level), **kw)
            np.testing.assert_allclose(_np(pair), _np(one), rtol=1e-6, atol=1e-6)
