"""Parity of the PyTorch port's ray half with the JAX package on the CPU:
tables, packets, the fused substep's twin and wrapper, fixed-step DP5 and
the taps path.

Table builds, packets and the k-cutoff are data movement and must agree
exactly. The fused substep's twin ``substep_torch`` computes the JAX
kernel's formulas in the same order, so it agrees with the JAX twin to a
few float32 ulps (rtol 1e-6, atol 1e-6 on O(1)-O(10) values). The JAX
package runs its per-stage sampler on the CPU, which sums the same terms
in another order (rtol 1e-5, atol 1e-6, the JAX package's own bound for
that pair in ``tests/test_pallas_ray_step.py``).

The taps path gathers and sums the same taps in the same order as the
JAX package (rtol 1e-6, atol 1e-6 on O(1) fields). The adaptive path's
tests are in ``tests/test_torch_adaptive.py``; the kernels run only on an
NVIDIA GPU, and their tests are in ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.ops import pallas_ray_step as jops  # noqa: E402
from juliaraytracingsw_tpu.rays import dispersion as jdisp  # noqa: E402
from juliaraytracingsw_tpu.rays import packets as jpk  # noqa: E402
from juliaraytracingsw_tpu.rays import patch as jpatch  # noqa: E402
from juliaraytracingsw_tpu.rays import raytrace as jrt  # noqa: E402
from juliaraytracingsw_tpu.rays import interp as jinterp  # noqa: E402
from juliaraytracingsw_tpu.rays.interp import (  # noqa: E402
    bspline_prefilter_mask as jprefilter)
from juliaraytracingsw_tpu.rays.resample import k_cutoff_reset as jreset  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.ops import ray_step as tops  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import dispersion as tdisp  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import packets as tpk  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import patch as tpatch  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import raytrace as trt  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import interp as tinterp  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.interp import (  # noqa: E402
    bspline_prefilter_mask as tprefilter)
from juliaraytracingsw_tpu_torch.rays.resample import k_cutoff_reset as treset  # noqa: E402

INTERPS = ["bilinear", "bspline", "bicubic"]
L = 2 * np.pi
NY = NX = 32


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _rp(mod, interp, table_dtype="float32"):
    return mod.RayParams(f=3.0, Cg=1.0, x0=-L / 2, y0=-L / 2, dx=L / NX,
                         dy=L / NY, interp=interp, table_dtype=table_dtype)


def _packets(n=256, seed=5):
    """Packets scattered over three periods in x and y, so base cells are
    negative and beyond the grid: only the cell index wraps."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-1.5 * L, 1.5 * L, (2, n))
    phase = rng.uniform(0, 2 * np.pi, n)
    k, l = 5.196 * np.cos(phase), 5.196 * np.sin(phase)
    sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    arrs = [a.astype(np.float32) for a in (x, y, k, l, sign)]
    return (jpk.Packets(*(jnp.asarray(a) for a in arrs)),
            tpk.Packets(*(torch.as_tensor(a) for a in arrs)))


def _fields(interp, seed=0):
    """Random (old, new) field stacks with the interp's channel count."""
    rng = np.random.default_rng(seed)
    nch = tops.n_channels(interp)
    return [(rng.standard_normal((nch, NY, NX)) * 0.1).astype(np.float32)
            for _ in range(2)]


def _tables(interp, table_dtype="float32"):
    fo, fn = _fields(interp)
    Tj = jrt.make_pair_table(jpatch.build_patch_table(jnp.asarray(fo), interp),
                             jpatch.build_patch_table(jnp.asarray(fn), interp),
                             table_dtype)
    Tt = trt.make_pair_table(tpatch.build_patch_table(torch.as_tensor(fo), interp),
                             tpatch.build_patch_table(torch.as_tensor(fn), interp),
                             table_dtype)
    return Tj, Tt


def _fused_inputs(interp, seed=5, n=256):
    """(rows_T, st, scal) for the JAX and the port's fused substep."""
    rp = _rp(trt, interp)
    Tj, Tt = _tables(interp)
    _, pt = _packets(n, seed)
    rows, bx, by = trt._gather_patch_rows(Tt, pt, rp, NY, NX)
    st = torch.stack([pt.x, pt.y, pt.k, pt.l, pt.sign, bx, by])
    rows_T = rows.t().contiguous()
    scal = torch.tensor([0.25, 0.01])
    return rows_T, st, scal


def test_constants_pinned():
    assert tpatch.PATCH_SHAPES == jpatch.PATCH_SHAPES
    assert tops.RK4_STAGES == jops._RK4_STAGES
    assert tops.RK4_B == jops._RK4_B
    for interp in INTERPS:
        assert tops.n_channels(interp) == jops.n_channels(interp)


def test_packets_and_dispersion():
    kw = dict(Lx=L, Ly=L, k0=5.196, k_ring=True)
    pj, pt = jpk.lattice_packets(8, **kw), tpk.lattice_packets(8, **kw, device="cpu")
    for a, b in zip(pt, pj):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(_np(a), _np(b))
    arr = tpk.packets_to_array(pt)
    np.testing.assert_array_equal(_np(arr), _np(jpk.packets_to_array(pj)))
    back = tpk.packets_from_array(arr, pt.sign)
    for a, b in zip(back, pt):
        assert torch.equal(a, b)
    assert pt.n == pj.n == 64
    np.testing.assert_allclose(_np(tdisp.omega(pt.k, pt.l, 3.0, 1.0, pt.sign)),
                               _np(jdisp.omega(pj.k, pj.l, 3.0, 1.0, pj.sign)),
                               rtol=1e-6)
    for a, b in zip(tdisp.group_velocity(pt.k, pt.l, 3.0, 1.0, pt.sign),
                    jdisp.group_velocity(pj.k, pj.l, 3.0, 1.0, pj.sign)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-7)


def test_k_cutoff_reset_exact():
    pj, pt = _packets(64)
    pt = pt._replace(k=pt.k * torch.linspace(0.5, 3.0, 64))
    pj = pj._replace(k=jnp.asarray(_np(pt.k)))
    out_t, out_j = treset(pt, 9.0, 5.196), jreset(pj, 9.0, 5.196)
    reset = _np(pt.k) ** 2 + _np(pt.l) ** 2 >= 81.0
    assert 0 < reset.sum() < 64
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("interp", INTERPS)
def test_patch_and_pair_tables_exact(interp):
    fo, fn = _fields(interp)
    Tt = tpatch.build_patch_table(torch.as_tensor(fo), interp)
    Tj = jpatch.build_patch_table(jnp.asarray(fo), interp)
    np.testing.assert_array_equal(_np(Tt), _np(Tj))
    for dtype in ("float32", "bfloat16"):
        Pj, Pt = _tables(interp, dtype)
        assert Pt.dtype == getattr(torch, dtype)
        # both round float32 to bfloat16 to nearest even
        np.testing.assert_array_equal(_np(Pt.float()),
                                      np.asarray(Pj.astype(jnp.float32)))


def test_prefilter_and_fields_from_psih():
    jg, tg = jmake_grid(NX), tmake_grid(NX, device="cpu")
    np.testing.assert_array_equal(_np(tprefilter(tg)), _np(jprefilter(jg)))
    rng = np.random.default_rng(7)
    psi = rng.standard_normal((NY, NX)).astype(np.float32)
    psih = np.fft.rfft2(psi).astype(np.complex64) * _np(jg.dealias_mask)
    for interp in INTERPS:
        ft = trt.fields_from_psih(torch.as_tensor(psih), tg, interp)
        fj = jrt.fields_from_psih(jnp.asarray(psih), jg, interp)
        assert ft.shape == fj.shape == (tops.n_channels(interp), NY, NX)
        # one batched inverse transform per stack
        err = np.abs(_np(ft) - _np(fj)).max() / np.abs(_np(fj)).max()
        assert err < 2e-6, (interp, err)
    a = torch.tensor(0.25)
    blended = trt.blend(torch.ones(3), torch.zeros(3), a)
    np.testing.assert_allclose(_np(blended), 0.75)


@pytest.mark.parametrize("interp", INTERPS)
def test_twin_matches_jax_twin(interp):
    rows_T, st, scal = _fused_inputs(interp)
    rp = _rp(trt, interp)
    cfg = tops.substep_cfg(rp, interp)
    out_t = tops.substep_torch(rows_T, st, scal, cfg=cfg, interp=interp,
                               da=0.5, x0=rp.x0, y0=rp.y0)
    fj = jops.make_fused_substep(_rp(jrt, interp), interp, 0.5, impl="jnp")
    out_j = fj(jnp.asarray(_np(rows_T)), jnp.asarray(_np(st)),
               jnp.asarray(_np(scal)))
    assert out_t.shape == (4, st.shape[1]) and out_t.dtype == torch.float32
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), rtol=1e-6, atol=1e-6)


def test_twin_matches_jax_interpret_kernel():
    """The Pallas kernel itself, run by the Pallas interpreter as the JAX
    package's own tests run it (bilinear: the 20-channel bicubic interpret
    unroll takes minutes on the CPU)."""
    interp = "bilinear"
    rows_T, st, scal = _fused_inputs(interp, n=128)
    rp = _rp(trt, interp)
    out_t = tops.substep_torch(rows_T, st, scal, cfg=tops.substep_cfg(rp, interp),
                               interp=interp, da=0.5, x0=rp.x0, y0=rp.y0)
    kern = jops.make_fused_substep(_rp(jrt, interp), interp, 0.5, block=128,
                                   impl="interpret")
    out_j = kern(jnp.asarray(_np(rows_T)), jnp.asarray(_np(st)),
                 jnp.asarray(_np(scal)))
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interp", INTERPS)
def test_raytrace_tables_matches_jax(interp, table_dtype):
    """4 substeps through the pair table; positions leave the grid."""
    Tj, Tt = _tables(interp, table_dtype)
    pj, pt = _packets()
    out_j = jrt.raytrace_tables(pj, Tj, 0.0, 0.04, _rp(jrt, interp, table_dtype),
                                NY, NX, 4, "rk4")
    out_t = trt.raytrace_tables(pt, Tt, torch.tensor(0.0), torch.tensor(0.04),
                                _rp(trt, interp, table_dtype), NY, NX, 4, "rk4")
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    moved = np.abs(_np(out_t.x) - _np(pt.x)).max()
    assert moved > 1e-3


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_raytrace_tables_dopri5_matches_jax(table_dtype):
    """Fixed-step DP5 runs the per-stage path in both packages."""
    Tj, Tt = _tables("bilinear", table_dtype)
    pj, pt = _packets()
    out_j = jrt.raytrace_tables(pj, Tj, 0.0, 0.04, _rp(jrt, "bilinear", table_dtype),
                                NY, NX, 2, "dopri5")
    out_t = trt.raytrace_tables(pt, Tt, 0.0, 0.04, _rp(trt, "bilinear", table_dtype),
                                NY, NX, 2, "dopri5")
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    assert np.abs(_np(out_t.x) - _np(pt.x)).max() > 1e-3


@pytest.mark.parametrize("interp", INTERPS)
def test_taps_interpolate_matches_jax(interp):
    """Query points over three periods, so every tap index wraps."""
    fo, _ = _fields(interp)
    pj, pt = _packets(300, seed=6)
    kw = dict(x0=-L / 2, y0=-L / 2, dx=L / NX, dy=L / NY, method=interp)
    vt = tinterp.interpolate(torch.as_tensor(fo), pt.x, pt.y, **kw)
    vj = jinterp.interpolate(jnp.asarray(fo), pj.x, pj.y, **kw)
    assert vt.shape == (5, 300)
    np.testing.assert_allclose(_np(vt), np.asarray(vj), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown"):
        tinterp.interpolate(torch.as_tensor(fo), pt.x, pt.y, **dict(kw, method="cubic"))


@pytest.mark.parametrize("interp", INTERPS)
def test_sample_velocity_and_gradients_match_jax(interp):
    fo, _ = _fields(interp)
    pj, pt = _packets(64, seed=7)
    for ft, fj in ((trt.sample_velocity, jrt.sample_velocity),
                   (trt.sample_gradients, jrt.sample_gradients)):
        vals_t = ft(pt, torch.as_tensor(fo), _rp(trt, interp))
        vals_j = fj(pj, jnp.asarray(fo), _rp(jrt, interp))
        assert len(vals_t) == len(vals_j)
        for a, b in zip(vals_t, vals_j):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["rk4", "dopri5"])
def test_raytrace_taps_matches_jax(method):
    """The fixed-step taps path (the reference semantics), 3 substeps."""
    fo, fn = _fields("bspline")
    pj, pt = _packets()
    out_j = jrt.raytrace(pj, jnp.asarray(fo), jnp.asarray(fn), 0.0, 0.03,
                         _rp(jrt, "bspline")._replace(gather="taps"), 3, method)
    out_t = trt.raytrace(pt, torch.as_tensor(fo), torch.as_tensor(fn), 0.0, 0.03,
                         _rp(trt, "bspline")._replace(gather="taps"), 3, method)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-6)
    assert np.abs(_np(out_t.x) - _np(pt.x)).max() > 1e-3


def test_wrapper_on_cpu_uses_twin_and_counts_nothing():
    rows_T, st, scal = _fused_inputs("bspline")
    rp = _rp(trt, "bspline")
    before = dict(tops.launches)
    out = tops.fused_substep(rows_T, st, scal, rp=rp, interp="bspline", da=0.5)
    twin = tops.substep_torch(rows_T, st, scal, cfg=tops.substep_cfg(rp, "bspline"),
                              interp="bspline", da=0.5, x0=rp.x0, y0=rp.y0)
    assert torch.equal(out, twin)
    assert tops.launches == before


def test_wrapper_rejects_bad_inputs():
    rows_T, st, scal = _fused_inputs("bilinear", n=64)
    rp = _rp(trt, "bilinear")
    call = dict(rp=rp, interp="bilinear", da=1.0)
    with pytest.raises(TypeError, match="float32"):
        tops.fused_substep(rows_T.double(), st, scal, **call)
    with pytest.raises(ValueError, match="shape"):
        tops.fused_substep(rows_T[:-1], st, scal, **call)
    with pytest.raises(ValueError, match="contiguous"):
        tops.fused_substep(rows_T.t().contiguous().t(), st, scal, **call)
    with pytest.raises(ValueError, match="available"):
        tops.fused_substep(rows_T, st, scal, rp=rp, interp="cubic", da=1.0)
    with pytest.raises(RuntimeError, match="CPU or CUDA"):
        tops.fused_substep(rows_T.to("meta"), st.to("meta"), scal.to("meta"), **call)
    with pytest.raises(NotImplementedError, match="item 15"):
        trt.raytrace_tables(tpk.Packets(*st[:5]), torch.zeros(NY * NX, 160), 0.0,
                            0.1, rp, NY, NX, method="midpoint")
    with pytest.raises(NotImplementedError, match="item 13"):
        trt.raytrace_tables(tpk.Packets(*st[:5]), torch.zeros(NY * NX, 160), 0.0,
                            0.1, rp._replace(gather="auto"), NY, NX)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    from juliaraytracingsw_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_reports_nvcc_errors(tmp_path, monkeypatch):
    """A failed compile raises with nvcc's stderr and leaves no library."""
    from juliaraytracingsw_tpu_torch.ops import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'ray_step.cu(1): error: no such thing' >&2\nexit 2\n")
    fake.chmod(0o755)
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(_build, "_LIB", None)
    with pytest.raises(RuntimeError, match=r"(?s)exit 2.*no such thing"):
        _build.load_library()
    assert list(build_dir.iterdir()) == []
