"""The port's exact spectral evaluation (``analysis/nufft``) and NUFFT ray
tracing (``rays/nufft_rays``) against the JAX package on the CPU.

``nufft2d2`` of band-limited random spectra at random points: against the
JAX function and against a direct sum over every mode of the full
(Hermitian-extended) spectrum in float64, to 1e-5 of the field's largest
value (float32 phases of arguments up to ~100 rad: 1e-6 measured).
``nufft_raytrace`` over two snapshots with 1 and 3 substeps: packets
within 1e-5 of the JAX package's.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu.analysis.nufft import nufft2d2 as jnufft  # noqa: E402
from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.rays import nufft_rays as jnr  # noqa: E402
from juliaraytracingsw_tpu.rays.packets import Packets as JPackets  # noqa: E402
from juliaraytracingsw_tpu.rays.raytrace import RayParams as JRayParams  # noqa: E402
from juliaraytracingsw_tpu_torch.analysis.nufft import nufft2d2  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.core.spectral import rfft2  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import nufft_rays  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.packets import Packets  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.raytrace import RayParams  # noqa: E402

TOL = 1e-5


def _spectra(nx, ny_fields=3, seed=0, Lx=2 * np.pi):
    """Band-limited random real fields -> their rfft2 spectra (numpy)."""
    rng = np.random.default_rng(seed)
    grid = make_grid(nx, Lx=Lx, device="cpu")
    fields = rng.normal(size=(ny_fields, nx, nx)).astype(np.float32)
    fh = rfft2(torch.as_tensor(fields))
    K = torch.sqrt(grid.Krsq)
    fh = torch.where(K < nx / 4 * 2 * np.pi / Lx, fh, torch.zeros_like(fh))
    return grid, fh.numpy()


def _points(n, Lx=2 * np.pi, seed=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.5 * Lx, 1.5 * Lx, (2, n)).astype(np.float32)


@pytest.mark.parametrize("nx,Lx", [(16, 2 * np.pi), (32, 2 * np.pi), (24, 5.0)])
def test_nufft2d2_matches_jax_and_a_direct_sum(nx, Lx):
    grid, fh = _spectra(nx, Lx=Lx)
    xq, yq = _points(257, Lx)
    got = nufft2d2(torch.as_tensor(fh), torch.as_tensor(xq), torch.as_tensor(yq), grid).numpy()
    jgrid = jmake_grid(nx, Lx=Lx)
    ref = np.asarray(jnufft(jnp.asarray(fh), jnp.asarray(xq), jnp.asarray(yq), jgrid))
    scale = np.abs(ref).max()
    assert got.shape == (3, 257) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * scale)
    # the direct sum over the full spectrum, in float64
    full = np.fft.fft2(np.fft.irfft2(fh.astype(np.complex128), s=(nx, nx)))
    k = np.fft.fftfreq(nx, d=Lx / (2 * np.pi * nx))
    x0 = float(grid.x[0])
    ph = np.exp(1j * (k[None, :, None] * (xq[None, None, :] - x0)
                      + k[:, None, None] * (yq[None, None, :] - x0)))
    direct = np.einsum("cyx,yxn->cn", full, ph).real / nx ** 2
    np.testing.assert_allclose(got, direct, rtol=0, atol=TOL * scale)


def test_nufft2d2_at_grid_nodes_is_the_inverse_transform():
    grid, fh = _spectra(16)
    X, Y = np.meshgrid(grid.x.numpy(), grid.y.numpy())
    got = nufft2d2(torch.as_tensor(fh), torch.as_tensor(X.ravel()), torch.as_tensor(Y.ravel()),
                   grid).numpy().reshape(3, 16, 16)
    ref = np.fft.irfft2(fh, s=(16, 16))
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())


@pytest.mark.parametrize("nsubsteps", [1, 3])
def test_nufft_raytrace_matches_jax(nsubsteps):
    nx = 32
    grid, psih = _spectra(nx, ny_fields=2, seed=4)
    psih = 0.05 * psih
    jgrid = jmake_grid(nx)
    rng = np.random.default_rng(2)
    cols = [*rng.uniform(-np.pi, np.pi, (2, 64)), *rng.normal(0, 3, (2, 64)),
            np.where(np.arange(64) % 2, 1.0, -1.0)]
    cols = [c.astype(np.float32) for c in cols]
    kw = dict(f=3.0, Cg=1.0, x0=float(grid.x[0]), y0=float(grid.y[0]), dx=grid.dx, dy=grid.dy)
    so, sn = (nufft_rays.spectra_from_psih(torch.as_tensor(p), grid) for p in psih)
    jso, jsn = (jnr.spectra_from_psih(jnp.asarray(p), jgrid) for p in psih)
    got = nufft_rays.nufft_raytrace(Packets(*map(torch.as_tensor, cols)), so, sn, 0.0, 0.05,
                                    grid, RayParams(**kw), nsubsteps=nsubsteps)
    ref = jnr.nufft_raytrace(JPackets(*map(jnp.asarray, cols)), jso, jsn, 0.0, 0.05, jgrid,
                             JRayParams(**kw), nsubsteps=nsubsteps)
    for name in ("x", "y", "k", "l", "sign"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    assert np.abs(got.x.numpy() - cols[0]).max() > 1e-3
