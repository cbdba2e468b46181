"""The port's 1-D ray tracer (``rays/ray1d``) against the JAX package on
the CPU: the lattice, and 100 RK4 and explicit-midpoint steps of the
benchmark's dt through its band-limited field to 1e-6 (relative and
absolute: float32, the same operations in the same order), and the
micro-benchmark's shape on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu.rays import ray1d as jr1  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import ray1d  # noqa: E402

L = 2 * np.pi


def test_init_rays1d_matches_jax():
    got = ray1d.init_rays1d(33, L, 1.5, device="cpu")
    ref = jr1.init_rays1d(33, L, 1.5)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("method", ["rk4", "midpoint"])
@pytest.mark.parametrize("n", [7, 256])
def test_raytrace1d_matches_jax(method, n):
    u, ux = ray1d.benchmark_field(64)
    rays = ray1d.init_rays1d(n, L, device="cpu")
    got = ray1d.raytrace1d(rays, torch.as_tensor(u, dtype=torch.float32),
                           torch.as_tensor(ux, dtype=torch.float32), 1e-3, 100, L, method)
    ref = jr1.raytrace1d(jr1.init_rays1d(n, L), jnp.asarray(u, jnp.float32),
                         jnp.asarray(ux, jnp.float32), 1e-3, 100, L, method)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert np.abs(got.x.numpy() - rays.x.numpy()).max() > 0.05


def test_raytrace1d_rejects_unknown_method():
    rays = ray1d.init_rays1d(4, device="cpu")
    with pytest.raises(ValueError):
        ray1d.raytrace1d(rays, rays.x, rays.x, 1e-3, 1, L, "euler")


def test_benchmark_integrators_on_the_cpu():
    out = ray1d.benchmark_integrators(n_packets=64, nx=32, nsteps=5, device="cpu")
    assert set(out) == {"rk4", "midpoint"} and all(t > 0 for t in out.values())
