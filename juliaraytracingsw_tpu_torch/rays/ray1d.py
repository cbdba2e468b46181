"""1-D ray tracing and its integrator micro-benchmark (port of
``rays/ray1d.py``).

The 1-D analogue of the reference's packet benchmark
(raytracing/JuliaRaytracing1D.jl): structure-of-arrays packets over a 1-D
periodic velocity field u(x), omega = sqrt(1 + k^2), dx/dt = u + c_g,
dk/dt = -u_x k, stepped by fixed RK4 or explicit midpoint substeps
through a frozen field. The smallest end-to-end exercise of a ray stack:
a throughput canary and the on-ramp for new integrators.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Rays1D", "init_rays1d", "raytrace1d", "benchmark_field", "benchmark_integrators"]


class Rays1D(NamedTuple):
    x: torch.Tensor  # (N,) positions
    k: torch.Tensor  # (N,) wavenumbers


def init_rays1d(n: int, L: float = 2 * np.pi, k0: float = 1.0,
                dtype: torch.dtype = torch.float32, *,
                device: torch.device | str = "cuda") -> Rays1D:
    """Uniform packet lattice with k = k0."""
    x = (np.arange(n) + 0.5) * (L / n) - L / 2
    return Rays1D(x=torch.as_tensor(x, dtype=dtype, device=device),
                  k=torch.full((n,), k0, dtype=dtype, device=device))


def _interp1d_periodic(field: torch.Tensor, xq: torch.Tensor, L: float) -> torch.Tensor:
    """Linear periodic interpolation on a uniform 1-D grid."""
    n = field.shape[0]
    s = (xq % L) / L * n
    i0 = torch.floor(s)
    a = s - i0
    i0 = i0.long()
    f0 = field[i0 % n]
    f1 = field[(i0 + 1) % n]
    return f0 + a * (f1 - f0)


def _rhs1d(r: Rays1D, u, ux, L) -> Rays1D:
    """dx/dt = u + dw/dk, dk/dt = -u_x k with omega = sqrt(1 + k^2)."""
    uq = _interp1d_periodic(u, r.x, L)
    uxq = _interp1d_periodic(ux, r.x, L)
    cg = r.k / torch.sqrt(1.0 + r.k * r.k)
    return Rays1D(x=uq + cg, k=-uxq * r.k)


def _axpy(r: Rays1D, d: Rays1D, h: float) -> Rays1D:
    return Rays1D(x=r.x + h * d.x, k=r.k + h * d.k)


def raytrace1d(rays: Rays1D, u: torch.Tensor, ux: torch.Tensor, dt: float, nsteps: int,
               L: float, method: str = "rk4") -> Rays1D:
    """Integrate the 1-D ray equations through a frozen field: ``nsteps``
    steps of ``dt``, ``method`` 'rk4' or 'midpoint'."""
    if method not in ("rk4", "midpoint"):
        raise ValueError(method)
    r = rays
    for _ in range(nsteps):
        if method == "rk4":
            k1 = _rhs1d(r, u, ux, L)
            k2 = _rhs1d(_axpy(r, k1, dt / 2), u, ux, L)
            k3 = _rhs1d(_axpy(r, k2, dt / 2), u, ux, L)
            k4 = _rhs1d(_axpy(r, k3, dt), u, ux, L)
            r = Rays1D(x=r.x + dt / 6 * (k1.x + 2 * k2.x + 2 * k3.x + k4.x),
                       k=r.k + dt / 6 * (k1.k + 2 * k2.k + 2 * k3.k + k4.k))
        else:
            half = _rhs1d(r, u, ux, L)
            mid = _rhs1d(_axpy(r, half, dt / 2), u, ux, L)
            r = _axpy(r, mid, dt)
    return r


def benchmark_field(nx: int = 512, L: float = 2 * np.pi):
    """The benchmark's random band-limited field (u, u_x) on ``nx`` points,
    as float64 numpy arrays (seed 0, modes 1-5)."""
    rng = np.random.default_rng(0)
    x = np.linspace(0, L, nx, endpoint=False)
    u = np.zeros(nx)
    for m in range(1, 6):
        u += rng.normal() * np.cos(m * x) + rng.normal() * np.sin(m * x)
    return u, np.gradient(u, x)


def benchmark_integrators(n_packets: int = 4096, nx: int = 512, nsteps: int = 1000,
                          dt: float = 1e-3, methods: tuple = ("rk4", "midpoint"), *,
                          device: torch.device | str = "cuda") -> dict:
    """Seconds of ``nsteps`` steps of ``n_packets`` rays through the random
    band-limited field, per method, after one warm-up call: CUDA events on
    the card, the host clock on the CPU."""
    device = torch.device(device)
    L = 2 * np.pi
    u, ux = benchmark_field(nx, L)
    uj = torch.as_tensor(u, dtype=torch.float32, device=device)
    uxj = torch.as_tensor(ux, dtype=torch.float32, device=device)
    rays = init_rays1d(n_packets, L, device=device)
    out = {}
    for method in methods:
        raytrace1d(rays, uj, uxj, dt, nsteps, L, method)    # warm-up
        if device.type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            raytrace1d(rays, uj, uxj, dt, nsteps, L, method)
            end.record()
            end.synchronize()
            out[method] = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            raytrace1d(rays, uj, uxj, dt, nsteps, L, method)
            out[method] = time.perf_counter() - t0
    return out
