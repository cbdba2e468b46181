"""General n-layer quasi-geostrophic model (port of
``models/multilayerqg.py``, the counterpart of GeophysicalFlows'
``MultiLayerQG``).

Layer PVs q_j with background zonal flows U_j, beta and bottom drag mu:

    dq_j/dt + J(psi_j, q_j) + U_j dq_j/dx + Q_jy dpsi_j/dx
        = -delta_{jn} mu del^2 psi_n - nu (-del^2)^{n_nu} q_j

    q = (-K^2 I + A) psi per mode, A the tridiagonal stretching coupling,
    Q_y = beta - A U.

State ``(n, nl, nkr)``. The per-mode n x n stretching inverse and the
block L ``(n, n, nl, nkr)`` are computed on the host in float64; the
inverse is applied as an elementwise multiply and a sum over the input
layer. The defaults are the equal-depth two-layer configuration.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..core.spectral import irfft2_dealiased, parseval_sum, rfft2_dealiased
from .base import Model

__all__ = ["MultiLayerParams", "make_model", "build_L", "two_layer_defaults",
           "streamfunction_from_pv", "pv_from_streamfunction",
           "kinetic_energy", "potential_energy"]


@dataclass(frozen=True)
class MultiLayerParams:
    nlayers: int
    U: tuple            # per-layer background zonal velocity
    beta: float
    mu: float           # bottom drag
    nu: float
    nnu: int
    Fcoup: tuple        # coupling F_{j+1/2} per interface (n - 1)
    delta: tuple        # layer depth fractions H_j / H (n)


def _stretching_matrix(params: MultiLayerParams) -> np.ndarray:
    """A (n x n), float64: q_j = -K^2 psi_j + (A psi)_j, layer j coupled to
    j+1 by F_{j+1/2}/delta_j and j+1 to j by F_{j+1/2}/delta_{j+1}."""
    n = params.nlayers
    A = np.zeros((n, n))
    for j in range(n - 1):
        Fj = params.Fcoup[j]
        A[j, j] -= Fj / params.delta[j]
        A[j, j + 1] += Fj / params.delta[j]
        A[j + 1, j + 1] -= Fj / params.delta[j + 1]
        A[j + 1, j] += Fj / params.delta[j + 1]
    return A


def _host_arrays(grid):
    kr = grid.kr.cpu().numpy().astype(np.float64)[None, :]
    K2 = grid.Krsq.cpu().numpy().astype(np.float64)
    return kr, K2


def _sinv(grid, params: MultiLayerParams) -> np.ndarray:
    """(n, n, nl, nkr) float64 inverse of S = -K^2 I + A per mode; zero at
    K = 0."""
    n = params.nlayers
    _, K2 = _host_arrays(grid)
    S = -K2[..., None, None] * np.eye(n) + _stretching_matrix(params)  # (nl, nkr, n, n)
    S[0, 0] = np.eye(n)  # keeps the mean mode invertible
    Sinv = np.linalg.inv(S)
    Sinv[0, 0] = 0.0
    return np.transpose(Sinv, (2, 3, 0, 1))


def build_L(grid, params: MultiLayerParams, Sinv: np.ndarray | None = None) -> torch.Tensor:
    """(n, n, nl, nkr) complex64 linear operator on the grid's device:
    the psi coefficient of each layer row (-i k Qy_j, plus mu K^2 on layer
    n) times S^{-1}, plus diag(-i k U_j + D)."""
    n = params.nlayers
    kr, K2 = _host_arrays(grid)
    if Sinv is None:
        Sinv = _sinv(grid, params)
    U = np.asarray(params.U, np.float64)
    Qy = params.beta - _stretching_matrix(params) @ U
    D = -params.nu * K2 ** params.nnu

    coef = np.zeros((n,) + K2.shape, np.complex128)
    for j in range(n):
        coef[j] = -1j * kr * Qy[j] * np.ones_like(K2)
    coef[n - 1] += params.mu * K2
    L = np.zeros((n, n) + K2.shape, np.complex128)
    for j in range(n):
        for m in range(n):
            L[j, m] = coef[j] * Sinv[j, m]
        L[j, j] += -1j * kr * U[j] + D
    return torch.as_tensor(L.astype(np.complex64), device=grid.device)


def two_layer_defaults(nx=128, U=0.5, mu=1e-2, nu=1e-6, nnu=4, f0=3.0, Cg=1.0,
                       drho_rho0=0.2) -> dict:
    """``make_model`` keywords that reproduce ``twolayerqg``'s
    F = 2 f0^2/(Cg^2 drho/rho0) for equal layers (coupling F/2)."""
    F = 2.0 * f0**2 / Cg**2 / drho_rho0
    return dict(U=(U, -U), beta=0.0, mu=mu, nu=nu, nnu=nnu,
                Fcoup=(F / 2.0,), delta=(0.5, 0.5))


def _mix(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sum_b M[a, b, ...] x[b, ...]: the per-mode layer contraction."""
    return (M * x.unsqueeze(0)).sum(1)


def make_model(
    grid,
    U: Sequence[float] = (0.5, -0.5),
    beta: float = 0.0,
    mu: float = 1e-2,
    nu: float = 1e-6,
    nnu: int = 4,
    Fcoup: Sequence[float] = (9.0,),
    delta: Sequence[float] | None = None,
) -> Model:
    n = len(U)
    if delta is None:
        delta = tuple(1.0 / n for _ in range(n))
    params = MultiLayerParams(
        nlayers=n, U=tuple(float(u) for u in U), beta=float(beta),
        mu=float(mu), nu=float(nu), nnu=int(nnu),
        Fcoup=tuple(float(f) for f in Fcoup), delta=tuple(float(d) for d in delta),
    )
    Sinv = _sinv(grid, params)
    # real, rounded to float32 once: the same values as the JAX package's
    # complex64 table
    Sinv_t = torch.as_tensor(Sinv.astype(np.float32), device=grid.device)
    L = build_L(grid, params, Sinv)

    def psi_from_q(qh):
        return _mix(Sinv_t, qh)

    def calcN(solh, t):
        psih = psi_from_q(solh)
        ik, il = grid.ik, grid.il
        phys = irfft2_dealiased(torch.cat([solh, ik * psih, il * psih]), grid)
        q, psix, psiy = phys[0:n], phys[n:2 * n], phys[2 * n:3 * n]
        prodh = rfft2_dealiased(torch.cat([psix * q, psiy * q]), grid)
        return -il * prodh[0:n] + ik * prodh[n:2 * n]

    return Model(name="multilayerqg", grid=grid, params=params, L=L, calcN=calcN,
                 nfields=n, extras={"psi_from_q": psi_from_q})


def streamfunction_from_pv(qh, grid, params: MultiLayerParams):
    """S^{-1} q, with S^{-1} rounded to float32 as the JAX package does; it
    inverts every mode's matrix on the host at each call (a model's
    ``extras["psi_from_q"]`` holds the table)."""
    Sinv = torch.as_tensor(_sinv(grid, params).astype(np.float32), device=qh.device)
    return _mix(Sinv, qh)


def pv_from_streamfunction(psih, grid, params: MultiLayerParams):
    A = torch.as_tensor(_stretching_matrix(params).astype(np.float32), device=psih.device)
    return -grid.Krsq * psih + torch.einsum("ab,b...->a...", A.to(psih.dtype), psih)


def kinetic_energy(qh, grid, params: MultiLayerParams, psih=None):
    """Per-layer depth-weighted KE (GeophysicalFlows' convention); ``psih``
    is ``qh``'s streamfunction where the caller has it."""
    if psih is None:
        psih = streamfunction_from_pv(qh, grid, params)
    ke = parseval_sum(grid.Krsq * psih.abs() ** 2, grid) / (grid.Lx * grid.Ly)
    return tuple(0.5 * params.delta[j] * ke[j] for j in range(params.nlayers))


def potential_energy(qh, grid, params: MultiLayerParams, psih=None):
    """Per-interface APE F/2 <|psi_j - psi_{j+1}|^2>; ``psih`` as in
    ``kinetic_energy``."""
    if psih is None:
        psih = streamfunction_from_pv(qh, grid, params)
    return tuple(
        0.5 * params.Fcoup[j]
        * parseval_sum((psih[j] - psih[j + 1]).abs() ** 2, grid)
        / (grid.Lx * grid.Ly)
        for j in range(params.nlayers - 1))
