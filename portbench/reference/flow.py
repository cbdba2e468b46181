"""The reference flows: the spectral grid, f-plane rotating shallow water
and equal-depth two-layer QG, stepped by IF-AB3.

Conventions (JuliaRaytracingSW's, FourierFlows'): physical fields
``(..., ny, nx)``, spectra ``(..., ny, nx//2 + 1)`` with numpy's FFT
normalisation, the square 2/3 rule on both transforms of the nonlinear
term. IF-AB3 with linear operator L per mode::

    N    = N(sol)
    sol' = e^{L dt} (sol + dt (23/12 N - 16/12 e^{L dt} N_1 + 5/12 e^{2 L dt} N_2))

with forward Euler inside the integrating factor for the first three
steps. The exponentials are worked out here, by ``torch.linalg.matrix_exp``
in complex128 over the per-mode blocks of L rounded to complex64.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from . import Prec

__all__ = ["grid", "rsw_L", "rsw_N", "rsw_psih", "twolayer_L", "twolayer_N",
           "twolayer_psih", "expm_pair", "apply_block", "ifab3_step", "fields", "Flow"]

AB3 = (23.0 / 12.0, 16.0 / 12.0, 5.0 / 12.0)


def grid(n: int, L: float, device) -> SimpleNamespace:
    """A square n x n grid of side L: float64 wavenumbers rounded once to
    float32, the dealiasing mask, i k and i l."""
    nkr = n // 2 + 1
    f64 = dict(dtype=torch.float64, device=device)
    kr = 2.0 * math.pi / L * torch.arange(nkr, **f64)
    ell = 2.0 * math.pi / L * torch.fft.fftfreq(n, d=1.0 / n, **f64)
    K2 = ell[:, None] ** 2 + kr[None, :] ** 2
    cut = (1.0 - 1.0 / 3.0) * (n // 2)
    ix = torch.arange(nkr, **f64)
    iy = torch.fft.fftfreq(n, d=1.0 / n, **f64).abs()
    mask = ((ix[None, :] <= cut) & (iy[:, None] <= cut)).float()
    kr32, l32 = kr.float(), ell.float()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return SimpleNamespace(
        n=n, L=L, dx=L / n, x0=-L / 2.0, kr64=kr, l64=ell, K2_64=K2, K2=K2.float(),
        invK2=torch.where(K2 > 0, 1.0 / torch.where(K2 > 0, K2, 1.0), 0.0).float(),
        mask=mask, ik=torch.complex(zero.expand_as(kr32), kr32)[None, :],
        il=torch.complex(zero.expand_as(l32), l32)[:, None])


def _irfft2(h, g):
    return torch.fft.irfft2(h, s=(g.n, g.n), dim=(-2, -1))


def _rfft2(x):
    return torch.fft.rfft2(x, dim=(-2, -1))


def expm_pair(L64: torch.Tensor, dt: float):
    """(exp(L dt), exp(2 L dt)) as complex64 ``(C, C, ny, nkr)`` from
    ``(C, C, ny, nkr)`` complex128 blocks, rounded to complex64 first, as
    the configuration states L."""
    L = L64.to(torch.complex64).to(torch.complex128).permute(2, 3, 0, 1)
    out = []
    for scale in (dt, 2.0 * dt):
        e = torch.linalg.matrix_exp(L * scale)
        out.append(e.permute(2, 3, 0, 1).to(torch.complex64).contiguous())
    return tuple(out)


def apply_block(E: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(E x)_i = sum_j E_ij x_j per mode."""
    return sum(E[:, j] * x[j] for j in range(x.shape[0]))


def rsw_L(g, nu: float, nnu: int, f: float, Cg2: float) -> torch.Tensor:
    """(3, 3) blocks over (u, v, eta): rotation, pressure gradient,
    divergence and hyperviscosity -nu K^(2 nnu) on the diagonal."""
    D = -nu * g.K2_64 ** nnu
    kr = (g.kr64[None, :] * torch.ones_like(g.l64[:, None])).to(torch.complex128)
    ell = (g.l64[:, None] * torch.ones_like(g.kr64[None, :])).to(torch.complex128)
    Dc = D.to(torch.complex128)
    one = torch.ones_like(Dc)
    return torch.stack([
        torch.stack([Dc, f * one, -1j * kr * Cg2]),
        torch.stack([-f * one, Dc, -1j * ell * Cg2]),
        torch.stack([-1j * kr, -1j * ell, Dc]),
    ])


def rsw_N(sol, g, p: Prec):
    """-(u.grad) u, -(u.grad) v, -div(eta u) with the 2/3 rule on both
    transforms."""
    u_h, v_h, e_h = sol[0], sol[1], sol[2]
    spec = torch.stack([u_h, v_h, e_h, g.ik * u_h, g.il * u_h, g.ik * v_h, g.il * v_h])
    u, v, eta, ux, uy, vx, vy = p.r(_irfft2(spec * g.mask, g)).unbind(0)
    prods = p.r(torch.stack([u * ux + v * uy, u * vx + v * vy, eta * u, eta * v]))
    ph = p.r(_rfft2(prods) * g.mask)
    return p.r(torch.stack([-ph[0], -ph[1], -(g.ik * ph[2] + g.il * ph[3])]))


def rsw_psih(sol, g, f: float, Cg: float):
    """The advecting streamfunction of an RSW state: PV inversion."""
    q = g.ik * sol[1] - g.il * sol[0] - f * sol[2]
    return -q / (g.K2 + f * f / (Cg * Cg))


def twolayer_F(f0: float, Cg: float, drho_rho0: float) -> float:
    return 2.0 * f0 ** 2 / Cg ** 2 / drho_rho0


def _twolayer_psi(q, g, F):
    s = q[0] + q[1]
    p1 = -(g.K2 * q[0] + F * s)
    p2 = -(g.K2 * q[1] + F * s)
    return torch.stack([p1, p2]) * (g.invK2 / (g.K2 + 2.0 * F))


def twolayer_L(g, U: float, mu: float, nu: float, nnu: int, F: float) -> torch.Tensor:
    """(2, 2) blocks over (q1, q2): mean-flow advection -+ i k U, the
    mean PV gradients -+ 2 i k F U psi_j, bottom drag mu K^2 psi_2 and
    hyperviscosity, with psi = S^-1 q."""
    kr = g.kr64[None, :]
    K2 = g.K2_64
    K2inv = torch.where(K2 > 0, 1.0 / torch.where(K2 > 0, K2, 1.0), 0.0)
    D = -nu * K2 ** nnu
    den = K2inv / (K2 + 2.0 * F)
    S00 = (-K2 - F) * den
    S01 = -F * den
    c1 = -2j * kr * F * U * torch.ones_like(K2)
    c2 = 2j * kr * F * U + mu * K2
    return torch.stack([
        torch.stack([c1 * S00 + (-1j * kr * U) + D, c1 * S01]),
        torch.stack([c2 * S01, c2 * S00 + (1j * kr * U) + D]),
    ])


def twolayer_N(q, g, F: float, p: Prec):
    """-J(psi_j, q_j) in flux form for each layer, 2/3 rule both ways."""
    psi = _twolayer_psi(q, g, F)
    phys = p.r(_irfft2(torch.cat([q, g.ik * psi, g.il * psi]) * g.mask, g))
    qq, psix, psiy = phys[0:2], phys[2:4], phys[4:6]
    ph = p.r(_rfft2(p.r(torch.cat([psix * qq, psiy * qq]))) * g.mask)
    return p.r(-g.il * ph[0:2] + g.ik * ph[2:4])


def twolayer_psih(q, g, F: float):
    """The barotropic streamfunction (psi_1 + psi_2) / 2."""
    psi = _twolayer_psi(q, g, F)
    return 0.5 * (psi[0] + psi[1])


def ifab3_step(sol, step: int, N1, N2, E1, E2, N_fn, dt: float, p: Prec):
    """One IF-AB3 step -> (sol', N, N1): the new history is (N, N1)."""
    N = N_fn(sol)
    if step < 3:
        new = apply_block(E1, p.r(sol + dt * N))
    else:
        incr = dt * (AB3[0] * N - AB3[1] * apply_block(E1, N1) + AB3[2] * apply_block(E2, N2))
        new = apply_block(E1, p.r(sol + p.r(incr)))
    return p.r(new), N, N1


def fields(psih, g) -> torch.Tensor:
    """(5, ny, nx) [u, v, u_x, u_y, v_x] of a streamfunction, no
    dealiasing (u = -psi_y, v = psi_x)."""
    uh = -g.il * psih
    vh = g.ik * psih
    return _irfft2(torch.stack([uh, vh, g.ik * uh, g.il * uh, g.ik * vh]), g)


class Flow:
    """A configuration's flow: its grid, its N, its psi and its tables.
    ``cfg`` is the configuration file's dict."""

    def __init__(self, cfg: dict, device, dt: float, nu: float):
        self.cfg, self.dt = cfg, dt
        fl = cfg["flow"]
        self.g = grid(cfg["nx"], cfg["L"], device)
        if fl["model"] == "rsw":
            self.f, self.Cg = fl["f"], fl["Cg"]
            L = rsw_L(self.g, nu, fl["nnu"], self.f, self.Cg ** 2)
            self._N = rsw_N
            self._psih = lambda s: rsw_psih(s, self.g, self.f, self.Cg)
        elif fl["model"] == "twolayerqg":
            self.F = twolayer_F(fl["f"], fl["Cg"], fl["drho_rho0"])
            L = twolayer_L(self.g, fl["U"], fl["mu"], nu, fl["nnu"], self.F)
            self._N = lambda s, g, p: twolayer_N(s, g, self.F, p)
            self._psih = lambda s: twolayer_psih(s, self.g, self.F)
        else:
            raise ValueError(f"no reference for the flow model {fl['model']!r}")
        self.E1, self.E2 = expm_pair(L, dt)

    def psih(self, sol):
        return self._psih(sol)

    def fields(self, sol):
        return fields(self.psih(sol), self.g)

    def step(self, sol, step: int, N1, N2, p: Prec):
        return ifab3_step(sol, step, N1, N2, self.E1, self.E2,
                          lambda s: self._N(s, self.g, p), self.dt, p)
