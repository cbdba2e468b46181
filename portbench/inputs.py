"""The benchmark's inputs, made on the device from the seed: the initial
flow and the packet ensemble. The same seed gives the same inputs, and
every seed gives the same sizes: the seed draws only random phases, the
lattice's offset and the wavevector ring's rotation.
"""
from __future__ import annotations

import math

import torch

from .reference.flow import grid as ref_grid

__all__ = ["generator", "initial_flow", "packets"]


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(gen, shape, device):
    return torch.rand(shape, generator=gen, dtype=torch.float64, device=device)


def _irfft2(h, n):
    return torch.fft.irfft2(h, s=(n, n), dim=(-2, -1))


def band_geo_wave(g, gen, Kg, Kw, ag, aw, f, Cg):
    """A balanced (geostrophic) part on the band Kg with amplitudes 1/omega,
    scaled to the largest speed ``ag``, plus linear waves on the band Kw,
    each mode on a random branch, scaled to ``aw``; one random phase a
    mode for both. Projected onto the real, dealiased spectra. Complex64
    ``(3, n, n//2 + 1)`` [uh, vh, etah]."""
    dev = g.K2.device
    K2, kr, ell = g.K2_64, g.kr64[None, :], g.l64[:, None]
    Cg2 = Cg * Cg
    om = torch.sqrt(f * f + Cg2 * K2)
    geo = (K2 >= Kg[0] ** 2) & (K2 <= Kg[1] ** 2) & (K2 > 0)
    wave = (K2 >= Kw[0] ** 2) & (K2 <= Kw[1] ** 2) & (K2 > 0)
    shift = torch.exp(2j * math.pi * _uniform(gen, K2.shape, dev))
    sgn = torch.sign(_uniform(gen, K2.shape, dev) - 0.5)
    zero = torch.zeros((), dtype=torch.complex128, device=dev)

    def scaled(uh, vh, hh, target):
        u, v = _irfft2(uh, g.n), _irfft2(vh, g.n)
        s = target / max(float(torch.sqrt(u * u + v * v).max()), 1e-30)
        return uh * s, vh * s, hh * s

    amp = 1.0 / om
    geo_part = scaled(torch.where(geo, -amp * 1j * Cg2 * ell * shift, zero),
                      torch.where(geo, amp * 1j * Cg2 * kr * shift, zero),
                      torch.where(geo, amp * f * shift, zero), ag)
    invK = torch.where(K2 > 0, 1.0 / torch.where(K2 > 0, K2, 1.0), 0.0)
    wamp = torch.sqrt(invK) / (2.0 * om)
    wave_part = scaled(
        torch.where(wave, wamp * (sgn * kr * om * shift + 1j * f * ell * shift), zero),
        torch.where(wave, wamp * (sgn * ell * om * shift - 1j * f * kr * shift), zero),
        torch.where(wave, wamp * K2 * shift, zero), aw)
    sol = torch.stack([a + b for a, b in zip(geo_part, wave_part)]).to(torch.complex64)
    return torch.fft.rfft2(_irfft2(sol * g.mask, g.n), dim=(-2, -1))


def band_layers(g, gen, Kg, ag, F):
    """Two layers of band-limited random streamfunction, each scaled to the
    largest |psi| = ``ag``, as potential vorticity q_j = -K^2 psi_j + F
    (psi_other - psi_j). Complex64 ``(2, n, n//2 + 1)``."""
    dev = g.K2.device
    K = torch.sqrt(g.K2_64)
    band = (K >= Kg[0]) & (K <= Kg[1])
    psih = []
    for _ in range(2):
        h = band * torch.exp(2j * math.pi * _uniform(gen, K.shape, dev))
        psi = _irfft2(h, g.n)
        psi = psi * (ag / max(float(psi.abs().max()), 1e-30))
        psih.append(torch.fft.rfft2(psi.float(), dim=(-2, -1)))
    p1, p2 = psih
    return torch.stack([-g.K2 * p1 + F * (p2 - p1), -g.K2 * p2 + F * (p1 - p2)])


def initial_flow(cfg: dict, seed: int, device) -> torch.Tensor:
    """The configuration's initial spectrum for ``seed``."""
    from .reference.flow import twolayer_F

    g = ref_grid(cfg["nx"], cfg["L"], device)
    gen = generator(seed, device)
    ic, fl = cfg["ic"], cfg["flow"]
    if ic["kind"] == "band_geo_wave":
        return band_geo_wave(g, gen, ic["Kg"], ic["Kw"], ic["ag"], ic["aw"], fl["f"], fl["Cg"])
    if ic["kind"] == "band_layers":
        return band_layers(g, gen, ic["Kg"], ic["ag"],
                           twolayer_F(fl["f"], fl["Cg"], fl["drho_rho0"]))
    raise ValueError(f"unknown initial condition {ic['kind']!r}")


def k0_of(cfg: dict) -> float:
    """The packets' injection wavenumber: omega0 = omega0_over_f f."""
    fl, pk = cfg["flow"], cfg["packets"]
    f = fl["f"]
    return math.sqrt((pk["omega0_over_f"] * f) ** 2 - f * f) / fl["Cg"]


def packets(cfg: dict, seed: int, device) -> torch.Tensor:
    """``(5, N)`` float32 [x, y, k, l, sign]: an n x n lattice offset by a
    random share of its spacing, |k| = k0 on a ring turned by a random
    angle, branches alternating -1, +1."""
    n, L = cfg["packets"]["sqrt_n"], cfg["L"]
    gen = generator(seed + 1, device)
    off = _uniform(gen, (2,), device)
    phi = float(_uniform(gen, (1,), device)[0]) * 2.0 * math.pi
    f64 = dict(dtype=torch.float64, device=device)
    xs = -L / 2.0 + (torch.arange(n, **f64) + off[0]) * (L / n)
    ys = -L / 2.0 + (torch.arange(n, **f64) + off[1]) * (L / n)
    Y, X = torch.meshgrid(ys, xs, indexing="ij")
    N = n * n
    j = torch.arange(N, **f64)
    phase = 2.0 * math.pi * (j + 1.0) / N + phi
    k0 = k0_of(cfg)
    sign = torch.where(j % 2 == 0, -1.0, 1.0).to(torch.float64)
    st = torch.stack([X.reshape(N), Y.reshape(N), k0 * torch.cos(phase),
                      k0 * torch.sin(phase), sign])
    return st.float().contiguous()
