"""Wave-packet ensembles as structure-of-arrays (port of ``rays/packets.py``).

Packets are a NamedTuple of 1-D tensors [x, y, k, l, sign], float32 unless
asked.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Packets", "lattice_packets", "packets_to_array", "packets_from_array"]


class Packets(NamedTuple):
    x: torch.Tensor     # (N,) position x
    y: torch.Tensor     # (N,) position y
    k: torch.Tensor     # (N,) wavenumber x-component
    l: torch.Tensor     # (N,) wavenumber y-component
    sign: torch.Tensor  # (N,) +/-1 branch of the dispersion relation

    @property
    def n(self) -> int:
        return self.x.shape[0]


def lattice_packets(
    sqrt_npackets: int,
    Lx: float,
    Ly: float,
    k0: float,
    alternate_sign: bool = True,
    k_ring: bool = False,
    dtype: torch.dtype = torch.float32,
    x0: float | None = None,
    y0: float | None = None,
    *,
    device: torch.device | str = "cuda",
) -> Packets:
    """Uniform sqrtN x sqrtN lattice of packets with |k| = k0 and
    alternating +/- branches; with ``k_ring`` packet j's wavevector points
    at phase 2 pi j/N around the ring of radius k0, otherwise k = (k0, 0)."""
    n = sqrt_npackets
    x0 = -Lx / 2.0 if x0 is None else x0
    y0 = -Ly / 2.0 if y0 is None else y0
    xs = x0 + (np.arange(n) + 0.5) * (Lx / n)
    ys = y0 + (np.arange(n) + 0.5) * (Ly / n)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    N = n * n
    if alternate_sign:
        S = np.where(np.arange(N) % 2 == 0, -1.0, 1.0)
    else:
        S = np.ones((N,))
    if k_ring:
        phase = 2.0 * np.pi * np.arange(1, N + 1) / N
        kx = k0 * np.cos(phase)
        ky = k0 * np.sin(phase)
    else:
        kx = np.full((N,), k0)
        ky = np.zeros((N,))

    np_dtype = torch.empty((), dtype=dtype).numpy().dtype

    def real(a):
        return torch.as_tensor(np.asarray(a, np_dtype).reshape(N), device=device)

    return Packets(x=real(X), y=real(Y), k=real(kx), l=real(ky), sign=real(S))


def packets_to_array(p: Packets) -> torch.Tensor:
    """(N, 4) [x y k l] view for I/O parity with the reference layout."""
    return torch.stack([p.x, p.y, p.k, p.l], dim=1)


def packets_from_array(arr: torch.Tensor, sign: torch.Tensor) -> Packets:
    return Packets(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3], sign)
