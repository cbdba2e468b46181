"""Slab-decomposed 2-D real FFT over a process mesh (port of the slab
path of ``parallel/fft.py``).

A physical field is held in y-slabs, ``(C, ny/P, nx)`` a rank; the
transform is

    local rfft over x  ->  all_to_all transpose  ->  local fft over y

and leaves the spectrum in kr-columns, ``(C, nl, nkr_pad/P)`` a rank; the
inverse runs the pipeline backwards. The odd rfft length ``nkr = nx//2 +
1`` is zero-padded to ``nkr_pad``, a multiple of the mesh size, before the
transpose, and cropped after it, so the pad columns are exactly zero.
The local transforms are ``torch.fft`` (cuFFT on the card); the
transpose is one ``all_to_all_single`` (NCCL or gloo,
``parallel/mesh.all_to_all``).

- ``local_rfft2`` / ``local_irfft2``: the per-rank pieces, which the
  sharded models compose with their local physics (``parallel/sharded``);
- ``slab_rfft2`` / ``slab_irfft2``: the standalone transforms of a rank's
  slab or column block;
- ``slab_sharding_physical`` / ``slab_sharding_spectral``: the two
  layouts, as ``parallel/mesh.Sharding`` descriptors.

The reference's dense-DFT pieces (``_dense_*``, a TPU backend) have no
counterpart here.
"""
from __future__ import annotations

import torch

from .mesh import Mesh, Sharding, all_to_all

__all__ = ["slab_rfft2", "slab_irfft2", "slab_sharding_physical",
           "slab_sharding_spectral", "local_rfft2", "local_irfft2", "padded_nkr"]


def padded_nkr(nx: int, nproc: int) -> int:
    """rfft length nx//2+1 zero-padded up to a multiple of the mesh size."""
    nkr = nx // 2 + 1
    return ((nkr + nproc - 1) // nproc) * nproc


def slab_sharding_physical(mesh: Mesh) -> Sharding:
    """(C, ny, nx) in y-slabs."""
    return Sharding(mesh, -2)


def slab_sharding_spectral(mesh: Mesh) -> Sharding:
    """(C, nl, nkr_pad) in kr-columns."""
    return Sharding(mesh, -1)


def local_rfft2(f: torch.Tensor, nkr_pad: int, mesh: Mesh) -> torch.Tensor:
    """(..., ny/P, nx) y-slab -> (..., nl, nkr_pad/P) kr-column block."""
    fh = torch.fft.rfft(f, dim=-1)
    fh = torch.nn.functional.pad(fh, (0, nkr_pad - fh.shape[-1]))
    fh = all_to_all(fh, split_dim=-1, concat_dim=-2, mesh=mesh)
    return torch.fft.fft(fh, dim=-2)


def local_irfft2(fh: torch.Tensor, nx: int, mesh: Mesh) -> torch.Tensor:
    """(..., nl, nkr_pad/P) kr-column block -> (..., ny/P, nx) y-slab."""
    f = torch.fft.ifft(fh, dim=-2)
    f = all_to_all(f, split_dim=-2, concat_dim=-1, mesh=mesh)
    return torch.fft.irfft(f[..., : nx // 2 + 1], n=nx, dim=-1)


def slab_rfft2(field: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The rank's y-slab of a (C, ny, nx) field -> its kr-column block of
    the (C, nl, nkr_pad) spectrum (crop the gathered spectrum with
    ``[..., :nkr]``)."""
    return local_rfft2(field, padded_nkr(field.shape[-1], mesh.size), mesh)


def slab_irfft2(spech: torch.Tensor, nx: int, mesh: Mesh) -> torch.Tensor:
    """Inverse of ``slab_rfft2``: the rank's kr-column block -> its y-slab."""
    return local_irfft2(spech, nx, mesh)
