"""Linborg shallow-water variant (port of ``models/linborg.py``): the
advecting velocity of the momentum equations is the rotational
(divergence-free) part of the flow, from the vorticity streamfunction. The
linear operator is full RSW's."""
from __future__ import annotations

from .base import Model
from .rsw import RSWParams, _advection_N, build_L

__all__ = ["make_model"]


def make_model(grid, nu=1e-16, nnu=4, f=1.0, Cg=1.0, forcing=None) -> Model:
    """``forcing(sol, t) -> Fh``: an optional additive spectral forcing."""
    params = RSWParams(nu=float(nu), nnu=int(nnu), f=float(f), Cg2=float(Cg) ** 2)
    L = build_L(grid, params)

    def calcN(solh, t):
        N = _advection_N(solh, grid, rotational_only=True)
        if forcing is not None:
            N = N + forcing(solh, t)
        return N

    return Model(name="linborg_sw", grid=grid, params=params, L=L, calcN=calcN, nfields=3)
