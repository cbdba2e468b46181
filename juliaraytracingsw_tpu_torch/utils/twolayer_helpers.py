"""Two-layer QG experiment helpers (port of ``utils/twolayer_helpers.py``):
reload a two-layer state from an initial-condition file and report
predicted against actual energetics with the Thompson-Young halting-scale
scaling

    l* = 3.2 exp(0.36 / kappa*),   kappa* = mu U / lambda,   V = U l*

(its inverse gives the drag mu for a target l*).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "thompson_young_scales", "mu_from_target_scale", "display_energetics",
    "load_two_layer_state",
]

TY_C1, TY_C2 = 3.2, 0.36


def thompson_young_scales(U: float, lam: float, mu: float) -> dict:
    """kappa*, l*, l = l* lambda, eddy velocity V and predicted KE ~ V^2."""
    kappa_star = mu * U / lam if lam > 0 else np.inf
    ell_star = TY_C1 * np.exp(TY_C2 / kappa_star)
    V = U * ell_star
    return {
        "kappa_star": kappa_star,
        "ell_star": ell_star,
        "ell": ell_star * lam,
        "V": V,
        "KE_pred": V * V,
    }


def mu_from_target_scale(ell_star: float, U: float, lam: float) -> float:
    """The drag mu whose halting scale is ``ell_star``:
    kappa* = c2 / log(l*/c1)."""
    kappa_star = TY_C2 / np.log(ell_star / TY_C1)
    return kappa_star * lam / U


def display_energetics(ke1: float, ke2: float, U: float, lam: float,
                       mu: float, log=print) -> dict:
    s = thompson_young_scales(U, lam, mu)
    log(f"lambda: {lam:.5f}  kappa*: {s['kappa_star']:.5f}  "
        f"ell*: {s['ell_star']:.5f}  V: {s['V']:.5f}")
    log(f"pred KE: {s['KE_pred']:.5f}  top KE: {ke1:.5f}  "
        f"bot KE: {ke2:.5f}  tot: {ke1 + ke2:.5f}")
    return s


def load_two_layer_state(path: str, grid, params, key: str = "ic/psih") -> torch.Tensor:
    """The PV state ``(2, nl, nkr)`` on the grid's device from the psih
    stored at ``key`` of an initial-condition file (this package's, the
    JAX package's or the reference's JLD2)."""
    from ..io.jld2 import load_array
    from ..models.twolayerqg import pv_from_streamfunction

    psih = np.asarray(load_array(path, key)).astype(np.complex64)
    return pv_from_streamfunction(torch.as_tensor(psih, device=grid.device), grid, params)
