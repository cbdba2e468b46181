"""Model container and the stepper registry (port of ``models/base.py``).

A model is a plain container of functions and tensors: ``L`` (per-mode
linear operator, diagonal or ``(C, C, nl, nkr)`` blocks), ``calcN`` (the
nonlinear pseudo-spectral right-hand side ``(sol, t) -> N``) and extras.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..core import steppers as _steppers
from ..core.filters import make_filter
from ..core.steppers import Clock

__all__ = ["Model", "build_stepper", "run", "STEPPERS"]


@dataclass(frozen=True)
class Model:
    """A spectral PDE model on a 2-D periodic grid."""

    name: str
    grid: Any
    params: Any
    L: torch.Tensor
    calcN: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    nfields: int
    extras: dict = field(default_factory=dict)


# the reference drivers' vocabulary; its ETDAB3 is the same scheme as IFMAB3
STEPPERS = {
    "IFMAB3": _steppers.make_ifab3,
    "ETDAB3": _steppers.make_ifab3,
    "IFRK4": _steppers.make_ifrk4,
    "ETDRK4": _steppers.make_etdrk4,
    "FilteredETDRK4": _steppers.make_etdrk4,
    "AB3": _steppers.make_filtered_ab3,
    "FilteredAB3": _steppers.make_filtered_ab3,
    "RK4": _steppers.make_filtered_rk4,
    "FilteredRK4": _steppers.make_filtered_rk4,
}

# these names filter whatever ``use_filter`` says
_ALWAYS_FILTERED = {"FilteredAB3", "FilteredRK4", "FilteredETDRK4"}


def build_stepper(
    model: Model,
    stepper: str = "IFMAB3",
    dt: float = 5e-2,
    use_filter: bool = False,
    filter_kwargs: dict | None = None,
):
    """Return ``(init_fn, step_fn)`` for the named stepper on this model."""
    try:
        factory = STEPPERS[stepper]
    except KeyError:
        raise ValueError(
            f"unknown stepper {stepper!r}; available: {sorted(STEPPERS)}"
        ) from None
    filt = None
    if use_filter or stepper in _ALWAYS_FILTERED:
        filt = make_filter(model.grid, **(filter_kwargs or {}))
    return factory(model.L, model.calcN, dt, filt)


def run(step_fn, sol, clock: Clock, state, nsteps: int, remat: bool = False):
    """Advance ``nsteps`` steps in a Python loop.

    ``remat=True`` checkpoints each step for the backward pass
    (``torch.utils.checkpoint``, the counterpart of the reference's
    ``jax.checkpoint`` of its scan body): a step keeps only its inputs and
    is recomputed when the gradient reaches it, so gradients through long
    horizons fit in device memory."""
    for _ in range(nsteps):
        if remat:
            sol, clock, state = checkpoint(step_fn, sol, clock, state, use_reentrant=False)
        else:
            sol, clock, state = step_fn(sol, clock, state)
    return sol, clock, state
