"""Carry a coupled simulation state across as numpy arrays.

The keys are the reference ``SimState``'s fields: ``sol``, ``clock.t``,
``clock.step``, ``stepper_state.N1``, ``stepper_state.N2``, ``packets.x``,
``packets.y``, ``packets.k``, ``packets.l``, ``packets.sign`` and
``fields``. ``sim_state_to_numpy`` reads any object with that structure
whose leaves ``np.asarray`` understands (so also the JAX package's state,
without importing JAX here) as well as this package's tensors;
``sim_state_from_numpy`` builds this package's ``SimState`` on a device.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.steppers import AB3State, Clock
from .coupled.driver import SimState
from .rays.packets import Packets

__all__ = ["sim_state_to_numpy", "sim_state_from_numpy"]

_PACKET_FIELDS = ("x", "y", "k", "l", "sign")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def sim_state_to_numpy(sim) -> dict:
    """Flatten a SimState (this package's or the reference's) to numpy."""
    if getattr(sim, "bd", None) is not None:
        raise NotImplementedError(
            "birth/death state is not carried across (ROADMAP queue 1, item 16)")
    d = {
        "sol": _np(sim.sol),
        "clock.t": _np(sim.clock.t),
        "clock.step": _np(sim.clock.step),
        "stepper_state.N1": _np(sim.stepper_state.N1),
        "stepper_state.N2": _np(sim.stepper_state.N2),
        "fields": _np(sim.fields),
    }
    for name in _PACKET_FIELDS:
        d[f"packets.{name}"] = _np(getattr(sim.packets, name))
    return d


def sim_state_from_numpy(d: dict, *, device: torch.device | str = "cpu") -> SimState:
    """Build this package's SimState (IF-AB3 stepper state) on ``device``."""

    def t(key, dtype):
        return torch.as_tensor(np.array(d[key], dtype, copy=True), device=device)

    return SimState(
        sol=t("sol", np.complex64),
        clock=Clock(t("clock.t", np.float32).reshape(()), int(d["clock.step"])),
        stepper_state=AB3State(t("stepper_state.N1", np.complex64),
                               t("stepper_state.N2", np.complex64)),
        packets=Packets(*(t(f"packets.{n}", np.float32) for n in _PACKET_FIELDS)),
        fields=t("fields", np.float32),
    )
