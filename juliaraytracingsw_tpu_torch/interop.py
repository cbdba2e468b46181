"""Carry a coupled simulation state across as numpy arrays.

The keys are the reference ``SimState``'s fields: ``sol``, ``clock.t``,
``clock.step``, ``stepper_state.N1``, ``stepper_state.N2`` (the AB3
steppers' history; the one-step steppers keep none), ``packets.x``,
``packets.y``, ``packets.k``, ``packets.l``, ``packets.sign``,
``fields`` and, for a birth/death run, ``bd.age``, ``bd.lifetime``,
``bd.key`` (the PRNG key, two uint32 words) and ``bd.births`` (int32). ``sim_state_to_numpy`` reads any object with that structure
whose leaves ``np.asarray`` understands (so also the JAX package's state,
without importing JAX here) as well as this package's tensors;
``sim_state_from_numpy`` builds this package's ``SimState`` on a device, in
single precision (complex64, float32) unless an array is double (complex128,
float64), which keeps its precision.

``sharded_state_from_numpy`` / ``sharded_state_to_numpy`` carry a sharded
run's state (``parallel/sharded``): the gathered numpy leaves on one side,
the rank's blocks on the other, so the same gathered state feeds both
packages' sharded models.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.steppers import AB3State, Clock, EmptyState
from .coupled.driver import SimState
from .rays.packets import Packets
from .rays.resample import BirthDeathState

__all__ = ["sim_state_to_numpy", "sim_state_from_numpy", "sharded_state_from_numpy",
           "sharded_state_to_numpy"]

_PACKET_FIELDS = ("x", "y", "k", "l", "sign")
_BD_FIELDS = ("age", "lifetime", "key", "births")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def sim_state_to_numpy(sim) -> dict:
    """Flatten a SimState (this package's or the reference's) to numpy."""
    d = {
        "sol": _np(sim.sol),
        "clock.t": _np(sim.clock.t),
        "clock.step": _np(sim.clock.step),
        "fields": _np(sim.fields),
    }
    for name in getattr(sim.stepper_state, "_fields", ()):
        d[f"stepper_state.{name}"] = _np(getattr(sim.stepper_state, name))
    for name in _PACKET_FIELDS:
        d[f"packets.{name}"] = _np(getattr(sim.packets, name))
    if getattr(sim, "bd", None) is not None:
        for name in _BD_FIELDS:
            d[f"bd.{name}"] = _np(getattr(sim.bd, name))
    return d


def sim_state_from_numpy(d: dict, *, device: torch.device | str = "cuda") -> SimState:
    """Build this package's SimState on ``device``, with an AB3 history
    where ``d`` holds one and an empty stepper state otherwise, and the
    birth/death state where ``d`` holds one."""

    def t(key, single, double):
        a = np.asarray(d[key])
        dtype = double if a.dtype == double else single
        return torch.as_tensor(np.array(a, dtype, copy=True), device=device)

    def c(key):
        return t(key, np.complex64, np.complex128)

    def r(key):
        return t(key, np.float32, np.float64)

    bd = None
    if "bd.age" in d:
        bd = BirthDeathState(
            age=r("bd.age"), lifetime=r("bd.lifetime"),
            key=torch.as_tensor(np.array(d["bd.key"], np.uint32, copy=True), device=device),
            births=torch.as_tensor(np.array(d["bd.births"], np.int32, copy=True),
                                   device=device).reshape(()))
    return SimState(
        sol=c("sol"),
        clock=Clock(r("clock.t").reshape(()), int(d["clock.step"])),
        stepper_state=(AB3State(c("stepper_state.N1"), c("stepper_state.N2"))
                       if "stepper_state.N1" in d else EmptyState()),
        packets=Packets(*(r(f"packets.{n}") for n in _PACKET_FIELDS)),
        fields=r("fields"),
        bd=bd,
    )


def sharded_state_from_numpy(d: dict, sh):
    """A sharded run's state from numpy (the reference's sharded state
    once gathered, ``np.asarray`` of each leaf): ``sol``, ``N1``, ``N2``
    (global ``(C, nl, nkr)``, or channel-less ``(nl, nkr)``), ``clock.t``,
    ``clock.step`` and the global ``packets.x`` ... ``packets.sign`` ->
    (the rank's state block, Clock, AB3State, the rank's packets) of the
    sharded model ``sh`` (``parallel/sharded``), on its mesh's device."""
    from .parallel.mesh import shard_packets

    device = sh.mesh.device

    def block(key):
        return sh.shard_solution(np.asarray(d[key], np.complex64))

    clock = Clock(torch.as_tensor(np.asarray(d["clock.t"], np.float32), device=device),
                  int(d["clock.step"]))
    packets = Packets(*(torch.as_tensor(np.asarray(d[f"packets.{n}"], np.float32))
                        for n in _PACKET_FIELDS))
    return (block("sol"), clock, AB3State(block("N1"), block("N2")),
            shard_packets(packets, sh.mesh))


def sharded_state_to_numpy(sh, sol, clock, state, packets) -> dict:
    """The inverse of ``sharded_state_from_numpy``: every leaf gathered
    over ``sh``'s mesh (a collective: every rank calls it) and unsharded."""
    from .parallel.mesh import gather_packets

    d = {"sol": _np(sh.unshard(sol)), "N1": _np(sh.unshard(state.N1)),
         "N2": _np(sh.unshard(state.N2)), "clock.t": _np(clock.t),
         "clock.step": np.asarray(clock.step)}
    for name, leaf in zip(_PACKET_FIELDS, gather_packets(packets, sh.mesh)):
        d[f"packets.{name}"] = _np(leaf)
    return d
