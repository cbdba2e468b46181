"""IF-AB3 time stepper (port of the IF-AB3 part of ``core/steppers.py``).

Steppers share the reference's protocol::

    init_fn(sol0) -> state0
    step_fn(sol, clock, state) -> (sol', clock', state')

``Clock.t`` is a 0-d float32 tensor on the state's device and accumulates
in float32 exactly as the reference's does; ``Clock.step`` is the host's
Python int, so the AB3 bootstrap branch never waits on the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg
import torch

__all__ = ["Clock", "tick", "zero_clock", "apply_L", "expm_tables",
           "AB3State", "make_ifab3"]

AB3_H1, AB3_H2, AB3_H3 = 23.0 / 12.0, 16.0 / 12.0, 5.0 / 12.0


class Clock(NamedTuple):
    t: torch.Tensor  # () float32 model time, on the device
    step: int        # step count, on the host


def tick(clock: Clock, dt: float) -> Clock:
    return Clock(clock.t + dt, clock.step + 1)


def zero_clock(*, device: torch.device | str = "cuda") -> Clock:
    return Clock(torch.zeros((), dtype=torch.float32, device=device), 0)


def apply_L(L: torch.Tensor, sol: torch.Tensor) -> torch.Tensor:
    """Apply a per-mode linear operator: diagonal (broadcastable to
    ``sol``) or a ``(C, C, nl, nkr)`` block acting on the channel axis of a
    ``(C, nl, nkr)`` state. The block form is an elementwise multiply and a
    sum over the input channel, not a batched complex matmul."""
    if L.ndim == sol.ndim + 1:
        return (L * sol.unsqueeze(0)).sum(1)
    return L * sol


def expm_tables(L, dt: float):
    """Host float64 precompute of exp(L dt) and exp(2 L dt).

    ``L`` is a numpy array or tensor, diagonal or ``(C, C, nl, nkr)``
    blocks (then a batched dense matrix exponential over all modes).
    Returns complex64 tensors on ``L``'s device (the CPU for numpy)."""
    if isinstance(L, torch.Tensor):
        device = L.device
        Lnp = L.detach().cpu().numpy()
    else:
        device = "cpu"
        Lnp = np.asarray(L)
    if Lnp.ndim >= 4 and Lnp.shape[0] == Lnp.shape[1]:
        # (C, C, nl, nkr) -> (nl, nkr, C, C) for batched expm
        perm = tuple(range(2, Lnp.ndim)) + (0, 1)
        blocks = np.transpose(Lnp.astype(np.complex128), perm)
        e1 = scipy.linalg.expm(blocks * dt)
        e2 = scipy.linalg.expm(blocks * (2.0 * dt))
        inv = tuple(range(Lnp.ndim - 2, Lnp.ndim)) + tuple(range(Lnp.ndim - 2))
        e1 = np.transpose(e1, inv)
        e2 = np.transpose(e2, inv)
    else:
        Ld = Lnp.astype(np.complex128)
        e1 = np.exp(Ld * dt)
        e2 = np.exp(Ld * 2.0 * dt)
    cdtype = np.complex64 if Lnp.dtype != np.complex128 else np.complex128
    return (torch.as_tensor(np.ascontiguousarray(e1.astype(cdtype)), device=device),
            torch.as_tensor(np.ascontiguousarray(e2.astype(cdtype)), device=device))


class AB3State(NamedTuple):
    N1: torch.Tensor  # N at step-1
    N2: torch.Tensor  # N at step-2


def make_ifab3(
    L: torch.Tensor,
    calcN: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float,
    filt: torch.Tensor | None = None,
):
    """Integrating-factor AB3 stepper, in the reference's update order:

        N    = calcN(sol, t)
        sol += dt * (23/12 N - 16/12 e^{Ldt} N_{-1} + 5/12 e^{2Ldt} N_{-2})
        sol  = e^{Ldt} sol
        sol *= filter

    with a forward-Euler bootstrap for steps < 3."""
    expLdt, exp2Ldt = expm_tables(L, dt)

    def init(sol0: torch.Tensor) -> AB3State:
        z = torch.zeros_like(sol0)
        return AB3State(z, z)

    def step(sol, clock: Clock, state: AB3State):
        N = calcN(sol, clock.t)
        if clock.step < 3:
            new = apply_L(expLdt, sol + dt * N)
        else:
            incr = dt * (
                AB3_H1 * N
                - AB3_H2 * apply_L(expLdt, state.N1)
                + AB3_H3 * apply_L(exp2Ldt, state.N2)
            )
            new = apply_L(expLdt, sol + incr)
        if filt is not None:
            new = new * filt
        return new, tick(clock, dt), AB3State(N, state.N1)

    return init, step
