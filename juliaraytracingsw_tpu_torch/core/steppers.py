"""Time steppers for stiff pseudo-spectral systems (port of
``core/steppers.py``):

- ``make_ifab3``: AB3 with a matrix-exponential integrating factor, for
  diagonal or ``(C, C, nl, nkr)`` block operators (tables precomputed on
  the host in float64);
- ``make_ifrk4``: integrating-factor RK4 with ``exp(L dt/2)`` tables;
- ``make_etdrk4``: Cox-Matthews ETDRK4 with Kassam-Trefethen contour
  coefficients, for diagonal L (a block L raises);
- ``make_filtered_ab3`` / ``make_filtered_rk4``: classic AB3 / RK4 on the
  whole right-hand side ``L sol + N``, with an optional spectral filter.

Steppers share the reference's protocol::

    init_fn(sol0) -> state0
    step_fn(sol, clock, state) -> (sol', clock', state')

``Clock.t`` is a 0-d tensor on the state's device (float32 unless asked)
and accumulates in its dtype exactly as the reference's does; ``Clock.step`` is the host's
Python int, so the AB3 bootstrap branch never waits on the device.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import scipy.linalg
import torch

__all__ = ["BOOTSTRAP_STEPS", "Clock", "tick", "zero_clock", "apply_L", "expm_tables",
           "AB3State", "EmptyState", "make_ifab3", "make_ifrk4", "make_etdrk4",
           "make_filtered_ab3", "make_filtered_rk4"]

AB3_H1, AB3_H2, AB3_H3 = 23.0 / 12.0, 16.0 / 12.0, 5.0 / 12.0
# the AB3 steppers take forward-Euler steps while the host's Clock.step is
# below this
BOOTSTRAP_STEPS = 3


class Clock(NamedTuple):
    t: torch.Tensor  # () model time (float32 unless asked), on the device
    step: int        # step count, on the host


def tick(clock: Clock, dt: float) -> Clock:
    return Clock(clock.t + dt, clock.step + 1)


def zero_clock(dtype: torch.dtype = torch.float32, *,
               device: torch.device | str = "cuda") -> Clock:
    return Clock(torch.zeros((), dtype=dtype, device=device), 0)


def apply_L(L: torch.Tensor, sol: torch.Tensor) -> torch.Tensor:
    """Apply a per-mode linear operator: diagonal (broadcastable to
    ``sol``) or a ``(C, C, nl, nkr)`` block acting on the channel axis of a
    ``(C, nl, nkr)`` state. The block form is an elementwise multiply and a
    sum over the input channel, not a batched complex matmul."""
    if L.ndim == sol.ndim + 1:
        return (L * sol.unsqueeze(0)).sum(1)
    return L * sol


def _is_block(L) -> bool:
    """Is ``L`` a ``(C, C, nl, nkr)`` block operator (not a diagonal one)?"""
    return L.ndim >= 4 and L.shape[0] == L.shape[1]


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
    if _is_block(Lnp):
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
        if clock.step < BOOTSTRAP_STEPS:
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


class EmptyState(NamedTuple):
    """The state of the one-step steppers: nothing."""


def make_ifrk4(
    L: torch.Tensor,
    calcN: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float,
    filt: torch.Tensor | None = None,
):
    """Integrating-factor RK4. With E = exp(L dt/2)::

        k1 = N(u, t)
        k2 = N(E u + dt/2 E k1, t + dt/2)
        k3 = N(E u + dt/2 k2, t + dt/2)
        k4 = N(E^2 u + dt E k3, t + dt)
        u' = E^2 u + dt/6 (E^2 k1 + 2 E (k2 + k3) + k4)"""
    exph, _ = expm_tables(L, dt / 2.0)

    def E(x):
        return apply_L(exph, x)

    def init(sol0):
        return EmptyState()

    def step(sol, clock: Clock, state: EmptyState):
        t = clock.t
        k1 = calcN(sol, t)
        Eu = E(sol)
        k2 = calcN(Eu + 0.5 * dt * E(k1), t + 0.5 * dt)
        k3 = calcN(Eu + 0.5 * dt * k2, t + 0.5 * dt)
        E2u = E(Eu)
        k4 = calcN(E2u + dt * E(k3), t + dt)
        new = E2u + dt / 6.0 * (E(E(k1)) + 2.0 * E(k2 + k3) + k4)
        if filt is not None:
            new = new * filt
        return new, tick(clock, dt), state

    return init, step


def _etdrk4_coeffs(L_diag: np.ndarray, dt: float, n_contour: int = 32):
    """Kassam-Trefethen contour means of the phi-function coefficients,
    in float64 on the host -> (E, E2, Q, f1, f2, f3)."""
    Lh = np.asarray(L_diag).astype(np.complex128) * dt
    E = np.exp(Lh)
    E2 = np.exp(Lh / 2.0)
    M = n_contour
    r = np.exp(2j * np.pi * (np.arange(1, M + 1) - 0.5) / M)  # unit circle
    LR = Lh[..., None] + r
    Q = dt * np.real(np.mean((np.exp(LR / 2.0) - 1.0) / LR, axis=-1))
    f1 = dt * np.real(
        np.mean((-4.0 - LR + np.exp(LR) * (4.0 - 3.0 * LR + LR**2)) / LR**3, axis=-1)
    )
    f2 = dt * np.real(
        np.mean((2.0 + LR + np.exp(LR) * (-2.0 + LR)) / LR**3, axis=-1)
    )
    f3 = dt * np.real(
        np.mean((-4.0 - 3.0 * LR - LR**2 + np.exp(LR) * (4.0 - LR)) / LR**3, axis=-1)
    )
    return E, E2, Q, f1, f2, f3


def make_etdrk4(
    L_diag: torch.Tensor,
    calcN: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float,
    filt: torch.Tensor | None = None,
):
    """Cox-Matthews ETDRK4 for a diagonal linear operator. The tables take
    L's precision (float64 or complex128 L gives double tables) and stay
    real where they are real to round-off; they live on L's device. A
    ``(C, C, nl, nkr)`` block L raises ``ValueError``: its phi-functions
    are matrix functions, which this scheme does not form."""
    if _is_block(L_diag):
        raise ValueError(
            f"ETDRK4 needs a diagonal linear operator; this model's L is a "
            f"{tuple(L_diag.shape[:2])} block per mode, shape {tuple(L_diag.shape)} "
            f"(step it with IFMAB3 or IFRK4)")
    Lnp = L_diag.detach().cpu().numpy()
    double = Lnp.dtype in (np.float64, np.complex128)

    def cvt(a):
        if np.iscomplexobj(a) and np.max(np.abs(a.imag)) < 1e-14 * max(
            1.0, np.max(np.abs(a.real))
        ):
            a = a.real
        if np.iscomplexobj(a):
            a = a.astype(np.complex128 if double else np.complex64)
        else:
            a = a.astype(np.float64 if double else np.float32)
        return torch.as_tensor(np.ascontiguousarray(a), device=L_diag.device)

    E, E2, Q, f1, f2, f3 = map(cvt, _etdrk4_coeffs(Lnp, dt))

    def init(sol0):
        return EmptyState()

    def step(sol, clock: Clock, state: EmptyState):
        t = clock.t
        Nu = calcN(sol, t)
        a = E2 * sol + Q * Nu
        Na = calcN(a, t + dt / 2.0)
        b = E2 * sol + Q * Na
        Nb = calcN(b, t + dt / 2.0)
        c = E2 * a + Q * (2.0 * Nb - Nu)
        Nc = calcN(c, t + dt)
        new = E * sol + f1 * Nu + 2.0 * f2 * (Na + Nb) + f3 * Nc
        if filt is not None:
            new = new * filt
        return new, tick(clock, dt), state

    return init, step


def make_filtered_ab3(
    L: torch.Tensor,
    calcN: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float,
    filt: torch.Tensor | None = None,
):
    """Classic AB3 on RHS = L sol + N, then the filter, with a
    forward-Euler bootstrap for steps < 3 (host ``Clock.step``)."""

    def rhs(sol, t):
        return apply_L(L, sol) + calcN(sol, t)

    def init(sol0):
        z = torch.zeros_like(sol0)
        return AB3State(z, z)

    def step(sol, clock: Clock, state: AB3State):
        R = rhs(sol, clock.t)
        if clock.step < BOOTSTRAP_STEPS:
            new = sol + dt * R
        else:
            new = sol + dt * (AB3_H1 * R - AB3_H2 * state.N1 + AB3_H3 * state.N2)
        if filt is not None:
            new = new * filt
        return new, tick(clock, dt), AB3State(R, state.N1)

    return init, step


def make_filtered_rk4(
    L: torch.Tensor,
    calcN: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    dt: float,
    filt: torch.Tensor | None = None,
):
    """Classic RK4 on RHS = L sol + N, then the filter."""

    def rhs(sol, t):
        return apply_L(L, sol) + calcN(sol, t)

    def init(sol0):
        return EmptyState()

    def step(sol, clock: Clock, state: EmptyState):
        t = clock.t
        k1 = rhs(sol, t)
        k2 = rhs(sol + 0.5 * dt * k1, t + 0.5 * dt)
        k3 = rhs(sol + 0.5 * dt * k2, t + 0.5 * dt)
        k4 = rhs(sol + dt * k3, t + dt)
        new = sol + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        if filt is not None:
            new = new * filt
        return new, tick(clock, dt), state

    return init, step
