"""The reference rays: WKB packets through the time-blended fields of two
flow snapshots.

    dx/dt = u + Cg^2 k / omega,     omega = sign sqrt(f^2 + Cg^2 |k|^2)
    dk/dt = -(u_x k + v_x l)
    dl/dt = -(u_y k - u_x l)        (v_y = -u_x)

The fields are stored and interpolated as the configuration's interpolant
states it (``interp/<name>.py``: ``table`` and ``sampler``). Positions are
never wrapped, only cell indices are. Stage positions are taken relative
to the packet's base cell at the start of the step (floor((x - x0) /
dx)), and the adaptive error is scaled by those cell-relative positions:
the semantics the configuration's patch tables state. What happens to the
packets after a step (the k-cutoff reset, birth/death) is a packet event
(``events/<name>.py``).
"""
from __future__ import annotations

import torch

from . import Prec

__all__ = ["Rays", "DP_C", "DP_A", "DP_B", "DP_B4"]

RK4 = ((0.0, ()), (0.5, (0.5,)), (0.5, (0.0, 0.5)), (1.0, (0.0, 0.0, 1.0)))
RK4_B = (1 / 6, 1 / 3, 1 / 3, 1 / 6)
DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
DP_E = tuple(b - b4 for b, b4 in zip(DP_B, DP_B4))


class Rays:
    """``st`` is ``(5, N)`` float32 [x, y, k, l, sign]; ``interp`` the
    interpolant's module."""

    def __init__(self, g, f: float, Cg: float, p: Prec, interp):
        self.g, self.f, self.Cg, self.p, self.interp = g, f, Cg, p, interp
        self.dx = torch.full((), g.dx, dtype=torch.float32, device=g.K2.device)

    def _sampler(self, Fo, Fn, bx, by):
        return self.interp.sampler(Fo, Fn, bx, by, self.g, self.p)

    def _rhs(self, sample, x, y, k, l, sgn, a):
        u, v, ux, uy, vx = sample(x, y, a)
        om = sgn * torch.sqrt(self.f * self.f + self.Cg * self.Cg * (k * k + l * l))
        cg = (self.Cg * self.Cg) / om
        r = self.p.r
        return (r(u + cg * k), r(v + cg * l), r(-(ux * k + vx * l)), r(-(uy * k - ux * l)))

    def _base(self, st):
        bx = torch.floor((st[0] - self.g.x0) / self.dx)
        by = torch.floor((st[1] - self.g.x0) / self.dx)
        return bx, by, self.g.x0 + bx * self.g.dx, self.g.x0 + by * self.g.dx

    def _stages(self, sample, q, sgn, a0, da, h, C, A):
        ks = []
        for ci, aij in zip(C, A):
            s = list(q)
            for kp, aa in zip(ks, aij):
                if aa:
                    s = [si + h * aa * kv for si, kv in zip(s, kp)]
            ks.append(self._rhs(sample, *s, sgn, a0 + ci * da))
        return ks

    @staticmethod
    def _comb(base, ks, ws, h):
        acc = [None] * 4
        for kv, w in zip(ks, ws):
            if w == 0.0:
                continue
            acc = [kv[i] * w if acc[i] is None else acc[i] + kv[i] * w for i in range(4)]
        return [b + h * a for b, a in zip(base, acc)]

    # -- integrators ---------------------------------------------------------
    def tables(self, fields):
        """The field stack as the configuration's table stores it."""
        return self.interp.table(fields, self.g, self.p)

    def rk4(self, st, Fo, Fn, t0, t1):
        """One RK4 step from t0 to t1 -> ``(5, N)``."""
        h = t1 - t0
        bx, by, shx, shy = self._base(st)
        sample = self._sampler(Fo, Fn, bx, by)
        q = (st[0] - shx, st[1] - shy, st[2], st[3])
        ks = self._stages(sample, q, st[4], 0.0, 1.0, h, tuple(c for c, _ in RK4),
                          tuple(a for _, a in RK4))
        out = self._comb(q, ks, RK4_B, h)
        r = self.p.r
        return torch.stack([r(out[0] + shx), r(out[1] + shy), r(out[2]), r(out[3]), st[4]])

    def attempt(self, st, Fo, Fn, a0, dah, h, rtol, atol):
        """One DP5(4) attempt -> ((5, N) state, (N,) sum of squared
        scaled errors)."""
        bx, by, shx, shy = self._base(st)
        sample = self._sampler(Fo, Fn, bx, by)
        q = (st[0] - shx, st[1] - shy, st[2], st[3])
        ks = self._stages(sample, q, st[4], a0, dah, h, DP_C, DP_A)
        q5 = self._comb(q, ks, DP_B, h)
        e = self._comb([torch.zeros_like(st[0])] * 4, ks, DP_E, h)
        esum = 0.0
        for ei, y5, y in zip(e, q5, q):
            sc = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y5))
            esum = esum + (ei / sc) ** 2
        r = self.p.r
        out = torch.stack([r(q5[0] + shx), r(q5[1] + shy), r(q5[2]), r(q5[3]), st[4]])
        return out, esum

    def adaptive(self, st, Fo, Fn, t0, t1, rtol, atol, max_steps, init_substeps):
        """DP5(4) with one step size for the whole ensemble, Hairer's
        error norm, factor 0.9 err^(-1/5) clipped to [0.2, 5]; the clock is
        tested before each attempt -> (state, accepted, rejected)."""
        span = t1 - t0
        eps = 1e-9 * torch.abs(span)
        t, h = t0, span / init_substeps
        n_acc = n_rej = slots = 0
        while bool(t < t1 - eps) and slots < max_steps:
            h_eff = torch.minimum(h, t1 - t)
            out, esum = self.attempt(st, Fo, Fn, (t - t0) / span, h_eff / span, h_eff,
                                     rtol, atol)
            err = torch.sqrt(torch.sum(esum) / (4.0 * st.shape[1]))
            if bool(err <= 1.0):
                st, t = out, t + h_eff
                n_acc += 1
            else:
                n_rej += 1
            fac = torch.clip(0.9 * torch.clamp_min(err, 1e-10) ** (-0.2), 0.2, 5.0)
            h = torch.maximum(h_eff * fac, eps)
            slots += 1
        return st, n_acc, n_rej
