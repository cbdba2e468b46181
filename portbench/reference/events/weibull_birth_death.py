"""Weibull birth/death of the packet ensemble, after each ray step.

Each packet carries an age and a lifetime. A step of dt ages every packet;
a packet whose age reaches its lifetime (age + dt >= lifetime) dies and is
reborn at once: at a uniform position on the domain, with the wavevector
(k0, 0), branch +1 or -1 with equal odds, age 0 and a fresh lifetime
``lam (-log u)^(1 / k_shape)``, u uniform in [1e-12, 1). The ensemble keeps
its size. ``k_shape`` and ``lam`` are the configuration's ``flags``
``--bd-k-shape`` and ``--bd-lam``: what the program is told to run.

The draws are ``jax.random``'s (``portbench/reference/threefry``). The
parent key K of a step splits into ``(K', kx, ky, kl, ks)``; K' is the
next step's key, and packet i draws its position, lifetime and branch at
counter i of kx, ky, kl and ks, whether it dies or not. So one packet's
death moves no other packet's draws.

Arithmetic as the configuration states it: float32, positions ``x0 + u
L`` as one rounding, the lifetime's core ``(-log u)^(1 / k_shape)`` in
float64 rounded once to float32, then times lam in float32. The ages, the
lifetimes and the key are taken from the program's state at the start of
the followed frames (``snap.bd``); from there the reference keeps its own,
and ``gaps`` holds the program's after-state against it.

A packet whose age after a step lies within ``BD_WINDOW`` of its lifetime,
relative, is marked ambiguous: there an ulp of the age or the lifetime
could decide its death.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.inputs import k0_of
from portbench.reference.threefry import split, uniform

# |age + dt - lifetime| within this share of the lifetime lets rounding
# decide a death: four float32 ulps at the top of a binade
BD_WINDOW = 4 * 2.0**-23
# the lifetime draw's lower end
LIFE_MIN = 1e-12
# two ages that differ by more than this share of the lifetime: the two
# sides parted over a death
PARTED = 1e-3


def params(cfg: dict) -> tuple[float, float]:
    """``(k_shape, lam)`` from the configuration's ``flags``."""
    flags = cfg.get("flags") or {}
    if "--bd-k-shape" not in flags or "--bd-lam" not in flags:
        raise ValueError("weibull_birth_death: the configuration's flags state no "
                         "--bd-k-shape and --bd-lam")
    return float(flags["--bd-k-shape"]), float(flags["--bd-lam"])


def observed(snap) -> dict:
    """The program's ages, lifetimes and key in ``snap``."""
    bd = getattr(snap, "bd", None)
    if bd is None:
        raise ValueError("weibull_birth_death: the program's state carries no birth/death "
                         "state (its ages, lifetimes and key)")
    return {"age": bd.age.float(), "life": bd.lifetime.float(),
            "key": bd.key.to(torch.int64)}


def follow(cfg: dict, g, p, snap):
    """``step(st, ambiguous, t0, t1) -> st`` from the program's state
    ``snap``; the ages, lifetimes, key, the last step's deaths and each
    packet's least |age + dt - lifetime| / lifetime so far are
    ``step.state``."""
    k_shape, lam = params(cfg)
    inv_k, lam = 1.0 / k_shape, np.float32(lam)
    L32, x032 = float(np.float32(g.L)), float(np.float32(g.x0))
    k0 = k0_of(cfg)
    state = {k: v.clone() for k, v in observed(snap).items()}
    state["margin"] = torch.full_like(state["age"], math.inf)

    def step(st, ambiguous, t0, t1):
        n = st.shape[1]
        age = p.r(state["age"] + (t1 - t0))
        life = state["life"]
        margin = (age - life).abs() / life
        ambiguous |= margin <= BD_WINDOW
        dead = age >= life
        key, kx, ky, kl, ks = split(state["key"], 5)
        x = p.r(uniform(kx, n, 0.0, 1.0).double().mul(L32).add(x032).float())
        y = p.r(uniform(ky, n, 0.0, 1.0).double().mul(L32).add(x032).float())
        u = uniform(kl, n, LIFE_MIN, 1.0)
        core = (-torch.log(u.double())) ** inv_k
        new_life = p.r(core.float() * float(lam))
        sign = torch.where(uniform(ks, n) < 0.5, 1.0, -1.0).to(st.dtype)
        state.update(age=torch.where(dead, torch.zeros_like(age), age),
                     life=torch.where(dead, new_life, life), key=key, dead=dead,
                     margin=torch.minimum(state["margin"], margin))
        return torch.stack([torch.where(dead, x, st[0]), torch.where(dead, y, st[1]),
                            torch.where(dead, torch.full_like(st[2], k0), st[2]),
                            torch.where(dead, torch.zeros_like(st[3]), st[3]),
                            torch.where(dead, sign, st[4])])

    step.state = state
    return step


def _max(t) -> float:
    return float(t.max()) if t.numel() else math.inf


def gaps(out: dict, ref: dict, out_rows, ref_rows, keep) -> dict:
    """``out`` (the program's ``observed`` state, or the control's own)
    against the reference's ``ref`` after the followed frames: the key word
    for word; the ages and lifetimes as the largest gap relative to the
    reference's lifetime, and the branches (rows' sign, +-1) as the largest
    gap, over the packets no event marked."""
    life = ref["life"][keep]
    return {"bd_key_gap": float((out["key"] != ref["key"]).sum()),
            "bd_age_gap_max": _max((out["age"] - ref["age"])[keep].abs() / life),
            "bd_life_gap_max": _max((out["life"] - ref["life"])[keep].abs() / life),
            "bd_sign_gap_max": _max((out_rows[4] - ref_rows[4])[keep].abs())}


def audit(out: dict, ref: dict, keep) -> dict:
    """Where the two sides parted over a death (their ages differ by more
    than ``PARTED`` of the lifetime), the largest least margin of such a
    packet, those left unmarked, and how many packets came within
    ``BD_WINDOW`` and within 1e-5 of a death."""
    parted = (out["age"] - ref["age"]).abs() > PARTED * ref["life"]
    m = ref["margin"]
    return {"parted": int(parted.sum()),
            "parted_margin_max": float(m[parted].max()) if bool(parted.any()) else None,
            "parted_unmarked": int((parted & keep).sum()),
            "within_window": int((m <= BD_WINDOW).sum()), "within_1e-5": int((m <= 1e-5).sum())}
