"""The k-cutoff reset: a packet whose |k| reaches k_cutoff (the
configuration's ``k_cutoff_f_over_cg`` f / Cg) goes back to (k0, 0). The
packets whose |k| lay so close to the cutoff that rounding could decide
the reset are marked ambiguous."""
from __future__ import annotations

import torch

from portbench.inputs import k0_of

# |k|^2 within this share of k_cutoff^2 lets rounding decide the reset
RESET_WINDOW = 1e-3


def follow(cfg: dict, g, p, snap):
    """``step(st, ambiguous, t0, t1) -> st``; it keeps no state of its own."""
    fl = cfg["flow"]
    k_cutoff = cfg["rays"]["k_cutoff_f_over_cg"] * fl["f"] / fl["Cg"]
    kc2, k0 = k_cutoff * k_cutoff, k0_of(cfg)

    def step(st, ambiguous, t0, t1):
        mag2 = st[2] * st[2] + st[3] * st[3]
        hit = mag2 >= kc2
        ambiguous |= (mag2 - kc2).abs() <= RESET_WINDOW * kc2
        k = torch.where(hit, torch.full_like(st[2], k0), st[2])
        l = torch.where(hit, torch.zeros_like(st[3]), st[3])
        return torch.stack([st[0], st[1], k, l, st[4]])

    return step
