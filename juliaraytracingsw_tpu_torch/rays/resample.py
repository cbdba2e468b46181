"""Packet ensemble maintenance (port of ``rays/resample.k_cutoff_reset``).

Weibull birth/death resampling is not ported yet (ROADMAP queue 1,
item 5).
"""
from __future__ import annotations

import torch

from .packets import Packets

__all__ = ["k_cutoff_reset"]


def k_cutoff_reset(p: Packets, k_cutoff: float, k0: float) -> Packets:
    """Reset packets with |k| >= k_cutoff to (k0, 0)."""
    mag2 = p.k * p.k + p.l * p.l
    reset = mag2 >= (k_cutoff * k_cutoff)
    return Packets(
        p.x,
        p.y,
        torch.where(reset, torch.full_like(p.k, k0), p.k),
        torch.where(reset, torch.zeros_like(p.l), p.l),
        p.sign,
    )
