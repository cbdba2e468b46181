"""WKB dispersion relation for near-inertial internal waves (port of
``rays/dispersion.py``).

omega(k) = sign * sqrt(f^2 + Cg^2 |k|^2), group velocity Cg^2 k / omega,
Doppler-shifted frequency omega + k . u.
"""
from __future__ import annotations

import torch

__all__ = ["omega", "group_velocity", "doppler_frequency"]


def omega(k, l, f, Cg, sign=1.0):
    return sign * torch.sqrt(f * f + Cg * Cg * (k * k + l * l))


def group_velocity(k, l, f, Cg, sign=1.0):
    w = omega(k, l, f, Cg, sign)
    c = Cg * Cg / w
    return c * k, c * l


def doppler_frequency(k, l, u, v, f, Cg, sign=1.0):
    """Absolute frequency Omega = omega + k . u."""
    return omega(k, l, f, Cg, sign) + k * u + l * v
