"""WKB ray integration through evolving 2-D flows, patch-table path (port
of ``rays/raytrace.py``).

Rays obey

    dx/dt =  u(x, t) + Cg^2 k / omega
    dk/dt = -(u_x k + v_x l)
    dl/dt = -(u_y k + v_y l),   with v_y = -u_x

with the flow entering through the field stack ``(5, ny, nx)`` =
[u, v, u_x, u_y, v_x], blended linearly in time between two snapshots.

Only the patch gather path with fixed-step RK4 is ported: each substep
gathers one (old|new) pair-table row per packet and runs the fused substep
(``ops/ray_step.fused_substep``: the CUDA kernel on the card, its twin on
the CPU). The taps path, the other integrators and the adaptive integrator
are not ported yet (ROADMAP queue 1, items 13 and 15).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.spectral import irfft2, spectral_gradients
from ..ops.ray_step import fused_substep
from .interp import bspline_prefilter_mask
from .packets import Packets
from .patch import PATCH_SHAPES

__all__ = [
    "RayParams",
    "blend",
    "check_patch_path",
    "fields_from_psih",
    "make_pair_table",
    "raytrace_tables",
]

_TABLE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class RayParams(NamedTuple):
    """Static ray-tracing parameters (Python floats)."""

    f: float
    Cg: float
    x0: float      # grid origin (first node coordinate)
    y0: float
    dx: float
    dy: float
    interp: str = "bilinear"   # 'bilinear' | 'bspline' | 'bicubic'
    gather: str = "patch"      # only 'patch' is ported
    # storage dtype of the pair table ('float32' | 'bfloat16'); stage math
    # always upcasts the gathered rows to float32
    table_dtype: str = "float32"


def check_patch_path(rp: RayParams) -> None:
    """Raise for a RayParams that needs code the port does not have yet."""
    if rp.gather != "patch":
        raise NotImplementedError(
            f"gather={rp.gather!r}: only the patch path is ported (the taps "
            "path is ROADMAP queue 1, item 13)")
    if rp.interp not in PATCH_SHAPES:
        raise ValueError(f"unknown interp {rp.interp!r}; available: "
                         f"{sorted(PATCH_SHAPES)}")
    if rp.table_dtype not in _TABLE_DTYPES:
        raise ValueError(f"unknown table_dtype {rp.table_dtype!r}; "
                         f"available: {sorted(_TABLE_DTYPES)}")


def fields_from_psih(psih: torch.Tensor, grid, interp: str = "bilinear") -> torch.Tensor:
    """Interpolation field stack from a streamfunction spectrum, as one
    batched inverse transform: ``(5, ny, nx)`` [u, v, ux, uy, vx] (for
    'bspline' with the spectral B-spline prefilter folded in), or for
    'bicubic' ``(20, ny, nx)`` = [f | fx | fy | fxy] of those 5 fields."""
    stackh = torch.stack(spectral_gradients(psih, grid))
    if interp == "bicubic":
        ik, il = grid.ik, grid.il
        stackh = torch.cat([stackh, ik * stackh, il * stackh, ik * il * stackh])
    elif interp == "bspline":
        stackh = stackh * bspline_prefilter_mask(grid)
    return irfft2(stackh, grid.nx)


def blend(fields_old, fields_new, a):
    """Linear time blend: a=0 -> old snapshot, a=1 -> new snapshot."""
    return (1.0 - a) * fields_old + a * fields_new


def make_pair_table(T_old: torch.Tensor, T_new: torch.Tensor,
                    dtype: str = "float32") -> torch.Tensor:
    """(R, 2W) pair table [old | new] so a substep needs one row gather;
    ``dtype='bfloat16'`` stores it at half width (round to nearest even)."""
    return torch.cat([T_old, T_new], dim=1).to(_TABLE_DTYPES[dtype])


def _gather_patch_rows(T_pair, p: Packets, rp: RayParams, ny: int, nx: int):
    """One row gather (both time levels) at the packets' base cells ->
    (rows f32 (N, 2W), bx, by). Positions are never wrapped; only the cell
    index is, with the sign rule of ``remainder``."""
    bx = torch.floor((p.x - rp.x0) / rp.dx)
    by = torch.floor((p.y - rp.y0) / rp.dy)
    cell = (torch.remainder(by.to(torch.int32), ny) * nx
            + torch.remainder(bx.to(torch.int32), nx))
    rows = T_pair.index_select(0, cell).float()
    return rows, bx, by


def raytrace_tables(
    packets: Packets,
    T_pair: torch.Tensor,
    t0,
    t1,
    rp: RayParams,
    ny: int,
    nx: int,
    nsubsteps: int = 1,
    method: str = "rk4",
) -> Packets:
    """Advance packets from t0 to t1 through a pre-built (old|new) pair
    table in ``nsubsteps`` fused RK4 substeps. ``t0``/``t1`` are 0-d float32
    tensors (or floats) on the packets' device."""
    if method != "rk4":
        raise NotImplementedError(
            f"ray method {method!r}: only fixed-step RK4 is ported (DP5, "
            "midpoint and adaptive are ROADMAP queue 1, item 15)")
    check_patch_path(rp)
    dev = packets.x.device
    t0 = torch.as_tensor(t0, dtype=torch.float32, device=dev)
    t1 = torch.as_tensor(t1, dtype=torch.float32, device=dev)
    h = (t1 - t0) / nsubsteps
    da = 1.0 / nsubsteps
    p = packets
    for i in range(nsubsteps):
        # a float32 product, as the reference's traced i * da
        a0 = torch.full((), float(i), dtype=torch.float32, device=dev) * da
        rows, bx, by = _gather_patch_rows(T_pair, p, rp, ny, nx)
        rows_T = rows.t().contiguous()
        st = torch.stack([p.x, p.y, p.k, p.l, p.sign, bx, by])
        out = fused_substep(rows_T, st, torch.stack([a0, h]), rp=rp,
                            interp=rp.interp, da=da)
        p = Packets(out[0], out[1], out[2], out[3], p.sign)
    return p
