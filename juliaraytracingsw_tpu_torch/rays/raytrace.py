"""WKB ray integration through evolving 2-D flows (port of
``rays/raytrace.py``).

Rays obey

    dx/dt =  u(x, t) + Cg^2 k / omega
    dk/dt = -(u_x k + v_x l)
    dl/dt = -(u_y k + v_y l),   with v_y = -u_x

with the flow entering through the field stack ``(5, ny, nx)`` =
[u, v, u_x, u_y, v_x], blended linearly in time between two snapshots.

Two gather strategies, chosen by ``RayParams.gather``:

- ``'patch'``: once per (old, new) pair of snapshots the fields are packed
  into a pair table (``build_pair``: ``ops/pair_table``, one kernel launch
  on the card; the ``rays/patch`` tables on the CPU); each substep or
  attempt gathers one row per packet and every stage interpolates locally
  from it;
- ``'taps'``: every stage gathers its taps from the time-blended field
  stacks (``rays/interp``), the reference semantics the patch path is held
  against.

Integrators:

- ``raytrace_tables`` / ``raytrace``: fixed steps. RK4 on the patch path
  runs the fused substep over the pair table (``ops/ray_step.table_substep``:
  the CUDA kernel on the card, which reads the table rows itself; its twin
  on the CPU; differentiable through ``TableSubstep``); DP5, implicit
  midpoint and the taps path run the per-stage ``_step``.
- implicit midpoint (``method='midpoint'``): a converged fixed-point solve
  of the midpoint slope, differentiated implicitly (``_ImplicitRoot``, the
  counterpart of the reference's ``lax.custom_root``), never through its
  iterations.
- ``raytrace_tables_fb``: ``raytrace_tables`` whose backward is chosen by
  ``JRSW_PATCH_BWD``: 'table' (default, autograd through the table path)
  or 'taps' (autograd through the taps path at the same inputs).
- ``raytrace_adaptive``: embedded Dormand-Prince 5(4) or Fehlberg 7(8)
  with one shared step size. With the patch gather, pair 'dopri5' and
  loop 'while' (``fused_while``) each attempt is the fused attempt over the
  pair table (``ops/ray_step.table_attempt``, forward only), and on the
  card the whole loop runs on the device (``ops/adaptive_loop``); every
  other combination runs the per-stage attempt.

``gather='auto'`` picks one of the two per run (``resolve_gather``): the
patch path iff ``PATCH_TAPS_CROSSOVER * n_packets >= ny * nx``, the
reference's rule and constant, so both packages choose alike.

Times ``t0``, ``t1`` and the substep ``h`` take the packets' dtype
(float32, or float64 for the gradient checks on the CPU).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from ..core.spectral import irfft2, spectral_gradients
from ..ops.adaptive_loop import DeviceLoop
from ..ops.pair_table import pair_table
from ..ops.ray_step import recompute_vjp, table_attempt, table_substep
from ..utils import observability
from .dispersion import group_velocity
from .interp import bspline_prefilter_mask, interpolate
from .packets import Packets
from .patch import PATCH_SHAPES, patch_interpolate_pair_shared

__all__ = [
    "RayParams",
    "blend",
    "build_pair",
    "check_ray_params",
    "fields_from_psih",
    "fields_from_velocity_spectra",
    "fused_while",
    "make_pair_table",
    "raytrace",
    "raytrace_adaptive",
    "raytrace_tables",
    "raytrace_tables_fb",
    "resolve_gather",
    "sample_gradients",
    "sample_velocity",
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
    gather: str = "patch"      # 'patch' | 'taps' | 'auto' (resolve_gather)
    # implicit midpoint (method 'midpoint'): the fixed-point solve iterates
    # until the residual drops below 1e-8 + rtol |z| or maxit iterations
    midpoint_rtol: float = 1e-6
    midpoint_maxit: int = 20
    # storage dtype of the pair table ('float32' | 'bfloat16'); stage math
    # always upcasts the gathered rows to float32
    table_dtype: str = "float32"


def check_ray_params(rp: RayParams) -> None:
    """Raise for a RayParams the port cannot run."""
    if rp.gather not in ("patch", "taps", "auto"):
        raise ValueError(f"unknown gather {rp.gather!r}; available: ['auto', 'patch', 'taps']")
    if rp.interp not in PATCH_SHAPES:
        raise ValueError(f"unknown interp {rp.interp!r}; available: "
                         f"{sorted(PATCH_SHAPES)}")
    if rp.table_dtype not in _TABLE_DTYPES:
        raise ValueError(f"unknown table_dtype {rp.table_dtype!r}; "
                         f"available: {sorted(_TABLE_DTYPES)}")


def fields_from_psih(psih: torch.Tensor, grid, interp: str = "bilinear",
                     prefilter: torch.Tensor | None = None) -> torch.Tensor:
    """Interpolation field stack from a streamfunction spectrum, as one
    batched inverse transform: ``(5, ny, nx)`` [u, v, ux, uy, vx] (for
    'bspline' with the spectral B-spline prefilter folded in), or for
    'bicubic' ``(20, ny, nx)`` = [f | fx | fy | fxy] of those 5 fields.
    ``prefilter`` is ``bspline_prefilter_mask(grid)`` computed once by a
    caller that calls this in a loop (the mask is made on the host, which
    a CUDA graph cannot capture); by default it is made here."""
    stackh = torch.stack(spectral_gradients(psih, grid))
    if interp == "bicubic":
        ik, il = grid.ik, grid.il
        stackh = torch.cat([stackh, ik * stackh, il * stackh, ik * il * stackh])
    elif interp == "bspline":
        stackh = stackh * (bspline_prefilter_mask(grid) if prefilter is None else prefilter)
    return irfft2(stackh, grid.nx)


def fields_from_velocity_spectra(uh: torch.Tensor, vh: torch.Tensor, grid,
                                 interp: str = "bilinear") -> torch.Tensor:
    """The ``(5, ny, nx)`` stack [u, v, ux, uy, vx] from explicit (uh, vh),
    for flows not derived from a streamfunction. v_y is not stored (the
    ray equations take it as -u_x), so pass the divergence-free part. As
    in the reference, 'bicubic' gets no derivative blocks here."""
    ik, il = grid.ik, grid.il
    stackh = torch.stack([uh, vh, ik * uh, il * uh, ik * vh])
    if interp == "bspline":
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


def build_pair(fields_old, fields_new, rp: RayParams) -> torch.Tensor:
    """(old|new) pair table of two field stacks, in ``rp.table_dtype``:
    ``ops/pair_table.pair_table``, one kernel launch on the card, on the
    CPU its twin ``make_pair_table`` of the two ``build_patch_table``s.
    Differentiable with respect to both stacks."""
    return pair_table(fields_old, fields_new, interp=rp.interp, table_dtype=rp.table_dtype)


# --- samplers and the generic stage math -------------------------------------

def _rhs(p: Packets, sample, a, rp: RayParams) -> Packets:
    """WKB ray RHS; ``sample(x, y, a) -> (5, N)`` interpolated fields at
    relative time a."""
    u, v, ux, uy, vx = sample(p.x, p.y, a)[:5]
    cgx, cgy = group_velocity(p.k, p.l, rp.f, rp.Cg, p.sign)
    return Packets(u + cgx, v + cgy, -(ux * p.k + vx * p.l),
                   -(uy * p.k - ux * p.l), torch.zeros_like(p.sign))


def _make_taps_sampler(fields_old, fields_new, rp: RayParams):
    """Global-gather sampler: blend the full field stacks, then gather; each
    sample is the span ``rays.taps`` under a profiler."""

    def sample(qx, qy, a):
        with observability.span("rays.taps"):
            return interpolate(blend(fields_old, fields_new, a), qx, qy, rp.x0, rp.y0,
                               rp.dx, rp.dy, method=rp.interp)

    return sample


def _cell_floor(v, origin: float, step: float):
    """floor((v - origin) / step) in IEEE arithmetic of v's dtype, origin
    and step each rounded once to it. The divisor is a tensor on v's
    device: PyTorch on CUDA divides by a Python scalar as a product with its
    float32 reciprocal, which can differ by an ulp and, at a cell face, by a
    cell. The floor gives no gradient, as the reference's does not."""
    return torch.floor((v - origin) / torch.full((), step, dtype=v.dtype, device=v.device))


def _gather_patch_rows(T_pair, p: Packets, rp: RayParams, ny: int, nx: int):
    """One row gather (both time levels) at the packets' base cells ->
    (rows f32 (N, 2W), bx, by). Positions are never wrapped; only the cell
    index is, with the sign rule of ``remainder``. The table kernels
    (``ops/ray_step.table_substep``, ``table_attempt``) find the same rows."""
    bx = _cell_floor(p.x, rp.x0, rp.dx)
    by = _cell_floor(p.y, rp.y0, rp.dy)
    cell = (torch.remainder(by.to(torch.int32), ny) * nx
            + torch.remainder(bx.to(torch.int32), nx))
    rows = T_pair.index_select(0, cell).float()
    return rows, bx, by


def _patch_sampler_from_rows(rows, bx, by, rp: RayParams):
    """Sampler over pre-gathered pair rows: each stage interpolates locally
    and blends the interpolated values in time."""
    ds = (rp.dx, rp.dy)   # derivative-channel scale (bicubic only)

    def sample(qx, qy, a):
        lx = (qx - rp.x0) / rp.dx - bx
        ly = (qy - rp.y0) / rp.dy - by
        return patch_interpolate_pair_shared(rows, lx, ly, a, method=rp.interp,
                                             deriv_scale=ds)

    return sample


def _make_patch_sampler(T_pair, p: Packets, rp: RayParams, ny: int, nx: int):
    """Gather + sampler in one call (the per-stage substep path)."""
    return _patch_sampler_from_rows(*_gather_patch_rows(T_pair, p, rp, ny, nx), rp)


def _axpy(p: Packets, d: Packets, h) -> Packets:
    return Packets(p.x + h * d.x, p.y + h * d.y, p.k + h * d.k, p.l + h * d.l, p.sign)


def _lincomb(p: Packets, ds, ws, h) -> Packets:
    acc = [torch.zeros_like(p.x)] * 4
    for d, w in zip(ds, ws):
        acc[0] = acc[0] + w * d.x
        acc[1] = acc[1] + w * d.y
        acc[2] = acc[2] + w * d.k
        acc[3] = acc[3] + w * d.l
    return Packets(p.x + h * acc[0], p.y + h * acc[1], p.k + h * acc[2],
                   p.l + h * acc[3], p.sign)


# Dormand-Prince 5(4) tableau
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
# embedded 4th-order weights of the pair (the error estimator)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)

# Fehlberg 7(8): the 7th-order solution is propagated, the 8th-order one
# estimates the error (the accuracy class of the reference's adaptive Vern7)
_F78_C = (0.0, 2 / 27, 1 / 9, 1 / 6, 5 / 12, 1 / 2, 5 / 6, 1 / 6, 2 / 3,
          1 / 3, 1.0, 0.0, 1.0)
_F78_A = (
    (),
    (2 / 27,),
    (1 / 36, 1 / 12),
    (1 / 24, 0.0, 1 / 8),
    (5 / 12, 0.0, -25 / 16, 25 / 16),
    (1 / 20, 0.0, 0.0, 1 / 4, 1 / 5),
    (-25 / 108, 0.0, 0.0, 125 / 108, -65 / 27, 125 / 54),
    (31 / 300, 0.0, 0.0, 0.0, 61 / 225, -2 / 9, 13 / 900),
    (2.0, 0.0, 0.0, -53 / 6, 704 / 45, -107 / 9, 67 / 90, 3.0),
    (-91 / 108, 0.0, 0.0, 23 / 108, -976 / 135, 311 / 54, -19 / 60, 17 / 6,
     -1 / 12),
    (2383 / 4100, 0.0, 0.0, -341 / 164, 4496 / 1025, -301 / 82, 2133 / 4100,
     45 / 82, 45 / 164, 18 / 41),
    (3 / 205, 0.0, 0.0, 0.0, 0.0, -6 / 41, -3 / 205, -3 / 41, 3 / 41, 6 / 41,
     0.0),
    (-1777 / 4100, 0.0, 0.0, -341 / 164, 4496 / 1025, -289 / 82, 2193 / 4100,
     51 / 82, 33 / 164, 12 / 41, 0.0, 1.0),
)
_F78_B7 = (41 / 840, 0.0, 0.0, 0.0, 0.0, 34 / 105, 9 / 35, 9 / 35, 9 / 280,
           9 / 280, 41 / 840, 0.0, 0.0)
_F78_B8 = (0.0, 0.0, 0.0, 0.0, 0.0, 34 / 105, 9 / 35, 9 / 35, 9 / 280,
           9 / 280, 0.0, 41 / 840, 41 / 840)

# name -> (C, A, propagated weights, error weights b_hi - b_lo, 1/(q+1))
_EMBEDDED_PAIRS = {
    "dopri5": (_DP_C, _DP_A, _DP_B,
               tuple(b - b4 for b, b4 in zip(_DP_B, _DP_B4)), 0.2),
    "rkf78": (_F78_C, _F78_A, _F78_B7,
              tuple(b8 - b7 for b7, b8 in zip(_F78_B7, _F78_B8)), 0.125),
}


def _step(p: Packets, sample, a0, da, h, rp: RayParams, method: str) -> Packets:
    """One substep from relative time a0 (in [0, 1] units of the flow
    step); da = h / (t1 - t0). ``sample(x, y, a)`` interpolates the 5
    fields."""
    if method == "rk4":
        k1 = _rhs(p, sample, a0, rp)
        k2 = _rhs(_axpy(p, k1, 0.5 * h), sample, a0 + 0.5 * da, rp)
        k3 = _rhs(_axpy(p, k2, 0.5 * h), sample, a0 + 0.5 * da, rp)
        k4 = _rhs(_axpy(p, k3, h), sample, a0 + da, rp)
        return _lincomb(p, (k1, k2, k3, k4), (1 / 6, 1 / 3, 1 / 3, 1 / 6), h)
    if method == "dopri5":
        ks = []
        for ci, ai in zip(_DP_C, _DP_A):
            q = _lincomb(p, ks, ai, h) if ai else p
            ks.append(_rhs(q, sample, a0 + ci * da, rp))
        return _lincomb(p, ks, _DP_B, h)
    if method == "midpoint":
        return _midpoint_step(p, sample, a0, da, h, rp)
    raise ValueError(f"unknown ray integrator {method!r}")


# implicit midpoint: terms of the Neumann series of the tangent solve
_NEUMANN_TERMS = 8


class _ImplicitRoot(torch.autograd.Function):
    """The converged midpoint slope ``z* = G(z*)`` with the reference's
    implicit VJP (``lax.custom_root`` with its Neumann ``tangent_solve``).

    ``apply(lin, z_star, *gz)``: ``z_star`` the solve's result (values
    only), ``gz = G(zl)`` evaluated at leaves ``zl`` holding ``z_star``,
    ``lin = (zl, gz)``. Returns ``z_star``. The backward maps the cotangent
    ``c`` to ``w = sum_{j=0..8} (J^T)^j c`` (J = dG/dz at z*), the
    transpose of the reference's 8-step Neumann solve of (I - J) u = v,
    and hands ``w`` to ``gz``, whose graph carries it to whatever G reads
    (fields, rows, positions, h). No iteration of the solve is
    differentiated."""

    @staticmethod
    def forward(ctx, lin, z_star, *gz):
        ctx.lin = lin
        return tuple(z.clone() for z in z_star)

    @staticmethod
    def backward(ctx, *c):
        zl, gz = ctx.lin
        w = c
        for _ in range(_NEUMANN_TERMS):
            jt = torch.autograd.grad(gz, zl, w, retain_graph=True)
            w = tuple(a + b for a, b in zip(c, jt))
        return (None, None, *w)


def _midpoint_step(p: Packets, sample, a0, da, h, rp: RayParams) -> Packets:
    """Implicit midpoint, solved as a converged fixed point of the midpoint
    slope z = G(z) = rhs(p + h/2 z) at a0 + da/2: iterate z <- G(z) from
    z = rhs(p) until the batch-max residual |z - G(z)| / (1e-8 + rtol |z|)
    is at most 1, or ``midpoint_maxit`` iterations (the host reads the
    residual after each). The iterations build no graph; gradients come
    from ``_ImplicitRoot``."""
    am = a0 + 0.5 * da

    def G(z):
        mid = Packets(p.x + 0.5 * h * z[0], p.y + 0.5 * h * z[1], p.k + 0.5 * h * z[2],
                      p.l + 0.5 * h * z[3], p.sign)
        d = _rhs(mid, sample, am, rp)
        return (d.x, d.y, d.k, d.l)

    def resid(fz, z):
        return torch.stack([torch.max(e.abs() / (1e-8 + rp.midpoint_rtol * zi.abs()))
                            for e, zi in zip(fz, z)]).max()

    d0 = _rhs(p, sample, am, rp)
    z = tuple(v.detach() for v in (d0.x, d0.y, d0.k, d0.l))
    gz = G(z)
    # G reads something that needs a gradient (fields, rows, packets, h)
    needs_grad = any(v.requires_grad for v in gz)
    with torch.no_grad():
        fz = tuple(a - b for a, b in zip(z, gz))
        i = 0
        while i < rp.midpoint_maxit:
            unconverged = resid(fz, z) > 1.0
            with observability.wait("rays.midpoint"):
                unconverged = bool(unconverged)
            if not unconverged:
                break
            z = tuple(a - b for a, b in zip(z, fz))
            fz = tuple(a - b for a, b in zip(z, G(z)))
            i += 1
    if needs_grad:
        zl = tuple(v.clone().requires_grad_() for v in z)
        gz = G(zl)
        z = _ImplicitRoot.apply((zl, gz), z, *gz)
    return Packets(p.x + h * z[0], p.y + h * z[1], p.k + h * z[2], p.l + h * z[3], p.sign)


def _use_patch(rp: RayParams) -> bool:
    return rp.gather == "patch" and rp.interp in PATCH_SHAPES


# The reference's patch-vs-taps crossover, measured on a TPU: the patch path
# builds a grid-sized table per flow step and then gathers one row per packet
# a substep; the taps path builds nothing and gathers every tap of every
# stage. Kept so that both packages pick the same path for a run;
# scripts/torch_gather_crossover.py measures where the H100's lies.
PATCH_TAPS_CROSSOVER = 8


def resolve_gather(rp: RayParams, n_packets: int, ny: int, nx: int) -> RayParams:
    """Replace ``gather='auto'`` by 'patch' iff ``PATCH_TAPS_CROSSOVER *
    n_packets >= ny * nx``, else 'taps'; 'patch' and 'taps' pass unchanged."""
    if rp.gather != "auto":
        return rp
    use_patch = rp.interp in PATCH_SHAPES and PATCH_TAPS_CROSSOVER * int(n_packets) >= ny * nx
    return rp._replace(gather="patch" if use_patch else "taps")


# --- fixed-step integration --------------------------------------------------

def _as_time(t, like: torch.Tensor) -> torch.Tensor:
    """A time as a 0-d tensor of the packets' dtype on their device."""
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def _substep_start(i: int, da: float, like: torch.Tensor) -> torch.Tensor:
    """a0 = i * da as a product in the packets' dtype, as the reference's
    traced ``i * da``."""
    return torch.full((), float(i), dtype=like.dtype, device=like.device) * da


def _raytrace_taps(packets, fields_old, fields_new, t0, t1, rp: RayParams,
                   nsubsteps: int, method: str) -> Packets:
    """Reference-semantics path: the taps sampler over the time-blended
    field stacks, ``_step`` per substep."""
    h = (_as_time(t1, packets.x) - _as_time(t0, packets.x)) / nsubsteps
    da = 1.0 / nsubsteps
    sample = _make_taps_sampler(fields_old, fields_new, rp)
    p = packets
    for i in range(nsubsteps):
        p = _step(p, sample, _substep_start(i, da, p.x), da, h, rp, method)
    return p


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
    table in ``nsubsteps`` fixed substeps. ``t0``/``t1`` are 0-d tensors
    (or floats), taken in the packets' dtype on their device. RK4 runs the
    fused substep over the pair table (``TableSubstep``); DP5 and midpoint
    run the per-stage path. The table is given, so ``rp.gather`` is not
    read, as in the reference."""
    check_ray_params(rp)
    h = (_as_time(t1, packets.x) - _as_time(t0, packets.x)) / nsubsteps
    da = 1.0 / nsubsteps
    p = packets
    for i in range(nsubsteps):
        a0 = _substep_start(i, da, p.x)
        if method == "rk4":
            st = torch.stack([p.x, p.y, p.k, p.l, p.sign])
            out = table_substep(T_pair, st, torch.stack([a0, h]), rp=rp, interp=rp.interp,
                                da=da, ny=ny, nx=nx)
            p = Packets(out[0], out[1], out[2], out[3], p.sign)
        else:
            p = _step(p, _make_patch_sampler(T_pair, p, rp, ny, nx), a0, da, h, rp, method)
    return p


def _patch_bwd_impl() -> str:
    """Backward formulation of the patch path, ``JRSW_PATCH_BWD`` (read at
    each call): 'table' (default: autograd through the table path, the
    row gather's backward a scatter-add into the pair table) or 'taps'
    (``_RaytracePatchFB``: the taps path's VJP at the same inputs)."""
    return os.environ.get("JRSW_PATCH_BWD", "table")


class _RaytracePatchFB(torch.autograd.Function):
    """The patch-table forward (``raytrace_tables``: ``TableSubstep`` for
    RK4) with a taps-formulation backward: ``_raytrace_taps`` at the same
    packets, fields and times, differentiated under autograd. ``T_pair``
    (a function of the fields) gets a zero cotangent, so nothing is
    counted twice. ``apply(cfg, x, y, k, l, sign, T_pair, fields_old,
    fields_new, t0, t1) -> (x, y, k, l)``."""

    @staticmethod
    def forward(ctx, cfg, x, y, k, l, sign, T_pair, fields_old, fields_new, t0, t1):
        rp, ny, nx, nsubsteps, method = cfg
        ctx.cfg = cfg
        ctx.save_for_backward(x, y, k, l, sign, fields_old, fields_new, t0, t1)
        out = raytrace_tables(Packets(x, y, k, l, sign), T_pair, t0, t1, rp, ny, nx,
                              nsubsteps, method)
        return out.x, out.y, out.k, out.l

    @staticmethod
    def backward(ctx, *g):
        rp, _, _, nsubsteps, method = ctx.cfg

        def taps(x, y, k, l, sign, fo, fn, t0, t1):
            return _raytrace_taps(Packets(x, y, k, l, sign), fo, fn, t0, t1, rp, nsubsteps,
                                  method)[:4]

        needs = ctx.needs_input_grad[1:6] + ctx.needs_input_grad[7:]
        d = recompute_vjp(ctx.saved_tensors, needs, g, taps)
        return (None, *d[:5], None, *d[5:])


def raytrace_tables_fb(
    packets: Packets,
    T_pair: torch.Tensor,
    fields_old,
    fields_new,
    t0,
    t1,
    rp: RayParams,
    ny: int,
    nx: int,
    nsubsteps: int = 1,
    method: str = "rk4",
) -> Packets:
    """``raytrace_tables`` with the backward ``JRSW_PATCH_BWD`` selects
    (``_patch_bwd_impl``); for callers that hold the (old, new) field
    stacks, as the coupled frame does."""
    if _patch_bwd_impl() == "taps":
        t0, t1 = _as_time(t0, packets.x), _as_time(t1, packets.x)
        cfg = (rp, ny, nx, nsubsteps, method)
        x, y, k, l = _RaytracePatchFB.apply(cfg, *packets, T_pair, fields_old, fields_new,
                                            t0, t1)
        return Packets(x, y, k, l, packets.sign)
    return raytrace_tables(packets, T_pair, t0, t1, rp, ny, nx, nsubsteps, method)


def raytrace(
    packets: Packets,
    fields_old,
    fields_new,
    t0,
    t1,
    rp: RayParams,
    nsubsteps: int = 1,
    method: str = "rk4",
) -> Packets:
    """Advance packets from t0 to t1 through linearly blended flow fields
    in fixed substeps, by the patch or the taps path (``rp.gather``,
    'auto' resolved for these packets and this grid)."""
    check_ray_params(rp)
    _, ny, nx = fields_old.shape
    rp = resolve_gather(rp, packets.n, ny, nx)
    if _use_patch(rp):
        return raytrace_tables_fb(packets, build_pair(fields_old, fields_new, rp),
                                  fields_old, fields_new, t0, t1, rp, ny, nx, nsubsteps,
                                  method)
    return _raytrace_taps(packets, fields_old, fields_new, t0, t1, rp, nsubsteps,
                          method)


def _select_channels(fields, sel, interp):
    """Slice base channels from a field stack; for the bicubic
    [f|fx|fy|fxy] layout the selection applies within each of the 4
    blocks."""
    if interp == "bicubic":
        F = fields.shape[0] // 4
        sel = [b * F + j for b in range(4) for j in sel]
    return fields[torch.as_tensor(sel, device=fields.device)]


def sample_velocity(packets: Packets, fields, rp: RayParams):
    """(u, v) at the packets' positions."""
    vals = interpolate(_select_channels(fields, [0, 1], rp.interp), packets.x,
                       packets.y, rp.x0, rp.y0, rp.dx, rp.dy, rp.interp)
    return vals[0], vals[1]


def sample_gradients(packets: Packets, fields, rp: RayParams):
    """(ux, uy, vx, vy) at the packets' positions; vy = -ux."""
    vals = interpolate(_select_channels(fields, [2, 3, 4], rp.interp), packets.x,
                       packets.y, rp.x0, rp.y0, rp.dx, rp.dy, rp.interp)
    return vals[0], vals[1], vals[2], -vals[0]


# --- adaptive integration ----------------------------------------------------

def fused_while(use_patch: bool, pair: str, loop: str) -> bool:
    """Whether ``raytrace_adaptive`` runs the fused attempt: the patch
    gather, pair 'dopri5' and loop 'while'. On the card that loop runs on
    the device and never waits on the host, so a CUDA graph can hold it."""
    return use_patch and pair == "dopri5" and loop == "while"


def _adapt(err, t, h, h_eff, done, eps, exponent):
    """The controller of one attempt slot at clock ``t`` and step ``h``,
    given the error norm ``err`` of the attempt of size ``h_eff`` (none when
    ``done``) -> (accept, reject, t_next, h_next)."""
    accept = (err <= 1.0) & ~done
    reject = (err > 1.0) & ~done
    t_next = torch.where(accept, t + h_eff, t)
    fac = torch.clip(0.9 * torch.clamp_min(err, 1e-10) ** (-exponent), 0.2, 5.0)
    h_next = torch.where(done, h, torch.maximum(h_eff * fac, eps))
    return accept, reject, t_next, h_next


def _while_on_device(loop: DeviceLoop):
    """The fused 'while' loop on the card: under a CUDA graph's capture one
    WHILE node that never waits; eager, slot after slot, the host reading
    the loop's test before the first and after each one."""
    if torch.cuda.is_current_stream_capturing():
        loop.capture()
    else:
        loop.start()
        with observability.wait("rays.adaptive"):
            go = loop.go()
        while go:
            with observability.span("rays.attempt"):
                loop.slot()
                with observability.wait("rays.adaptive"):
                    go = loop.go()
    return loop.packets(), loop.info()


def raytrace_adaptive(
    packets: Packets,
    fields_old,
    fields_new,
    t0,
    t1,
    rp: RayParams,
    rtol: float = 1e-5,
    atol: float = 1e-7,
    max_steps: int = 64,
    init_substeps: int = 4,
    pair: str = "dopri5",
    loop: str = "scan",
):
    """Adaptive embedded ray integration with one step size shared by the
    whole batch: Dormand-Prince 5(4) (``pair='dopri5'``) or Fehlberg 7(8)
    (``'rkf78'``). Hairer's mixed error norm over all packets, step factor
    0.9 (1/err)^(1/(q+1)) clipped to [0.2, 5]; a rejected attempt shrinks h
    and retries from the same positions (the per-stage attempt reusing the
    rows it gathered; the fused one reads them from the table again).

    ``loop='scan'`` runs exactly ``max_steps`` attempt slots, the finished
    ones masked, and never waits on the device; ``loop='while'`` stops once
    the clock reaches ``t1 - eps`` (or after ``max_steps`` slots) and waits
    on the device for that test before the first attempt and after each
    one (``utils/observability`` counts each such wait at the site
    'rays.adaptive'). Under a profiler the table build is the span
    ``rays.table`` and each attempt slot a span ``rays.attempt``.

    The patch gather with ``'dopri5'`` and ``'while'`` (``fused_while``)
    runs each attempt through ``table_attempt`` (the CUDA kernel on the
    card, which reads the pair table itself; its twin on the CPU), which
    scales the error by patch-local positions; every other combination runs
    the per-stage attempt, which scales it by global positions, as the
    reference does in each case. On the card that loop keeps its clock,
    step size, counters and test on the device (``ops/adaptive_loop``:
    three launches a slot); under a CUDA graph's capture it is one
    conditional WHILE node, which waits on nothing, and eager it gives the
    same bits with its waits.

    Returns ``(packets, info)``, info = dict of 0-d tensors ``t_reached``,
    ``h_final``, ``n_accepted``, ``n_rejected``; ``t_reached < t1`` means
    ``max_steps`` was too small for the tolerance.
    """
    if pair not in _EMBEDDED_PAIRS:
        raise ValueError(f"unknown embedded pair {pair!r}; "
                         f"available: {sorted(_EMBEDDED_PAIRS)}")
    if loop not in ("scan", "while"):
        raise ValueError(f"unknown loop {loop!r}; available: ['scan', 'while']")
    check_ray_params(rp)
    _, ny, nx = fields_old.shape
    rp = resolve_gather(rp, packets.n, ny, nx)
    dev = packets.x.device
    t0 = _as_time(t0, packets.x)
    t1 = _as_time(t1, packets.x)
    span = t1 - t0
    use_patch = _use_patch(rp)
    T_pair = None
    if use_patch:
        with observability.span("rays.table"):
            T_pair = build_pair(fields_old, fields_new, rp)
    C, A, BH, BE, exponent = _EMBEDDED_PAIRS[pair]
    fused = fused_while(use_patch, pair, loop)
    if fused and dev.type == "cuda":
        return _while_on_device(DeviceLoop(
            T_pair, packets, t0, t1, rp=rp, ny=ny, nx=nx, rtol=rtol, atol=atol,
            max_steps=max_steps, init_substeps=init_substeps, exponent=exponent))
    n_total = packets.n
    eps = 1e-9 * torch.abs(span)
    tols = torch.tensor([rtol, atol], dtype=packets.x.dtype, device=dev)

    def attempt(p, t, h, sample):
        """One per-stage attempt from (p, t) with size h -> (p_hi, sum of
        squared scaled component errors, scaled by global positions)."""
        a0 = (t - t0) / span
        dah = h / span
        ks = []
        for ci, ai in zip(C, A):
            q = _lincomb(p, ks, ai, h) if ai else p
            ks.append(_rhs(q, sample, a0 + ci * dah, rp))
        p5 = _lincomb(p, ks, BH, h)
        zero = Packets(*(torch.zeros_like(p.x),) * 4, p.sign)
        pe = _lincomb(zero, ks, BE, h)

        def comp_err(e, y5, y):
            sc = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y5))
            return (e / sc) ** 2

        e = (comp_err(pe.x, p5.x, p.x) + comp_err(pe.y, p5.y, p.y)
             + comp_err(pe.k, p5.k, p.k) + comp_err(pe.l, p5.l, p.l))
        return p5, torch.sum(e)

    def err_norm(e_sum):
        return torch.sqrt(e_sum / (4.0 * n_total))

    def body(p, t, h, gathered):
        """One attempt slot -> (p, t, h, accept, reject); ``gathered`` holds
        the rows of the packets' current positions (None on the taps path
        and for the fused attempt, which reads them itself)."""
        done = t >= t1 - eps
        h_eff = torch.minimum(h, t1 - t)
        h_att = torch.where(done, h, h_eff)
        if fused:
            st = torch.stack([p.x, p.y, p.k, p.l, p.sign])
            scal = torch.cat([torch.stack([(t - t0) / span, h_att / span, h_att]), tols])
            out5 = table_attempt(T_pair, st, scal, rp=rp, interp=rp.interp, ny=ny, nx=nx)
            p5 = Packets(out5[0], out5[1], out5[2], out5[3], p.sign)
            err = err_norm(torch.sum(out5[4]))
        else:
            sample = (_patch_sampler_from_rows(*gathered, rp) if use_patch
                      else _make_taps_sampler(fields_old, fields_new, rp))
            p5, e_sum = attempt(p, t, h_att, sample)
            err = err_norm(e_sum)
        accept, reject, t_next, h_next = _adapt(err, t, h, h_eff, done, eps, exponent)
        p_next = Packets(*(torch.where(accept, a, b) for a, b in zip(p5, p)))
        return p_next, t_next, h_next, accept, reject

    p, t, h = packets, t0, span / init_substeps
    nacc = torch.zeros((), dtype=torch.int32, device=dev)
    nrej = torch.zeros((), dtype=torch.int32, device=dev)
    gathers = use_patch and not fused
    if loop == "scan":
        # max_steps slots, none waiting on the device: once the clock has
        # reached t1 a slot is a no-op (nothing moves, nothing is counted),
        # and each slot gathers the rows of the packets' current positions
        for _ in range(max_steps):
            with observability.span("rays.attempt"):
                gathered = _gather_patch_rows(T_pair, p, rp, ny, nx) if gathers else None
                p, t, h, accept, reject = body(p, t, h, gathered)
                nacc = nacc + accept.to(torch.int32)
                nrej = nrej + reject.to(torch.int32)
        return p, dict(t_reached=t, h_final=h, n_accepted=nacc, n_rejected=nrej)
    # 'while' tests the clock on the host before every slot, the first
    # included; the test after a slot also says whether the packets moved
    # (then their rows are gathered anew; a rejected slot reuses them)
    go, slots, gathered = t < t1 - eps, 0, None
    with observability.wait("rays.adaptive"):
        go = bool(go)
    while go and slots < max_steps:
        with observability.span("rays.attempt"):
            if gathers and gathered is None:
                gathered = _gather_patch_rows(T_pair, p, rp, ny, nx)
            p, t, h, accept, reject = body(p, t, h, gathered)
            nacc = nacc + accept.to(torch.int32)
            nrej = nrej + reject.to(torch.int32)
            test = torch.stack([t < t1 - eps, accept])
            with observability.wait("rays.adaptive"):
                go, moved = test.tolist()
        if moved:
            gathered = None
        slots += 1
    return p, dict(t_reached=t, h_final=h, n_accepted=nacc, n_rejected=nrej)
