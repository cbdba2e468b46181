"""Slab-sharded spectral simulation and coupled rays, generic over models
(port of ``parallel/sharded.py``).

For grids too large to replicate (the reference's largest is a 2048^2
two-layer QG), the spectral state lives in kr-columns, one block a rank,
and every transform in ``calcN`` is a slab FFT (``parallel/fft``: local
FFT, ``all_to_all`` transpose, local FFT). The IF-AB3 step (matrix
exponential, AB3 history, dealiasing) is elementwise in spectral space,
so only the transposes cross ranks.

One process per rank: a rank holds its ``(C, nl, nkr_pad/P)`` column
block of the state, its columns of every per-mode constant (built on the
host in float64, zero-padded to ``nkr_pad``, so the pad columns of the
state stay exactly zero), and its ``N/P`` block of the packets. Per model
the deltas are:

- ``_build_L``: the host ``(C, C, nl, nkr)`` block or diagonal operator;
- ``_calcN_local``: the nonlinear right-hand side on one column block,
  written against ``local_rfft2``/``local_irfft2``;
- ``_psih_local``: the advecting streamfunction for the rays;
- ``_extra_consts``: the per-mode factors the two hooks need.

Coupled rays (``make_coupled_frame``): after each flow step the
interpolation fields are formed in y-slabs and ``all_gather``-ed to every
rank, each (old, new) pair of stacks becomes the pair table on every rank
(``rays/raytrace.build_pair``: on the card one ``csrc/pair_table.cu``
launch), and each rank advances its own packets (on the card through
``csrc/ray_step.cu``'s table form).

Instantiations: ``ShardedRSW`` and its variants (``parallel/sharded_rsw``),
and here ``ShardedTwoLayerQG``, ``ShardedSWQG``, ``ShardedThomasYamada``
and ``ShardedMultiLayerQG``. ``ny % P == 0`` is required.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.steppers import AB3_H1, AB3_H2, AB3_H3, AB3State, apply_L, expm_tables, tick
from ..models import multilayerqg as _mlqg
from ..models import twolayerqg as _tlqg
from ..rays.interp import bspline_prefilter_mask
from ..rays.packets import Packets
from ..rays.patch import PATCH_SHAPES
from ..rays.raytrace import (_raytrace_taps, _use_patch, build_pair, check_ray_params,
                             raytrace_tables, resolve_gather)
from ..rays.resample import k_cutoff_reset
from .fft import local_irfft2, local_rfft2, padded_nkr
from .mesh import Mesh, all_gather, all_gather_start

__all__ = ["ShardedSpectralModel", "ShardedTwoLayerQG", "ShardedSWQG",
           "ShardedThomasYamada", "ShardedMultiLayerQG", "SHARDED_RAY_METHODS"]

# the fixed-step ray integrators a sharded frame runs
SHARDED_RAY_METHODS = ("rk4", "dopri5", "midpoint")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclass
class ShardedSpectralModel:
    """Slab-sharded spectral stepping + coupled rays, generic over models::

        sh = ShardedTwoLayerQG(grid, params, mesh, dt=dt)
        sol_sh = sh.shard_solution(sol)          # the rank's column block
        init_fn, step_fn = sh.stepper()          # build_stepper's protocol
        fields = sh.fields(sol_sh)               # (5, ny, nx) on every rank
        frame = sh.make_coupled_frame(...)       # flow + the rank's packets
    """

    grid: object
    params: object
    mesh: Mesh
    dt: float
    interp: str = "bilinear"

    nfields = 0   # subclass responsibility

    # --- model hooks (subclass responsibility) -------------------------------
    def _build_L(self) -> np.ndarray:
        """Host (C, C, nl, nkr) block or (..., nl, nkr) diagonal operator."""
        raise NotImplementedError

    def _extra_consts(self) -> dict:
        """Extra host per-mode constants; one whose last axis is nkr (or
        nkr_pad) is zero-padded and cut to the rank's columns."""
        return {}

    def _calcN_local(self, solh, c: dict):
        """Nonlinear RHS on one column block (c: the rank's constants)."""
        raise NotImplementedError

    def _psih_local(self, sol, c: dict):
        """(nl, nkr_pad/P) advecting streamfunction block for the rays."""
        raise NotImplementedError

    # --- generic machinery ---------------------------------------------------
    def __post_init__(self):
        g, mesh = self.grid, self.mesh
        if g.ny % mesh.size:
            raise ValueError(f"ny={g.ny} not divisible by mesh size {mesh.size}")
        if self.interp not in PATCH_SHAPES:
            raise ValueError(f"unknown interp {self.interp!r}; available: "
                             f"{sorted(PATCH_SHAPES)}")
        self.nkr_pad = padded_nkr(g.nx, mesh.size)
        width = self.nkr_pad // mesh.size
        lo = mesh.rank * width
        hi = min(lo + width, g.nkr)
        self._cols = slice(lo, lo + width)   # the rank's padded columns

        # exp(L dt) of the rank's own modes only, zero in its pad columns
        L = self._build_L()
        if hi > lo:
            tables = [_host(e) for e in expm_tables(L[..., lo:hi], self.dt)]
        else:   # a rank of pad columns only
            tables = [np.zeros(L.shape[:-1] + (0,), np.complex64)] * 2
        self._expL, self._exp2L = (self._to_device(self._pad_cols(e, width)) for e in tables)

        kr = _host(g.kr).astype(np.float64)
        ell = _host(g.l).astype(np.float64)[:, None]
        fmask = (_host(bspline_prefilter_mask(g)) if self.interp == "bspline"
                 else np.ones((g.nl, g.nkr), np.float32))
        host = {
            "ik": (1j * kr[None, :]).astype(np.complex64),
            "il": (1j * ell).astype(np.complex64),          # (nl, 1), every rank
            "deal": _host(g.dealias_mask),
            "fmask": fmask,
        }
        host.update(self._extra_consts())
        self._consts = {k: self._put(np.asarray(a)) for k, a in host.items()}

    def _pad_cols(self, a: np.ndarray, width: int) -> np.ndarray:
        out = np.zeros(a.shape[:-1] + (width,), a.dtype)
        out[..., : a.shape[-1]] = a
        return out

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), device=self.mesh.device)

    def _put(self, a: np.ndarray) -> torch.Tensor:
        """A host constant on the mesh's device: the rank's columns of a
        per-mode one (last axis nkr or nkr_pad), the whole of any other."""
        if a.shape[-1] == self.grid.nkr:
            a = self._pad_cols(a, self.nkr_pad)
        if a.shape[-1] == self.nkr_pad:
            a = a[..., self._cols]
        return self._to_device(a)

    # --- state movement ------------------------------------------------------
    def shard_solution(self, sol) -> torch.Tensor:
        """A global (C, nl, nkr) state (a tensor on any device, or numpy)
        -> the rank's (C, nl, nkr_pad/P) block on the mesh's device. A
        channel-less (nl, nkr) state (SWQG) grows a leading C=1 axis."""
        sol = torch.as_tensor(sol).to(self.mesh.device)
        if sol.ndim == 2:
            sol = sol[None]
        block = sol[..., self._cols]      # cut at nkr: the pad columns are zeros
        pad = torch.zeros(block.shape[:-1] + (self._cols.stop - self._cols.start
                                              - block.shape[-1],),
                          dtype=block.dtype, device=block.device)
        return torch.cat([block, pad], dim=-1).contiguous()

    def unshard(self, sol_sh: torch.Tensor) -> torch.Tensor:
        """Gather the blocks and crop the pad -> (C, nl, nkr) on every rank
        (or (nl, nkr) where the model's state is channel-less)."""
        out = all_gather(sol_sh, -1, self.mesh)[..., : self.grid.nkr]
        if self.nfields == 1 and out.shape[0] == 1 and getattr(
                self, "_squeeze_channel", False):
            return out[0]
        return out

    # --- generic IF-AB3 step on local blocks ---------------------------------
    def _step_local(self, sol, step: int, N1, N2):
        """One IF-AB3 step of the rank's block (``core/steppers.make_ifab3``
        with the rank's tables; forward Euler while the host step < 3)."""
        N = self._calcN_local(sol, self._consts)
        dt = self.dt
        if step < 3:
            new = apply_L(self._expL, sol + dt * N)
        else:
            incr = dt * (AB3_H1 * N - AB3_H2 * apply_L(self._expL, N1)
                         + AB3_H3 * apply_L(self._exp2L, N2))
            new = apply_L(self._expL, sol + incr)
        return new, N, N1

    def _fields_start(self, sol):
        """Streamfunction -> interpolation fields: the local y-slab inverse
        transform, then the ``all_gather`` of the slabs started -> a
        function that waits for it and returns the (F, ny, nx) stack.
        F = 5, [u, v, ux, uy, vx] (bspline: with the prefilter folded in),
        or 20 for bicubic ([f | fx | fy | fxy] of those), as
        ``rays/raytrace.fields_from_psih``."""
        c = self._consts
        ik, il = c["ik"], c["il"]
        psih = self._psih_local(sol, c)
        uh = -il * psih
        vh = ik * psih
        stack = torch.stack([uh, vh, ik * uh, il * uh, ik * vh]) * c["fmask"]
        if self.interp == "bicubic":
            stack = torch.cat([stack, ik * stack, il * stack, ik * il * stack])
        phys = local_irfft2(stack, self.grid.nx, self.mesh)   # (F, ny/P, nx)
        return all_gather_start(phys, -2, self.mesh)

    def fields(self, sol_sh) -> torch.Tensor:
        """The (F, ny, nx) interpolation fields on every rank."""
        return self._fields_start(sol_sh)()

    # --- entry points --------------------------------------------------------
    def stepper(self):
        """(init_fn, step_fn) with the steppers' protocol on the rank's block."""
        dt = self.dt

        def init_fn(sol_sh):
            z = torch.zeros_like(sol_sh)
            return AB3State(z, z)

        def step_fn(sol, clock, state: AB3State):
            new, N1, N2 = self._step_local(sol, clock.step, state.N1, state.N2)
            return new, tick(clock, dt), AB3State(N1, N2)

        return init_fn, step_fn

    def make_coupled_frame(self, rp, flow_steps: int, ray_substeps: int = 1,
                           ray_method: str = "rk4", k_cutoff: float | None = None,
                           k0: float | None = None, overlap: bool = False,
                           n_packets: int | None = None):
        """``frame(sol, clock, sstate, packets) -> (sol, clock, sstate,
        packets)``: ``flow_steps`` sharded flow steps, each followed by a
        fixed-step ray step of the rank's packets through the (old, new)
        pair of gathered fields, as ``coupled/driver.make_coupled_frame``.

        ``rp.gather='auto'`` is resolved for ``n_packets``, the GLOBAL
        ensemble size, so every rank takes the same path.

        ``overlap=True`` runs the rays one flow interval behind the flow:
        each step advances the flow to t_{n+2} and starts the gather of its
        fields, then advances the packets through the gathered [t_n,
        t_{n+1}] pair while the gather is in flight (on the card the
        collective runs on NCCL's stream beside the ray kernel), then
        builds the t_{n+2} table. A final catch-up interval makes the
        trajectories identical to the sequential frame: the same pairs in
        the same order."""
        check_ray_params(rp)
        if ray_method not in SHARDED_RAY_METHODS:
            raise ValueError(f"a sharded frame runs ray_method in {SHARDED_RAY_METHODS}, "
                             f"not {ray_method!r}")
        if rp.interp != self.interp:
            raise ValueError(f"rp.interp={rp.interp!r} but the model's fields are built "
                             f"for {self.interp!r}")
        g = self.grid
        ny, nx = g.ny, g.nx
        if rp.gather == "auto":
            if n_packets is None:
                raise ValueError(
                    "rp.gather='auto' requires n_packets= so the frame can "
                    "resolve the patch-vs-taps crossover at build time")
            rp = resolve_gather(rp, n_packets, ny, nx)
        use_patch = _use_patch(rp)
        if overlap and not use_patch:
            raise ValueError("overlap=True requires the patch gather path")
        _, step_fn = self.stepper()

        def reset(packets):
            return packets if k_cutoff is None else k_cutoff_reset(packets, k_cutoff, k0)

        def trace(packets, fields_old, fields_new, t0, t1):
            packets = raytrace_tables(packets, build_pair(fields_old, fields_new, rp),
                                      t0, t1, rp, ny, nx, nsubsteps=ray_substeps,
                                      method=ray_method)
            return reset(packets)

        def sequential(sol, clock, sstate, packets, fields):
            for _ in range(flow_steps):
                t0 = clock.t
                sol, clock, sstate = step_fn(sol, clock, sstate)
                fields_new = self.fields(sol)
                if use_patch:
                    packets = trace(packets, fields, fields_new, t0, clock.t)
                else:
                    # taps gather straight from the gathered field stacks
                    packets = reset(_raytrace_taps(packets, fields, fields_new, t0, clock.t,
                                                   rp, ray_substeps, ray_method))
                fields = fields_new
            return sol, clock, sstate, packets

        def pipelined(sol, clock, sstate, packets, fields):
            # prologue: flow 0 -> 1 (no ray interval exists yet)
            t_prev = clock.t
            fields_prev = fields
            sol, clock, sstate = step_fn(sol, clock, sstate)
            fields_cur = self.fields(sol)
            for _ in range(flow_steps - 1):
                t_cur = clock.t
                sol, clock, sstate = step_fn(sol, clock, sstate)    # -> t_{n+2}
                gathered = self._fields_start(sol)                  # in flight
                packets = trace(packets, fields_prev, fields_cur, t_prev, t_cur)
                fields_prev, fields_cur, t_prev = fields_cur, gathered(), t_cur
            # epilogue: catch the rays up through the last interval
            packets = trace(packets, fields_prev, fields_cur, t_prev, clock.t)
            return sol, clock, sstate, packets

        body = pipelined if overlap else sequential

        def frame(sol, clock, sstate, packets: Packets):
            return body(sol, clock, sstate, packets, self.fields(sol))

        return frame


# -----------------------------------------------------------------------------
# Two-layer QG (the reference's largest-capacity model, 2048^2)
# -----------------------------------------------------------------------------

@dataclass
class ShardedTwoLayerQG(ShardedSpectralModel):
    """Slab-sharded equal-depth two-layer QG + coupled rays (``params``: a
    ``models/twolayerqg.TwoLayerParams``). ``advect``: the rays' advecting
    streamfunction, 'barotropic' (psi1+psi2)/2 or 'baroclinic'
    (psi1-psi2)/2."""

    advect: str = "barotropic"
    nfields = 2

    def _build_L(self):
        return _host(_tlqg.build_L(self.grid, self.params))

    def _extra_consts(self):
        K2 = _host(self.grid.Krsq).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            K2inv = np.where(K2 > 0, 1.0 / np.where(K2 > 0, K2, 1.0), 0.0)
        scale = K2inv / (K2 + 2.0 * self.params.F)
        return {"Krsq": K2.astype(np.float32), "scale": scale.astype(np.float32)}

    def _stretch_inv(self, qh, c):
        """psih from qh: the inverse stretching per mode
        (``models/twolayerqg.streamfunction_from_pv`` on one block)."""
        F = self.params.F
        qsum = qh[0] + qh[1]
        p1 = -(c["Krsq"] * qh[0] + F * qsum)
        p2 = -(c["Krsq"] * qh[1] + F * qsum)
        return torch.stack([p1, p2]) * c["scale"]

    def _calcN_local(self, solh, c):
        """Per-layer q_t = -J(psi_j, q_j) in conservative form."""
        ik, il, deal = c["ik"], c["il"], c["deal"]
        qh = solh * deal
        psih = self._stretch_inv(qh, c)
        phys = local_irfft2(torch.cat([qh, ik * psih, il * psih]), self.grid.nx, self.mesh)
        q, psix, psiy = phys[0:2], phys[2:4], phys[4:6]
        prodh = local_rfft2(torch.cat([psix * q, psiy * q]), self.nkr_pad, self.mesh)
        return (-il * prodh[0:2] + ik * prodh[2:4]) * deal

    def _psih_local(self, sol, c):
        psih = self._stretch_inv(sol, c)
        if self.advect == "baroclinic":
            return 0.5 * (psih[0] - psih[1])
        return 0.5 * (psih[0] + psih[1])


# -----------------------------------------------------------------------------
# One-layer equivalent-barotropic QG (diagonal L)
# -----------------------------------------------------------------------------

@dataclass
class ShardedSWQG(ShardedSpectralModel):
    """Slab-sharded SWQG + coupled rays (``params``: ``SWQGParams``). The
    state is carried as (1, nl, nkr_pad/P); ``shard_solution`` takes the
    model's channel-less (nl, nkr) layout and ``unshard`` returns it."""

    nfields = 1
    _squeeze_channel = True

    def _build_L(self):
        p = self.params
        return np.asarray(-p.nu * _host(self.grid.Krsq).astype(np.float64) ** p.nnu,
                          np.float32)

    def _extra_consts(self):
        K2 = _host(self.grid.Krsq).astype(np.float64)
        return {"ifac": (-1.0 / (K2 + self.params.Kd2)).astype(np.float32)}

    def _calcN_local(self, solh, c):
        """-J(psi, q) in conservative form on one block."""
        ik, il, deal = c["ik"], c["il"], c["deal"]
        qh = solh * deal
        psih = qh * c["ifac"]
        phys = local_irfft2(torch.cat([qh, ik * psih, il * psih]), self.grid.nx, self.mesh)
        q, psix, psiy = phys[0:1], phys[1:2], phys[2:3]
        prodh = local_rfft2(torch.cat([psix * q, psiy * q]), self.nkr_pad, self.mesh)
        return (-il * prodh[0:1] + ik * prodh[1:2]) * deal

    def _psih_local(self, sol, c):
        return (sol * c["ifac"])[0]


# -----------------------------------------------------------------------------
# Thomas-Yamada coupled barotropic/baroclinic model (diagonal L on 4 fields)
# -----------------------------------------------------------------------------

@dataclass
class ShardedThomasYamada(ShardedSpectralModel):
    """Slab-sharded Thomas-Yamada stepping (``params``: ``TYParams``).

    State (4, nl, nkr_pad/P): (zeta_t, u_c, v_c, p_c), stepped by the
    sharded IF-AB3 (the reference's ETDAB3 scheme class; the replicated
    path also offers ETDRK4). The rays' streamfunction is the barotropic
    psi_t = -zeta_t / K^2."""

    nfields = 4

    def _build_L(self):
        p = self.params
        D = -p.nu * _host(self.grid.Krsq).astype(np.float64) ** p.nnu
        return np.broadcast_to(D, (4,) + D.shape).astype(np.float32)

    def _extra_consts(self):
        g = self.grid
        return {
            "k": _host(g.kr).astype(np.float32)[None, :],
            "lr": _host(g.l).astype(np.float32)[:, None],   # (nl, 1), every rank
            "invK": _host(g.invKrsq).astype(np.float32),
        }

    def _calcN_local(self, solh, c):
        """``models/thomasyamada`` calcN on one column block: the 11-field
        inverse and 10-product forward transforms as slab FFTs."""
        ik, il, deal = c["ik"], c["il"], c["deal"]
        k, l, invK = c["k"], c["lr"], c["invK"]
        Ro = self.params.Ro
        solh = solh * deal
        zth, uch, vch, pch = solh.unbind(0)
        psith = -zth * invK
        uth = -il * psith
        vth = ik * psith
        stack = torch.stack([zth, uth, vth, uch, vch, il * uch, ik * vch, il * uth, ik * vth,
                             ik * pch, il * pch])
        zt, ut, vt, uc, vc, ucy, vcx, uty, vtx, pcx, pcy = (
            local_irfft2(stack, self.grid.nx, self.mesh).unbind(0))
        prods = torch.stack([
            ut * zt, vt * zt,
            uc * vc, uc * uc, vc * vc,
            ut * uc, vt * vc,
            vt * ucy + vc * uty,
            ut * vcx + uc * vtx,
            ut * pcx + vt * pcy,
        ])
        (utzt, vtzt, ucvc, uc2, vc2, utuc, vtvc, uc_cross, vc_cross,
         pc_adv) = local_rfft2(prods, self.nkr_pad, self.mesh).unbind(0)
        Nzt = -Ro * (1j * k * utzt + 1j * l * vtzt + (-(k ** 2) + l ** 2) * ucvc
                     + k * l * (uc2 - vc2))
        Nuc = vch - 1j * k * pch - Ro * (1j * k * utuc + uc_cross)
        Nvc = -uch - 1j * l * pch - Ro * (1j * l * vtvc + vc_cross)
        Npc = -1j * k * uch - 1j * l * vch - Ro * pc_adv
        return torch.stack([Nzt, Nuc, Nvc, Npc]) * deal

    def _psih_local(self, sol, c):
        return -sol[0] * c["invK"]


# -----------------------------------------------------------------------------
# General n-layer QG (models/multilayerqg)
# -----------------------------------------------------------------------------

@dataclass
class ShardedMultiLayerQG(ShardedSpectralModel):
    """Slab-sharded n-layer QG (``params``: ``MultiLayerParams``). The
    per-mode n x n inverse stretching matrix is a column-block constant
    applied as a multiply and a sum over the input layer; the rays'
    streamfunction is the depth-weighted mean sum_j delta_j psi_j."""

    def __post_init__(self):
        self.nfields = self.params.nlayers
        super().__post_init__()

    def _build_L(self):
        return _host(_mlqg.build_L(self.grid, self.params))

    def _extra_consts(self):
        return {"Sinv": _mlqg._sinv(self.grid, self.params).astype(np.float32)}

    def _psi_from_q(self, qh, c):
        return (c["Sinv"] * qh.unsqueeze(0)).sum(1)

    def _calcN_local(self, solh, c):
        """Per-layer J(psi_j, q_j) advection (mean flow and PV gradients
        are in L) on one block."""
        ik, il, deal = c["ik"], c["il"], c["deal"]
        n = self.params.nlayers
        qh = solh * deal
        psih = self._psi_from_q(qh, c)
        phys = local_irfft2(torch.cat([qh, ik * psih, il * psih]), self.grid.nx, self.mesh)
        q, psix, psiy = phys[0:n], phys[n:2 * n], phys[2 * n:3 * n]
        prodh = local_rfft2(torch.cat([psix * q, psiy * q]), self.nkr_pad, self.mesh)
        return (-il * prodh[0:n] + ik * prodh[n:2 * n]) * deal

    def _psih_local(self, sol, c):
        psih = self._psi_from_q(sol, c)
        w = torch.as_tensor(np.asarray(self.params.delta, np.float32), device=psih.device)
        return (w[:, None, None] * psih).sum(0)
