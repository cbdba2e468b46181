"""Coupled PDE <-> ray-tracing driver (port of ``coupled/driver.py``).

- ``derive_dt`` / ``derive_nu``: CFL-tuned time step and hyperviscosity.
- ``make_coupled_frame``: K flow steps, each an IF-AB3 flow step followed
  by a ray step from the old to the new snapshot: fixed RK4, DP5 or
  implicit-midpoint substeps through the (old|new) pair table of the two
  snapshots (``rays/raytrace.build_pair``, one table a flow step) or
  through the taps path, or the adaptive integrator
  (``ray_method='adaptive'``: DP5(4), ``'adaptive7'``: Fehlberg 7(8)),
  which builds its own pair table from the two snapshots; with
  ``birth_death`` the ensemble is resampled after each ray step
  (``rays/resample.weibull_birth_death``, one kernel launch on the card).
  With ``remat`` each interleaved step is checkpointed for the backward
  pass.
- ``make_flow_frame``: flow-only steps (spinup).
- ``CoupledDriver``: the host loop around the frames, with spinup, the NaN
  guard, rolling HDF5 outputs (snapshots, packet and population
  telemetry), diagnostics, the live dashboard, CFL/walltime logging and
  bit-exact checkpoints (the birth/death key included).

A frame is a Python loop that enqueues device work. On the card a frame
replays as one CUDA graph (``torch.cuda.CUDAGraph``, one
``cudaGraphLaunch``) wherever it can: from its second call on, when
nothing in the state requires grad, ``remat`` is off, the host's
``clock.step`` is past the steppers' forward-Euler bootstrap
(``core/steppers.BOOTSTRAP_STEPS``) and the host never tests a loop of
the ray step (every flow frame; the coupled frames of ``rk4``, ``dopri5``
and ``adaptive`` where its loop runs on the device, the patch gather's
'while' loop (``rays/raytrace.fused_while``); not ``midpoint``,
``adaptive7`` or any other ``adaptive``). The first call runs
eager: it creates the cuFFT plans and loads the kernels the capture then
records. The capture clones the state into the graph's static buffers,
and every replay leaves its result there, so ``drv.sim``'s tensors are
the driver's own, overwritten by the next frame: copy them to keep them.
A graphed adaptive frame writes each step's info into static buffers of
the graph, and the driver appends copies of them to ``ray_infos`` after
each replay.
``observability.graph_frames`` counts how each frame ran
(``eager.<reason>`` from ``observability.GRAPH_REASONS``). The kernels'
launch counters (``ops/ray_step``, ``ops/pair_table``, ``ops/birth_death``) and the taps
gathers' (``rays/interp.taps_gathers``) count the host's launches, a
capture's included; a replay runs the kernels it holds with
no host call, and counts only in ``graph_frames["replayed"]``.

After each coupled frame the host reads the frame's tail
(``frame_tail``): the NaN guard's flag, the clock, the diagnostics the
frame records and the scalar the log line needs, computed on the device
into one buffer of their bytes and copied to the host with one wait
(``driver.frame_tail``). After a graphed frame the tail is a small CUDA
graph of its own (``_TailGraph``), one for each set of parts the
frames' cadence asks for, replayed behind the frame's graph into a pinned
buffer; after an eager frame it runs eagerly. ``observability.frame_tails``
counts both. The host waits again after a spin-up chunk, in its NaN
guard, and where a frame's outputs go to the host: one copy of the packet
telemetry and one of each snapshot. Every such wait is counted by site in
``utils/observability.waits``. Under a running ``torch.profiler`` each
stage is a span (``utils/observability.span``): ``frame.coupled``/
``frame.flow`` around a frame (around its replay, for a graph),
``flow.step``, ``rays.fields``, ``rays.table``, ``rays.step`` or
``rays.adaptive`` (on the taps path a ``rays.taps`` in it a stage),
``rays.reset``, ``rays.birth_death`` inside an eager frame, and
``driver.frame_tail`` (``driver.nan_guard`` after a spin-up chunk),
``driver.outputs``, ``driver.live``, ``driver.log`` after it, each wait a
span ``wait.<site>``. Everything in a frame is differentiable but the
adaptive integrator's 'while' loop and its fused attempt, which are
forward only, as in the reference.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.steppers import BOOTSTRAP_STEPS, Clock, zero_clock
from ..models.base import Model, build_stepper
from ..rays.interp import bspline_prefilter_mask
from ..rays.packets import Packets
from ..rays.raytrace import (RayParams, _use_patch, build_pair, check_ray_params,
                             fields_from_psih, fused_while, raytrace, raytrace_adaptive,
                             raytrace_tables_fb, resolve_gather, sample_gradients,
                             sample_velocity)
from ..rays.prng import prng_key
from ..rays.resample import (BirthDeathState, init_birth_death, k_cutoff_reset,
                             weibull_birth_death)
from ..utils.observability import frame_tails, graph_frames, span, wait

__all__ = [
    "derive_dt", "derive_nu", "SimState", "make_coupled_frame",
    "make_flow_frame", "CoupledDriver", "RAY_METHODS", "HOST_WAIT_METHODS",
    "eager_reason", "frame_tail", "unpack_tail",
]

# fixed-step integrators, then the adaptive ones
RAY_METHODS = ("rk4", "dopri5", "midpoint", "adaptive", "adaptive7")
# the ray methods whose step may wait on the device: implicit midpoint in
# its Newton loop, the adaptive integrators after each attempt (but DP5(4)
# in the 'while' loop over the pair table, whose loop runs on the card)
HOST_WAIT_METHODS = ("midpoint", "adaptive", "adaptive7")
# the embedded pair of each adaptive method
ADAPTIVE_PAIRS = {"adaptive": "dopri5", "adaptive7": "rkf78"}


def derive_dt(cfltune: float, umax: float, dx: float) -> float:
    """dt = cfltune / umax * dx."""
    return cfltune / umax * dx


def derive_nu(nutune: float, nx: int, nnu: int, dt: float) -> float:
    """nu = nutune * (2 pi / nx) / kmax^{2 nnu} / dt with kmax = nx/2 - 1."""
    kmax = nx / 2 - 1
    return nutune * 2.0 * np.pi / nx / (kmax ** (2 * nnu)) / dt


class SimState(NamedTuple):
    """Full coupled simulation state, in float32 (complex64 ``sol``) or
    float64 (complex128). ``bd`` (when birth/death resampling is on)
    carries the ensemble's ages, lifetimes, birth count and the PRNG key,
    so a checkpoint continues the same stochastic stream."""

    sol: torch.Tensor
    clock: Clock
    stepper_state: tuple | NamedTuple
    packets: Packets
    fields: torch.Tensor   # (5, ny, nx) interpolation fields; (20, ny, nx) bicubic
    bd: BirthDeathState | None = None


def _prefilter(grid, interp: str) -> torch.Tensor | None:
    """The B-spline prefilter of a frame's fields, made once when the frame
    is built (it is made on the host: a CUDA graph cannot capture that)."""
    return bspline_prefilter_mask(grid) if interp == "bspline" else None


def _check_ray_method(ray_method: str) -> None:
    if ray_method not in RAY_METHODS:
        raise ValueError(f"unknown ray_method {ray_method!r}; available: {RAY_METHODS}")


def make_coupled_frame(
    model: Model,
    step_fn: Callable,
    psih_fn: Callable,
    rp: RayParams,
    flow_steps: int,
    ray_substeps: int = 1,
    ray_method: str = "rk4",
    k_cutoff: float | None = None,
    k0: float | None = None,
    frozen_flow: bool = False,
    dt: float | None = None,
    remat: bool = False,
    birth_death: dict | None = None,
    ray_opts: dict | None = None,
    ray_info_fn: Callable | None = None,
    n_packets: int | None = None,
):
    """``frame(sim) -> sim``: ``flow_steps`` interleaved flow/ray steps.

    ``psih_fn(sol) -> psih`` extracts the advecting streamfunction. With
    ``frozen_flow`` only the clock advances (by ``dt``) and the packets
    trace the fixed fields. ``remat=True`` checkpoints each interleaved
    step (``torch.utils.checkpoint``, the counterpart of the reference's
    ``jax.checkpoint``): the backward pass recomputes a step instead of
    keeping its intermediates. ``birth_death`` = dict(k_shape=, lam=) resamples
    the ensemble after each ray step (and the k-cutoff reset) over the
    step's ``clock.t - t0``, new positions in the domain from ``(rp.x0,
    rp.y0)``; it needs ``SimState.bd`` (``rays/resample.init_birth_death``).
    ``ray_opts`` go to ``raytrace_adaptive`` for
    the adaptive methods (rtol, atol, max_steps, init_substeps, loop,
    pair); ``ray_info_fn``, if given, is called with the info dict of each
    flow step's adaptive integration (once, not again when a checkpointed
    step is recomputed). ``rp.gather='auto'`` is resolved here for
    ``n_packets`` packets (``rays/raytrace.resolve_gather``), which it then
    needs."""
    _check_ray_method(ray_method)
    check_ray_params(rp)
    if rp.gather == "auto":
        if n_packets is None:
            raise ValueError(
                "rp.gather='auto' requires n_packets= so the frame can "
                "resolve the patch-vs-taps crossover at build time")
        rp = resolve_gather(rp, n_packets, model.grid.ny, model.grid.nx)
    if frozen_flow and dt is None:
        raise ValueError("frozen_flow=True needs dt")
    grid = model.grid
    ny, nx = grid.ny, grid.nx
    adaptive = ray_method in ("adaptive", "adaptive7")
    # the adaptive integrator builds its own pair table from the fields
    use_patch = _use_patch(rp) and not adaptive
    prefilter = _prefilter(grid, rp.interp)
    ray_opts = dict(ray_opts or {})
    if adaptive:
        ray_opts.setdefault("pair", ADAPTIVE_PAIRS[ray_method])

    def one(sol, clock, sstate, packets, fields_old, bd):
        """One interleaved flow/ray step -> the next carry and the adaptive
        info (None for the fixed-step methods)."""
        t0, info = clock.t, None
        if frozen_flow:
            clock = Clock(clock.t + dt, clock.step + 1)
            fields = fields_old
        else:
            with span("flow.step"):
                sol, clock, sstate = step_fn(sol, clock, sstate)
            with span("rays.fields"):
                fields = fields_from_psih(psih_fn(sol), grid, rp.interp, prefilter)
        if adaptive:
            with span("rays.adaptive"):
                packets, info = raytrace_adaptive(packets, fields_old, fields, t0, clock.t, rp,
                                                  **ray_opts)
        elif use_patch:
            with span("rays.table"):
                T_pair = build_pair(fields_old, fields, rp)
            with span("rays.step"):
                packets = raytrace_tables_fb(packets, T_pair, fields_old, fields, t0, clock.t,
                                             rp, ny, nx, nsubsteps=ray_substeps,
                                             method=ray_method)
            del T_pair    # freed once the ray step has read it, before the reset allocates
        else:
            with span("rays.step"):
                packets = raytrace(packets, fields_old, fields, t0, clock.t, rp,
                                   nsubsteps=ray_substeps, method=ray_method)
        if k_cutoff is not None:
            with span("rays.reset"):
                packets = k_cutoff_reset(packets, k_cutoff, k0)
        if birth_death is not None:
            with span("rays.birth_death"):
                packets, bd, _ = weibull_birth_death(
                    packets, bd, clock.t - t0, grid.Lx, grid.Ly, k0,
                    k_shape=birth_death.get("k_shape", 1.5), lam=birth_death.get("lam", 10.0),
                    x0=rp.x0, y0=rp.y0)
        return (sol, clock, sstate, packets, fields, bd), info

    def frame(sim: SimState) -> SimState:
        if birth_death is not None and sim.bd is None:
            raise ValueError("birth_death needs SimState.bd (rays/resample.init_birth_death)")
        with span("frame.coupled"):
            carry = (sim.sol, sim.clock, sim.stepper_state, sim.packets, sim.fields, sim.bd)
            for _ in range(flow_steps):
                if remat:
                    carry, info = checkpoint(one, *carry, use_reentrant=False)
                else:
                    carry, info = one(*carry)
                if info is not None and ray_info_fn is not None:
                    ray_info_fn(info)
            sol, clock, sstate, packets, fields, bd = carry
            return SimState(sol, clock, sstate, packets, fields, bd)

    return frame


def make_flow_frame(model: Model, step_fn, psih_fn, rp: RayParams, flow_steps: int):
    """``frame(sim) -> sim``: flow-only steps, then refresh the fields."""
    grid = model.grid
    prefilter = _prefilter(grid, rp.interp)

    def frame(sim: SimState) -> SimState:
        with span("frame.flow"):
            sol, clock, sstate = sim.sol, sim.clock, sim.stepper_state
            for _ in range(flow_steps):
                with span("flow.step"):
                    sol, clock, sstate = step_fn(sol, clock, sstate)
            with span("rays.fields"):
                fields = fields_from_psih(psih_fn(sol), grid, rp.interp, prefilter)
            return SimState(sol, clock, sstate, sim.packets, fields, sim.bd)

    return frame


def eager_reason(device: torch.device, requires_grad: bool, remat: bool,
                 ray_method: str | None, step: int, calls: int, gather: str,
                 loop: str) -> str | None:
    """Why a frame runs eager (one of ``observability.GRAPH_REASONS``), or
    None when it may run as a CUDA graph: the state's ``device``, whether a
    state tensor ``requires_grad``, ``remat``, the coupled frame's
    ``ray_method`` (None for a flow frame), the host's ``clock.step`` at the
    frame's start, the ``calls`` of the same frame made before, and the
    ray step's ``gather`` ('patch' or 'taps', as resolved) and adaptive
    ``loop`` ('while' or 'scan'): the host tests the loop of ``midpoint``,
    ``adaptive7`` and ``adaptive`` but where ``rays/raytrace.fused_while``
    holds (on the card its loop runs on the device)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    if requires_grad or remat:
        return "grad"
    if ray_method in HOST_WAIT_METHODS and not (
            ray_method in ADAPTIVE_PAIRS
            and fused_while(gather == "patch", ADAPTIVE_PAIRS[ray_method], loop)):
        return "loop"
    if step < BOOTSTRAP_STEPS:
        return "bootstrap"
    if calls < 1:
        return "first_call"
    return None


def _carried(sim: SimState, kind: str) -> list:
    """The state tensors a frame of ``kind`` reads or writes, in a fixed
    order; a flow frame passes the packets and the birth/death state on
    untouched."""
    leaves = [sim.sol, sim.clock.t, *sim.stepper_state, sim.fields]
    if kind == "coupled":
        leaves += [*sim.packets, *(sim.bd or ())]
    return leaves


def _with_carried(sim: SimState, kind: str, leaves: list, step: int) -> SimState:
    """``sim`` with the tensors ``_carried`` lists replaced by ``leaves``
    and the host's step count ``step``."""
    it = iter(leaves)
    sol, t = next(it), next(it)
    sstate = type(sim.stepper_state)(*(next(it) for _ in sim.stepper_state))
    fields = next(it)
    if kind != "coupled":
        return SimState(sol, Clock(t, step), sstate, sim.packets, fields, sim.bd)
    packets = Packets(*(next(it) for _ in sim.packets))
    bd = None if sim.bd is None else BirthDeathState(*(next(it) for _ in sim.bd))
    return SimState(sol, Clock(t, step), sstate, packets, fields, bd)


def _copy_back(static: list, leaves: list) -> None:
    """``s.copy_(t)`` for each buffer ``s`` and tensor ``t`` that is not
    ``s`` itself: first the tensors that are buffers (or views of one), then
    the others, so that every buffer is read before it is overwritten
    (AB3's N2 <- N1 before N1 <- N; the steppers' states shift one slot at
    most)."""
    ptrs = {s.untyped_storage().data_ptr() for s in static}
    pairs = [(s, t) for s, t in zip(static, leaves) if t is not s]
    for s, t in sorted(pairs, key=lambda p: p[1].untyped_storage().data_ptr() not in ptrs):
        s.copy_(t)


class _FrameGraph:
    """One frame captured as a CUDA graph over static state buffers.

    ``buffers`` clones the state's tensors into the buffers, so that no
    tensor a caller holds is ever written and no two buffers alias (as
    ``init``'s ``AB3State(z, z)`` does). ``capture`` records the frame, then
    the copies of its outputs back into the buffers, and of the adaptive
    steps' infos into ``info`` ((steps, 2) float32 t_reached, h_final and
    (steps, 2) int32 n_accepted, n_rejected). ``replay`` copies a
    state the driver was handed (by ``init``, ``restore`` or a ``sim`` put
    in place) into the buffers, replays, and returns the state over the
    buffers; ``step_infos`` copies of the replay's infos. The kernels'
    launch counters count the capture's launches, not the replays': a
    replay runs them with no host call. ``tails`` holds the frame's tail
    graphs over its buffers, by the parts they read (``_TailGraph``)."""

    def __init__(self, frame: Callable, kind: str, flow_steps: int):
        self.frame, self.kind, self.flow_steps = frame, kind, flow_steps
        self.static: list = []
        self.graph = None
        self.info: tuple | None = None
        self.tails: dict = {}

    def buffers(self, sim: SimState) -> SimState:
        self.static = [t.clone() for t in _carried(sim, self.kind)]
        return _with_carried(sim, self.kind, self.static, sim.clock.step)

    def capture(self, sim: SimState, infos: list) -> None:
        """Record the frame; ``infos`` is the list its ``ray_info_fn``
        appends to, of which the capture's own entries are taken out (a
        capture runs nothing: the replays write their values)."""
        n0 = len(infos)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(sim.sol.device), torch.no_grad(), \
                torch.cuda.graph(self.graph):
            _copy_back(self.static, _carried(self.frame(sim), self.kind))
            taken = infos[n0:]
            if taken:
                self.info = tuple(torch.stack([i[key] for i in taken for key in keys]).view(-1, 2)
                                  for keys in (("t_reached", "h_final"),
                                               ("n_accepted", "n_rejected")))
        del infos[n0:]
        graph_frames["captured"] += 1

    def replay(self, sim: SimState) -> SimState:
        handed = _carried(sim, self.kind)
        for s, t in zip(self.static, handed):
            if (s.shape, s.dtype, s.device) != (t.shape, t.dtype, t.device):
                raise ValueError(
                    f"the state's {tuple(t.shape)} {t.dtype} tensor on {t.device} does not "
                    f"fit the frame's {tuple(s.shape)} {s.dtype} buffer on {s.device}: "
                    "start a state of other shapes with init()")
        with span(f"frame.{self.kind}"):
            _copy_back(self.static, handed)
            self.graph.replay()
        graph_frames["replayed"] += 1
        return _with_carried(sim, self.kind, self.static, sim.clock.step + self.flow_steps)

    def step_infos(self) -> list[dict]:
        """The last replay's adaptive infos, one a flow step, as 0-d views
        of copies of the graph's buffers (none for other frames)."""
        if self.info is None:
            return []
        times, counts = (b.clone() for b in self.info)
        return [dict(t_reached=t[0], h_final=t[1], n_accepted=c[0], n_rejected=c[1])
                for t, c in zip(times, counts)]


def frame_tail(sim: SimState, model: Model, diagnostics: dict, log: bool
               ) -> tuple[torch.Tensor, tuple]:
    """What the host reads after a coupled frame, computed on the state's
    device -> (the values' bytes in one uint8 tensor, their layout): the
    NaN guard's ``isfinite(sol.abs().max())`` as ``finite``, ``clock.t``
    as ``t``, each of ``diagnostics`` (name -> ``fn(sol, grid, params)``)
    as ``diag.<name>`` and, with ``log``, the log line's
    ``fields[:2].abs().max()`` as ``umax``. Each value is the same op on
    the same state as when it was read on its own, and its bytes are
    copied unconverted, so ``unpack_tail`` gives it back bit for bit;
    the layout is each value's (name, numpy dtype, shape), in order."""
    parts = {"finite": torch.isfinite(sim.sol.abs().max()), "t": sim.clock.t}
    for name, fn in diagnostics.items():
        parts["diag." + name] = fn(sim.sol, model.grid, model.params).detach()
    if log:
        parts["umax"] = sim.fields[:2].abs().max()
    layout = tuple((name, torch.empty(0, dtype=p.dtype).numpy().dtype, tuple(p.shape))
                   for name, p in parts.items())
    return torch.cat([p.reshape(-1).view(torch.uint8) for p in parts.values()]), layout


def unpack_tail(host: np.ndarray, layout: tuple) -> dict:
    """``frame_tail``'s bytes, on the host -> {name: a numpy array of the
    value's dtype and shape, owning its memory}."""
    values, at = {}, 0
    for name, dtype, shape in layout:
        n = dtype.itemsize * math.prod(shape)
        values[name] = host[at:at + n].view(dtype).reshape(shape).copy()
        at += n
    return values


class _TailGraph:
    """A frame's tail (``tail(sim) -> (bytes, layout)``, ``frame_tail``
    with its parts chosen) captured as a CUDA graph over a frame graph's
    buffers, after one eager run that loads its kernels. ``replay`` runs
    it behind the frame's replay and queues the copy of its bytes into a
    pinned host buffer, with no wait; ``synchronize`` is the wait."""

    def __init__(self, tail: Callable, sim: SimState):
        with torch.no_grad():
            tail(sim)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(sim.sol.device), torch.no_grad(), \
                torch.cuda.graph(self.graph):
            self.packed, self.layout = tail(sim)
        self.host = torch.empty(self.packed.shape, dtype=torch.uint8,
                                pin_memory=self.packed.is_cuda)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        self.host.copy_(self.packed, non_blocking=True)
        return self.host

    def synchronize(self) -> None:
        if self.packed.is_cuda:
            torch.cuda.current_stream(self.packed.device).synchronize()


@dataclass
class CoupledDriver:
    """Host-side experiment orchestration::

        drv = CoupledDriver(model, psih_fn, rp, dt=dt, stepper="IFMAB3", ...)
        drv.init(sol0, packets)
        drv.spinup(n_spinup_steps)
        drv.run(n_frames, flow_steps_per_frame)

    After ``run``, ``ray_infos`` holds the info dicts of its flow steps'
    adaptive integrations (``raytrace_adaptive``), in order; it stays empty
    for the fixed-step ray methods.

    ``remat=True`` checkpoints each coupled step of a frame for the
    backward pass (``make_coupled_frame``).

    On the card the flow frames, the ``rk4``/``dopri5`` coupled frames and
    the ``adaptive`` ones whose loop runs on the device replay as CUDA
    graphs from their second call on, once the stepper's bootstrap is past
    and nothing requires grad (the module's docstring says when exactly);
    the midpoint, ``adaptive7`` and other adaptive frames, and every frame
    on the CPU, run eager. ``sim``'s tensors are the driver's own buffers,
    which the next frame overwrites: copy them to keep them. The capture
    clones the state into the buffers, and a state handed in later
    (``init``, ``restore``, or a ``sim`` put in place) is copied into them:
    a caller's tensors are never written.

    Outputs: ``snapshot_writer`` and ``packet_writer`` (``io/output``
    ``SequencedWriter``s) take the problem's header at ``init``, each
    frame's packet telemetry (positions, wavenumbers, velocities and, with
    ``write_gradients``, velocity gradients at the packets) and every
    ``snapshot_every``-th frame's solution; ``diagnostics`` (name ->
    ``fn(sol, grid, params)``) are recorded every ``diag_every_frames``
    frames into ``diag_times``/``diag_series`` and written by
    ``save_diagnostics``. ``checkpoint``/``restore`` save and load the whole
    ``SimState`` in the format the JAX package reads and writes.

    ``birth_death=True`` resamples the ensemble each coupled step (Weibull
    shape ``bd_k_shape``, scale ``bd_lam``, key ``prng_key(bd_seed)``,
    float32 ages and lifetimes); each packet frame then also writes
    ``p/births/<step>`` and ``p/mean_age/<step>``. ``live`` (a
    ``utils/live.LiveDashboard``) is refreshed after each frame.
    """

    model: Model
    psih_fn: Callable
    rp: RayParams
    dt: float
    stepper: str = "IFMAB3"
    use_filter: bool = False
    filter_kwargs: dict | None = None
    ray_substeps: int = 1
    ray_method: str = "rk4"        # one of RAY_METHODS
    ray_opts: dict | None = None   # adaptive: rtol/atol/max_steps/...
    k_cutoff: float | None = None
    k0: float | None = None
    frozen_flow: bool = False
    remat: bool = False
    # Weibull birth/death resampling
    birth_death: bool = False
    bd_k_shape: float = 1.5
    bd_lam: float = 10.0
    bd_seed: int = 0
    # outputs
    snapshot_writer: object | None = None    # io/output.SequencedWriter
    packet_writer: object | None = None
    write_gradients: bool = True
    diagnostics: dict | None = None           # name -> fn(sol, grid, params)
    diag_every_frames: int = 1
    log_every_frames: int = 1
    log_fn: Callable = print
    live: object | None = None

    def __post_init__(self):
        _check_ray_method(self.ray_method)
        check_ray_params(self.rp)
        self._init_fn, self._step_fn = build_stepper(
            self.model, self.stepper, self.dt, self.use_filter,
            self.filter_kwargs,
        )
        self.sim: SimState | None = None
        self.diag_series: dict = {name: [] for name in (self.diagnostics or {})}
        self.diag_times: list = []
        self.ray_infos: list[dict] = []
        self._frame_cache: dict = {}
        self._reset_graphs()
        self._start_wall = time.time()

    def _reset_graphs(self):
        # (kind, flow_steps) -> its _FrameGraph, and its calls so far
        self._graphs: dict = {}
        self._calls: dict = {}

    # --- lifecycle -----------------------------------------------------------
    def init(self, sol0: torch.Tensor, packets: Packets, clock: Clock | None = None):
        grid = self.model.grid
        with span("rays.fields"):
            fields = fields_from_psih(self.psih_fn(sol0), grid, self.rp.interp)
        self._reset_graphs()
        bd = None
        if self.birth_death:
            bd = init_birth_death(prng_key(self.bd_seed, device=sol0.device), packets.n,
                                  k_shape=self.bd_k_shape, lam=self.bd_lam,
                                  dtype=packets.x.dtype)
        self.sim = SimState(
            sol=sol0,
            clock=clock if clock is not None else zero_clock(device=sol0.device),
            stepper_state=self._init_fn(sol0),
            packets=packets,
            fields=fields,
            bd=bd,
        )
        if self.snapshot_writer is not None:
            from ..io.output import save_problem

            save_problem(self.snapshot_writer, grid, self.model.params, self.dt)
        if self.packet_writer is not None:
            self.packet_writer.write("params/f0", self.rp.f)
            self.packet_writer.write("params/Cg", self.rp.Cg)
            self.packet_writer.write("params/dt", self.dt)
            self.packet_writer.write("params/N", packets.n)
            self.packet_writer.write("params/omega_sign", packets.sign)
        return self.sim

    def _get_frame(self, kind: str, flow_steps: int):
        key = (kind, flow_steps)
        if key not in self._frame_cache:
            if kind == "coupled":
                bd_cfg = (dict(k_shape=self.bd_k_shape, lam=self.bd_lam)
                          if self.birth_death else None)
                self._frame_cache[key] = make_coupled_frame(
                    self.model, self._step_fn, self.psih_fn, self.rp,
                    flow_steps, self.ray_substeps, self.ray_method,
                    self.k_cutoff, self.k0, self.frozen_flow, self.dt, self.remat,
                    bd_cfg, self.ray_opts, self.ray_infos.append,
                )
            else:
                self._frame_cache[key] = make_flow_frame(
                    self.model, self._step_fn, self.psih_fn, self.rp, flow_steps
                )
        return self._frame_cache[key]

    # --- phases --------------------------------------------------------------
    def spinup(self, nsteps: int, chunk: int = 500):
        """Flow-only spinup in chunks with NaN checks between."""
        done = 0
        while done < nsteps:
            k = min(chunk, nsteps - done)
            self._advance("flow", k)
            done += k
            self._check_nan()
        return self.sim

    def run(self, n_frames: int, flow_steps_per_frame: int, snapshot_every: int = 1):
        """Main coupled loop: n_frames x (flow steps interleaved with rays),
        writing packet telemetry each frame and snapshots every
        ``snapshot_every`` frames."""
        self.ray_infos.clear()
        for i in range(n_frames):
            graph = self._advance("coupled", flow_steps_per_frame)
            diag = bool(self.diagnostics) and i % self.diag_every_frames == 0
            log = i % self.log_every_frames == 0
            tail = self._frame_tail(graph, diag, log)
            t = float(tail["t"])
            if not tail["finite"]:
                self.flush()
                raise FloatingPointError(
                    f"solution is NaN/Inf at frame {i} (t={t:.3f}) — aborting")
            if diag:
                self.diag_times.append(t)
                for name in self.diagnostics:
                    self.diag_series[name].append(tail["diag." + name])
            self._write_packet_frame()
            if self.live is not None:
                with span("driver.live"):
                    self.live.update(self.sim, self.model.grid, self.diag_times,
                                     self.diag_series)
            if self.snapshot_writer is not None and i % snapshot_every == 0:
                self._write_snapshot()
            if log:
                self._log(t, float(tail["umax"]))
        self.flush()
        return self.sim

    def _advance(self, kind: str, flow_steps: int) -> _FrameGraph | None:
        """One frame of ``kind`` from ``self.sim``: eager, or the frame's
        CUDA graph, captured at its first call that may run as one
        (``eager_reason``) -> the graph it replayed, or None."""
        key = (kind, flow_steps)
        frame = self._get_frame(kind, flow_steps)
        calls = self._calls.get(key, 0)
        self._calls[key] = calls + 1
        coupled = kind == "coupled"
        reason = eager_reason(self.sim.sol.device,
                              any(t.requires_grad for t in _carried(self.sim, kind)),
                              self.remat and coupled, self.ray_method if coupled else None,
                              self.sim.clock.step, calls,
                              "patch" if _use_patch(self.rp) else "taps",
                              # raytrace_adaptive's default loop is 'scan'
                              (self.ray_opts or {}).get("loop", "scan"))
        if reason is not None:
            graph_frames["eager." + reason] += 1
            self.sim = frame(self.sim)
            return None
        graph = self._graphs.get(key)
        if graph is None:
            graph = _FrameGraph(frame, kind, flow_steps)
            # the buffers stand for the state from here, so that the frame's
            # input is freed before the capture allocates
            self.sim = graph.buffers(self.sim)
            graph.capture(self.sim, self.ray_infos)
            self._graphs[key] = graph
        self.sim = graph.replay(self.sim)
        self.ray_infos.extend(graph.step_infos())
        return graph

    def _frame_tail(self, graph: _FrameGraph | None, diag: bool, log: bool) -> dict:
        """The frame's tail (``frame_tail``, with the diagnostics if
        ``diag`` and the log's scalar if ``log``) on the host, with one
        wait: behind a replay of ``graph`` the tail graph over its buffers
        for these parts (captured at its first use), after an eager frame
        (``graph`` None) the tail run eagerly."""
        diagnostics = self.diagnostics if diag else {}
        with span("driver.frame_tail"):
            if graph is None:
                frame_tails["eager"] += 1
                with torch.no_grad():
                    packed, layout = frame_tail(self.sim, self.model, diagnostics, log)
                with wait("driver.frame_tail"):
                    host = packed.cpu()
            else:
                frame_tails["graphed"] += 1
                tail = graph.tails.get((diag, log))
                if tail is None:
                    tail = graph.tails[(diag, log)] = _TailGraph(
                        lambda sim: frame_tail(sim, self.model, diagnostics, log), self.sim)
                host, layout = tail.replay(), tail.layout
                with wait("driver.frame_tail"):
                    tail.synchronize()
            return unpack_tail(host.numpy(), layout)

    # --- helpers -------------------------------------------------------------
    def _check_nan(self):
        """The spin-up chunk's NaN guard."""
        with span("driver.nan_guard"):
            finite = torch.isfinite(self.sim.sol.abs().max())
            with wait("driver.nan_guard"):
                finite = bool(finite)
            if not finite:
                self.flush()
                with wait("driver.nan_guard"):
                    t = float(self.sim.clock.t)
                raise FloatingPointError(
                    f"solution is NaN/Inf at spinup (t={t:.3f}) — aborting")

    def _write_packet_frame(self):
        """One frame of packet telemetry, (N, 2) float32 arrays x, k, u and
        (N, 4) g = (ux, uy, vx, vy), copied to the host in one transfer."""
        if self.packet_writer is None:
            return
        with span("driver.outputs"):
            sim = self.sim
            p = sim.packets
            rows = [p.x, p.y, p.k, p.l, *sample_velocity(p, sim.fields, self.rp)]
            if self.write_gradients:
                rows += sample_gradients(p, sim.fields, self.rp)
            rows = torch.stack(rows)
            with wait("driver.outputs"):
                host = rows.cpu().numpy()
            with wait("driver.outputs"):
                t = float(sim.clock.t)

            def cols(lo, hi):
                return np.ascontiguousarray(host[lo:hi].T)

            self.packet_writer.write_packets(
                sim.clock.step, t, x=cols(0, 2), k=cols(2, 4), u=cols(4, 6),
                g=cols(6, 10) if self.write_gradients else None)
            if sim.bd is not None:
                # population telemetry: cumulative rebirths and the mean age
                step = sim.clock.step
                with wait("driver.outputs"):
                    births = int(sim.bd.births)
                mean_age = sim.bd.age.mean()
                with wait("driver.outputs"):
                    mean_age = float(mean_age)
                self.packet_writer.write(f"p/births/{step}", births)
                self.packet_writer.write(f"p/mean_age/{step}", mean_age)

    def _write_snapshot(self):
        """The solution and its time as one snapshot frame."""
        with span("driver.outputs"):
            step = self.sim.clock.step
            with wait("driver.outputs"):
                sol = self.sim.sol.cpu()
            with wait("driver.outputs"):
                t = float(self.sim.clock.t)
            self.snapshot_writer.write_frame(step, sol=sol)
            self.snapshot_writer.write(f"snapshots/t/{step}", t)

    def _log(self, t: float, umax: float):
        with span("driver.log"):
            cfl = self.dt * umax / min(self.model.grid.dx, self.model.grid.dy)
            self.log_fn(
                f"step: {self.sim.clock.step:06d}, t: {t:.2f}, "
                f"cfl: {cfl:.2e}, wall: {(time.time() - self._start_wall) / 60:.2f} min"
            )

    def save_diagnostics(self, path: str):
        import h5py

        with h5py.File(path, "w") as f:
            f["t"] = np.asarray(self.diag_times)
            for name, series in self.diag_series.items():
                f[name] = np.asarray(series)

    def flush(self):
        for w in (self.snapshot_writer, self.packet_writer):
            if w is not None:
                w.flush()

    def close(self):
        for w in (self.snapshot_writer, self.packet_writer):
            if w is not None:
                w.close()

    # --- checkpointing -------------------------------------------------------
    def checkpoint(self, path: str):
        from ..io.checkpoint import save_checkpoint

        save_checkpoint(path, self.sim)

    def restore(self, path: str):
        from ..io.checkpoint import load_checkpoint

        if self.sim is None:
            raise RuntimeError("call init() first to establish state shapes")
        self.sim = load_checkpoint(path, self.sim)
        return self.sim
