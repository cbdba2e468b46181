"""Tracing, profiling and numerical-hygiene utilities (port of
``utils/observability.py``).

- ``span``: a named stage of the program. Under a running
  ``torch.profiler`` it is a ``record_function`` range, so the stage lands
  in the profiler's timeline beside the kernels its ops launch, on one
  clock, nested in the stages around it; otherwise it is one shared null
  context and records nothing;
- ``wait``: one place where the host blocks on the device (``bool``,
  ``float``, ``int``, ``.item()``, ``.tolist()`` or ``.cpu()`` of a device
  tensor), counted in ``waits`` by site whether or not a profiler runs,
  and traced as the span ``wait.<site>``;
- ``graph_frames``: how the coupled driver ran its frames, counted whether
  or not a profiler runs: ``captured`` (CUDA graphs captured),
  ``replayed`` (frames run as one graph replay, the capturing call's
  included) and ``eager.<reason>`` (frames run op by op, by the first
  reason in ``GRAPH_REASONS`` that holds);
- ``frame_tails``: how the coupled driver read each frame's tail (its
  NaN guard, clock, diagnostics and log scalar in one buffer, one wait),
  counted whether or not a profiler runs: ``graphed`` (a tail graph
  replayed behind the frame's graph) and ``eager``;
- ``profile_trace``: context manager around ``torch.profiler`` (the CPU,
  and the card where there is one) writing a trace directory that
  TensorBoard's profiler plugin or Perfetto read, stages and waits
  included;
- ``debug_flags``: anomaly detection for ``nan_debug`` (the backward pass
  names the forward op that made a NaN), float64 as the default dtype for
  ``x64``, deterministic algorithms for ``deterministic``, for a scope;
- ``checked_step``: wrap a step function so that a non-finite solution
  raises ``NonFiniteState`` (step and time attached), with one
  synchronisation a step.
"""
from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span", "wait", "waits", "reset_waits", "WAIT_SITES", "GRAPH_REASONS",
           "graph_frames", "reset_graph_frames", "frame_tails", "reset_frame_tails",
           "profile_trace", "debug_flags", "checked_step", "NonFiniteState"]

_NULL_SPAN = contextlib.nullcontext()

# the sites where the coupled driver's frames block on the device
WAIT_SITES = ("driver.frame_tail", "driver.nan_guard", "driver.outputs", "rays.adaptive",
              "rays.midpoint")
_WAIT_SPANS = {site: "wait." + site for site in WAIT_SITES}
# host waits on the device by site, counted by ``wait``
waits = {site: 0 for site in WAIT_SITES}


def reset_waits() -> None:
    for site in waits:
        waits[site] = 0


# why a frame of the coupled driver runs eager and not as a CUDA graph: the
# state is not on the card, something requires grad (or remat is on), the
# ray step waits on the device inside the frame, the steppers' forward-Euler
# bootstrap (a branch on the host's step count), the frame's first call
GRAPH_REASONS = ("cpu", "grad", "loop", "bootstrap", "first_call")
# the coupled driver's frames by how they ran, counted by the driver
graph_frames = {"captured": 0, "replayed": 0, **{"eager." + r: 0 for r in GRAPH_REASONS}}


def reset_graph_frames() -> None:
    for key in graph_frames:
        graph_frames[key] = 0


# the coupled driver's frame tails by how they ran, counted by the driver
frame_tails = {"graphed": 0, "eager": 0}


def reset_frame_tails() -> None:
    for key in frame_tails:
        frame_tails[key] = 0


def span(name: str):
    """``with span("flow.step"): ...``: a ``record_function`` range while a
    profiler records, else a shared null context; the test is one read of
    the flag ``torch.autograd.profiler`` keeps for it."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL_SPAN
    return torch.profiler.record_function(name)


def wait(site: str):
    """Count one host wait on the device at ``site`` (one of
    ``WAIT_SITES``) and return the span ``wait.<site>`` to hold around the
    blocking call: ``with wait("driver.outputs"): t = float(clock.t)``."""
    waits[site] += 1
    return span(_WAIT_SPANS[site])


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` scope: the trace goes to ``log_dir``
    (``*.pt.trace.json``) when the scope ends; yields the profiler, whose
    ``key_averages()`` sums the time by op and kernel. The program's spans
    and waits are ranges of the host's timeline in the trace."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)
                 ) as prof:
        yield prof


@contextlib.contextmanager
def debug_flags(nan_debug: bool = True, x64: bool = False, deterministic: bool = False):
    """Scoped numerical-debug configuration: anomaly detection
    (``nan_debug``), float64 default dtype (``x64``), deterministic
    algorithms (``deterministic``); the previous settings come back at the
    end of the scope."""
    prev_anomaly = torch.is_anomaly_enabled()
    prev_dtype = torch.get_default_dtype()
    prev_det = torch.are_deterministic_algorithms_enabled()
    torch.set_anomaly_enabled(nan_debug)
    torch.set_default_dtype(torch.float64 if x64 else torch.float32)
    torch.use_deterministic_algorithms(deterministic)
    try:
        yield
    finally:
        torch.set_anomaly_enabled(prev_anomaly)
        torch.set_default_dtype(prev_dtype)
        torch.use_deterministic_algorithms(prev_det)


class NonFiniteState(FloatingPointError):
    """A step produced a NaN or Inf solution; ``step`` and ``t`` say when."""

    def __init__(self, step: int, t: float):
        super().__init__(f"non-finite solution at step {step} (t={t:.6g})")
        self.step = step
        self.t = t


def checked_step(step_fn):
    """Wrap ``(sol, clock, state) -> (sol, clock, state)`` so that a
    non-finite solution raises ``NonFiniteState``; one device sync a call."""

    def inner(sol, clock, state):
        out_sol, out_clock, out_state = step_fn(sol, clock, state)
        if not bool(torch.isfinite(out_sol).all()):
            raise NonFiniteState(int(out_clock.step), float(out_clock.t))
        return out_sol, out_clock, out_state

    return inner
