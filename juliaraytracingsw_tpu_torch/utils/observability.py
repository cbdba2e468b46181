"""Tracing, profiling and numerical-hygiene utilities (port of
``utils/observability.py``).

- ``profile_trace``: context manager around ``torch.profiler`` (the CPU,
  and the card where there is one) writing a trace directory that
  TensorBoard's profiler plugin or Perfetto read;
- ``StepTimer``: wall-clock per named phase with one-line reports; it
  synchronises the devices of the tensors it is handed before each clock
  read, so device work is counted where it runs;
- ``debug_flags``: anomaly detection for ``nan_debug`` (the backward pass
  names the forward op that made a NaN), float64 as the default dtype for
  ``x64``, deterministic algorithms for ``deterministic``, for a scope;
- ``checked_step``: wrap a step function so that a non-finite solution
  raises ``NonFiniteState`` (step and time attached), with one
  synchronisation a step.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

__all__ = ["profile_trace", "StepTimer", "debug_flags", "checked_step", "NonFiniteState"]


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` scope: the trace goes to ``log_dir``
    (``*.pt.trace.json``) when the scope ends; yields the profiler, whose
    ``key_averages()`` sums the time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)
                 ) as prof:
        yield prof


def _devices(tree) -> set:
    """The CUDA devices of the tensors in a tree of tuples, lists, dicts."""
    if isinstance(tree, torch.Tensor):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*(_devices(t) for t in tree))
    return set()


def _sync(block_on) -> None:
    for device in _devices(block_on):
        torch.cuda.synchronize(device)


class StepTimer:
    """Accumulate wall-clock per named phase::

        with timer("flow", block_on=sol): ...

    With ``sync`` (the default) the devices of ``block_on``'s tensors are
    synchronised before the clock is read at both ends of the phase."""

    def __init__(self, sync: bool = True):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def __call__(self, name: str, block_on=None):
        if self.sync:
            _sync(block_on)
        t0 = time.perf_counter()
        yield
        if self.sync:
            _sync(block_on)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        parts = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            tot, cnt = self.totals[name], self.counts[name]
            parts.append(f"{name}: {tot:.3f}s/{cnt} ({tot / max(cnt, 1) * 1e3:.1f} ms ea)")
        return " | ".join(parts)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


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
