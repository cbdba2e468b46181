"""CUDA-event timing, the device-memory bound and the bit-equality check
shared by the probe modules."""
from __future__ import annotations

import statistics
import subprocess
from dataclasses import dataclass

import torch

__all__ = ["HBM_BYTES_PER_S", "Result", "bound_ms", "card_line", "device_ms", "measure",
           "require_cuda", "time_ms", "unique_rows"]

# H100 SXM: 3.35 TB/s of HBM3 at its 700 W power limit (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
WARMUP, ITERS, REPS = 2, 10, 3


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the probes need a CUDA device: torch.cuda.is_available() is false")
    return torch.device("cuda", torch.cuda.current_device())


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn) -> float:
    """Milliseconds per call of ``fn`` on the current stream: WARMUP calls,
    then the median over REPS of CUDA-event timings of ITERS calls each."""
    for _ in range(WARMUP):
        fn()
    reps = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        torch.cuda.synchronize()
        reps.append(start.elapsed_time(end) / ITERS)
    return statistics.median(reps)


def device_ms(fn) -> float:
    """Milliseconds per call of ``fn`` on the device alone: WARMUP calls on a
    side stream, ITERS calls captured into one CUDA graph, then the median
    over REPS CUDA-event timings of a replay, divided by ITERS. The host's
    work per call (Python, the wrapper's checks, the launch), which eager
    timing adds to a short kernel, is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUP):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(ITERS):
            fn()
    graph.replay()
    reps = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        reps.append(start.elapsed_time(end) / ITERS)
    del graph
    return statistics.median(reps)


def bound_ms(nbytes: float) -> float:
    """The least time device memory allows for ``nbytes`` moved."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def unique_rows(rows: torch.Tensor) -> int:
    """Distinct table rows a gather reads (each read once in the bound)."""
    return int(torch.unique(rows).numel())


@dataclass
class Result:
    probe: str
    kernel: str | None          # the ops/probes.py launch counter, or None
    ms: float                   # the kernel's on the device (without one, the library call's)
    n_rows: int
    nbytes: float
    eager_ms: float | None = None   # the same called from Python, host work included
    plain_ms: float | None = None
    library: str | None = None
    library_ms: float | None = None
    max_abs_err: float | None = None

    @property
    def bound_ms(self) -> float:
        return bound_ms(self.nbytes)

    @property
    def ns_per_row(self) -> float:
        return self.ms * 1e6 / self.n_rows

    def line(self, card: str) -> str:
        eager = f", {self.eager_ms:.4f} ms eager" if self.eager_ms is not None else ""
        parts = [f"{self.probe}: {self.ms:.4f} ms{eager}, {self.ns_per_row:.3f} ns/row "
                 f"({self.n_rows} rows); bound {self.bound_ms:.4f} ms "
                 f"({self.nbytes / 1e6:.3f} MB at {HBM_BYTES_PER_S / 1e12} TB/s)"]
        if self.plain_ms is not None:
            parts.append(f"plain {self.plain_ms:.4f} ms, max |kernel - plain| "
                         f"{self.max_abs_err:.1e}")
        if self.library is not None:
            parts.append(f"{self.library} {self.library_ms:.4f} ms")
        return "; ".join(parts) + f" [{card}]"


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def measure(probe: str, card: str, *, n_rows: int, nbytes: float, kernel: str | None = None,
            fn=None, plain=None, library=None, library_name: str | None = None) -> Result:
    """Run ``fn`` (the kernel of launch counter ``kernel``) once and hold it
    bit-equal to ``plain()``, and to ``library()`` where that computes the
    same values; then time each on the device (``device_ms``; the kernel
    also eagerly, ``time_ms``) and print the probe's line. Without ``fn``
    the probe is the library call alone."""
    if fn is None:
        res = Result(probe, None, device_ms(library), n_rows, nbytes, library=library_name)
        res.library_ms = res.ms
        print(res.line(card), flush=True)
        return res
    out, ref = fn(), plain()
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype or not torch.equal(out, ref):
        raise AssertionError(f"{probe}: the kernel disagrees with its plain version: "
                             f"{tuple(out.shape)} {out.dtype} against {tuple(ref.shape)} "
                             f"{ref.dtype}, max |difference| {_max_err(out, ref)}")
    if library is not None:
        lib = library()
        if lib.numel() == out.numel() and not torch.equal(lib.reshape(out.shape).to(out.dtype),
                                                          out):
            raise AssertionError(f"{probe}: {library_name} disagrees with the kernel")
    res = Result(probe, kernel, device_ms(fn), n_rows, nbytes, eager_ms=time_ms(fn),
                 plain_ms=device_ms(plain), library=library_name,
                 max_abs_err=_max_err(out, ref))
    if library is not None:
        res.library_ms = device_ms(library)
    print(res.line(card), flush=True)
    return res
