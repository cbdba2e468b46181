"""The adaptive DP5(4) 'while' loop on the card (``csrc/adaptive_loop.cu``).

``DeviceLoop`` holds one call of ``rays/raytrace.raytrace_adaptive``'s
fused path on CUDA tensors: the packets ``st (5, N)`` it advances in place,
the clock ``t``, the step size ``h``, the counters and the loop test in
device buffers, and the slot's scratch (the attempt's ``scal`` and
``out5``, the error column's partial sums). ``start`` sets the state before
the first slot (one launch); ``slot`` runs one attempt slot in three
launches: the table attempt (``ops/ray_step.table_attempt``, the kernel of
``csrc/ray_attempt.cu``), the decision (the error column's sum, Hairer's
norm, accept or reject, the next ``t``, ``h``, ``scal`` and the test
``t < t1 - eps and slots < max_steps``) and the apply (the accepted
``p5`` over the packets). ``go`` reads the test on the host (one wait).
``capture`` records the whole loop into the current stream's CUDA graph
capture: the start, then a conditional WHILE node whose body is one slot
and whose condition the decision sets, so a replay runs every slot with no
host call. Eager and captured loops run the same kernels on the same
buffers, so they give the same bits.

The plain twin is the loop of ``raytrace_adaptive`` on the CPU (``body``,
its controller ``_adapt``). Launch counts per kernel in ``launches``: host
launches, a capture's included, its replays not (``while_nodes`` counts the
WHILE nodes captured).
"""
from __future__ import annotations

import ctypes

import torch

from . import ray_step

__all__ = ["DeviceLoop", "launches", "CTL_F", "CTL_I"]

# the state buffers' slots (csrc/adaptive_loop.cu: kT.., kAcc..)
CTL_F = {"t": 0, "h": 1, "t0": 2, "t1": 3, "span": 4, "eps": 5}
CTL_I = {"n_accepted": 0, "n_rejected": 1, "slots": 2, "go": 3, "accepted": 4}
_CTL_LEN = 8

launches = {"init": 0, "decide": 0, "apply": 0, "while_nodes": 0}

_P = ctypes.c_void_p
_SIGNATURES = {
    "jrsw_adaptive_max_blocks": [],
    "jrsw_adaptive_init": [_P, _P, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                           _P, _P, _P, ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong), _P],
    "jrsw_adaptive_decide": [_P, ctypes.c_longlong, _P, _P, _P, _P, ctypes.c_float, ctypes.c_int,
                             ctypes.c_int, ctypes.c_ulonglong, _P],
    "jrsw_adaptive_apply": [_P, _P, ctypes.c_longlong, _P, _P],
    "jrsw_while_begin": [_P, ctypes.c_ulonglong, ctypes.POINTER(_P)],
    "jrsw_while_end": [_P],
}


def _fn(name: str):
    from ._build import load_library

    fn = getattr(load_library(), name)
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")


class DeviceLoop:
    """One fused 'while' loop of ``raytrace_adaptive`` on the card over the
    pair table ``T_pair`` from ``t0`` to ``t1`` (0-d float32 on the packets'
    device); ``exponent`` is the pair's 1/(q+1). The packets are copied into
    ``st`` first, so a caller's tensors are never written."""

    def __init__(self, T_pair, packets, t0, t1, *, rp, ny: int, nx: int, rtol: float,
                 atol: float, max_steps: int, init_substeps: int, exponent: float):
        self.st = torch.stack([packets.x, packets.y, packets.k, packets.l, packets.sign])
        dev, f32 = self.st.device, torch.float32
        if dev.type != "cuda" or self.st.dtype != f32:
            raise ValueError(f"the device loop takes float32 packets on the card, got "
                             f"{self.st.dtype} on {dev}")
        for name, t in (("t0", t0), ("t1", t1)):
            if t.shape != () or t.dtype != f32 or t.device != dev:
                raise ValueError(f"{name} must be a 0-d float32 tensor on {dev}")
        self.T_pair, self.t0, self.t1 = T_pair, t0, t1
        self.rp, self.ny, self.nx = rp, ny, nx
        self.rtol, self.atol = rtol, atol
        self.max_steps, self.init_substeps, self.exponent = max_steps, init_substeps, exponent
        self.n = self.st.shape[1]
        self.out5 = torch.empty_like(self.st)
        self.scal = torch.empty(5, dtype=f32, device=dev)
        self.partials = torch.empty(_fn("jrsw_adaptive_max_blocks")(), dtype=f32, device=dev)
        self.ctl_f = torch.empty(_CTL_LEN, dtype=f32, device=dev)
        self.ctl_i = torch.empty(_CTL_LEN, dtype=torch.int32, device=dev)
        self.handle, self.graph = ctypes.c_ulonglong(0), 0

    def _stream(self) -> int:
        with torch.cuda.device(self.st.device):
            return torch.cuda.current_stream().cuda_stream

    def start(self, graph: bool = False) -> None:
        """The state before the first slot, on the current stream; with
        ``graph`` (the stream capturing) the WHILE node's handle is made
        and set to the first test."""
        self.graph = int(graph)
        _check("jrsw_adaptive_init", _fn("jrsw_adaptive_init")(
            self.t0.data_ptr(), self.t1.data_ptr(), self.rtol, self.atol, self.init_substeps,
            self.max_steps, self.ctl_f.data_ptr(), self.ctl_i.data_ptr(), self.scal.data_ptr(),
            self.graph, ctypes.byref(self.handle), self._stream()))
        launches["init"] += 1

    def slot(self, stream: int | None = None) -> None:
        """One attempt slot: three launches on ``stream`` (default: the
        current stream)."""
        stream = self._stream() if stream is None else stream
        ray_step.table_attempt(self.T_pair, self.st, self.scal, rp=self.rp,
                               interp=self.rp.interp, ny=self.ny, nx=self.nx, out=self.out5,
                               stream=stream)
        self.decide(stream)
        self.apply(stream)

    def decide(self, stream: int | None = None) -> None:
        """The slot's decision from the error column ``out5[4]``."""
        _check("jrsw_adaptive_decide", _fn("jrsw_adaptive_decide")(
            self.out5.data_ptr(), self.n, self.partials.data_ptr(), self.ctl_f.data_ptr(),
            self.ctl_i.data_ptr(), self.scal.data_ptr(), self.exponent, self.max_steps,
            self.graph, self.handle.value, self._stream() if stream is None else stream))
        launches["decide"] += 1

    def apply(self, stream: int | None = None) -> None:
        """``st[0:4] <- out5[0:4]`` if the slot was accepted."""
        _check("jrsw_adaptive_apply", _fn("jrsw_adaptive_apply")(
            self.out5.data_ptr(), self.st.data_ptr(), self.n, self.ctl_i.data_ptr(),
            self._stream() if stream is None else stream))
        launches["apply"] += 1

    def go(self) -> bool:
        """The loop test, read on the host (waits for the device)."""
        return bool(self.ctl_i[CTL_I["go"]])

    def capture(self) -> None:
        """The whole loop into the current stream's capture: the start,
        then a WHILE node whose body is one slot."""
        stream = self._stream()
        self.start(graph=True)
        body = ctypes.c_void_p()
        _check("jrsw_while_begin", _fn("jrsw_while_begin")(stream, self.handle.value,
                                                            ctypes.byref(body)))
        try:
            self.slot(body.value)
        finally:
            _check("jrsw_while_end", _fn("jrsw_while_end")(body.value))
        launches["while_nodes"] += 1

    def packets(self):
        """The packets as views of ``st``."""
        from ..rays.packets import Packets

        return Packets(*self.st.unbind(0))

    def info(self) -> dict:
        """``raytrace_adaptive``'s info: 0-d views of the state buffers."""
        f, i = self.ctl_f, self.ctl_i
        return dict(t_reached=f[CTL_F["t"]], h_final=f[CTL_F["h"]],
                    n_accepted=i[CTL_I["n_accepted"]], n_rejected=i[CTL_I["n_rejected"]])
