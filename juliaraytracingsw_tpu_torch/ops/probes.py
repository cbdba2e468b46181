"""Copy and gather probe kernels (port of the Pallas probes in the JAX
package's ``benchmarks/profiling/``).

Four hand-written CUDA kernels, each beside its plain PyTorch version:

- ``staged_copy`` launches ``csrc/probe_copy.cu``: ``a * x[rows] + b`` with
  the rows brought into shared memory by one or more bulk copies (TMA) on
  mbarriers, every copy cut into slices that as many blocks start side by
  side (``copy_slices``), or read straight from device memory. Plain
  version: ``staged_copy_torch``. ``COPY_PROBES`` names the Pallas kernel
  each schedule replaces.
- ``gather_elems`` launches ``gather_elems`` of ``csrc/probe_gather.cu``: a
  flat element gather or ``torch.gather`` along axis 0 or 1. Plain version:
  ``gather_elems_torch``.
- ``gather_rows`` launches ``gather_rows`` of ``csrc/probe_gather.cu``: a
  row gather, one warp per row, optionally rounded through bfloat16 or
  upcast from it. Plain version: ``gather_rows_torch``.
- ``row_ring`` launches ``csrc/probe_row_ring.cu``: one bulk copy per row
  (or per Q rows), the copies cut into chunks, one per ring of K in flight
  (``ring_plan``), rings on every SM, each copy written back by a bulk
  store in issue order. Plain version: ``row_ring_torch``.

A wrapper runs the plain version for tensors on the CPU and the kernel for
tensors on the card, where it adds one to ``launches[name]``; anything else
raises. Every kernel is bit-equal to its plain version: they only move
values, and the copy's ``a * x + b`` rounds after the product and after
the sum as PyTorch does.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

__all__ = ["COPY_PROBES", "COPY_SLICE_MIN", "CopySchedule", "RING_ISSUERS_PER_SM",
           "RING_OFFSET", "RING_STRIDE", "RingPlan", "copy_slices", "gather_elems",
           "gather_elems_torch", "gather_rows", "gather_rows_torch", "launches",
           "reset_launches", "ring_bytes", "ring_plan", "ring_rows", "row_ring",
           "row_ring_torch", "staged_copy", "staged_copy_torch"]

# kernel launches, counted by each wrapper where it launches its CUDA kernel
# and nowhere else (the CPU path does not count)
launches = {"probe_copy": 0, "gather_elems": 0, "gather_rows": 0, "row_ring": 0}

SMEM_LIMIT = 232_448          # bytes of shared memory a block may have on Hopper
INT32_MAX = 2 ** 31 - 1
RING_STRIDE, RING_OFFSET = 40503, 12345   # the scripts' synthetic row walk


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _lib_fn(name: str, argtypes: list):
    from ._build import load_library

    fn = getattr(load_library(), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version's case),
    False when all lie on one CUDA device (the kernel's); raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: a tensor is on {t.device}, another on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise RuntimeError(f"{name} runs on CPU or CUDA tensors, not {dev.type}")
    return False


def _check_dtype(name: str, arg: str, t: torch.Tensor, *dtypes) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {arg} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _up(v: int, m: int) -> int:
    return _cdiv(v, m) * m


# --- A: staged affine copy ---------------------------------------------------

@dataclass(frozen=True)
class CopySchedule:
    """Copy i (i < n_copies) moves the q rows starting at (i q) mod src_mod
    into ring slot i mod n_slots, with up to ``in_flight`` copies
    outstanding on as many mbarriers; ``staged`` False reads the surviving
    rows straight from device memory (no copies)."""

    q: int
    n_copies: int = 1
    src_mod: int | None = None     # None: no wrap
    n_slots: int = 1
    in_flight: int = 1
    staged: bool = True

    @property
    def wrap(self) -> int:
        """``src_mod``, or past the last copy's start when nothing wraps."""
        return self.src_mod or self.n_copies * self.q


# The Pallas kernel each schedule replaces, with its (a, b) and x's shape.
COPY_PROBES = {
    # prof_pallas_probe.py:37-56 `trivial`: 2x + 1 on (256, 256), VMEM in/out
    "trivial": (CopySchedule(q=256, staged=False), 2.0, 1.0, (256, 256)),
    # prof_r5_dma_bisect.py:47-54 `k0`: 2x, VMEM in/out
    "k0": (CopySchedule(q=256, staged=False), 2.0, 0.0, (256, 128)),
    # :57-70 `k1`: one whole-buffer async copy into scratch, then 2x
    "k1": (CopySchedule(q=256), 2.0, 0.0, (256, 128)),
    # :73-86 `k2`: the same on a semaphore array (of 2)
    "k2": (CopySchedule(q=256, in_flight=2), 2.0, 0.0, (256, 128)),
    # :89-106 `k3`: grid of 4, copy of rows 8i.. at a runtime offset; the
    # last step wins: 2 x[24:32]
    "k3": (CopySchedule(q=8, n_copies=4), 2.0, 0.0, (256, 128)),
    # :109-128 `k4`: 8 serial copies into one slot: 2 x[56:64]
    "k4": (CopySchedule(q=8, n_copies=8), 2.0, 0.0, (256, 128)),
    # :131-164 `k5`: 16 copies of rows (8i mod 248).., ring of 8 slots, 4 in
    # flight with delayed waits: 2 x[64:128]
    "k5": (CopySchedule(q=8, n_copies=16, src_mod=248, n_slots=8, in_flight=4), 2.0, 0.0,
           (256, 128)),
}


# bytes: the least slice of a copy one block starts (slices of 256 B to 4 KB
# time alike, scripts/torch_probe_sweeps.py; PERF.md)
COPY_SLICE_MIN = 2048


def copy_slices(copy_bytes: int) -> tuple[int, int]:
    """How the staged kernel cuts a copy of ``copy_bytes`` (a multiple of 16)
    across blocks: ``(slice_bytes, n_slices)``, block s starting bytes
    ``[s slice_bytes, (s + 1) slice_bytes)`` of every copy and the last block
    the rest, ``[(n_slices - 1) slice_bytes, copy_bytes)``. Slices are
    multiples of 16 bytes, at least ``COPY_SLICE_MIN`` where the copy is, and
    the last one is the longest, by less than ``n_slices`` times 16 bytes."""
    if copy_bytes < 16 or copy_bytes % 16:
        raise ValueError(f"a bulk copy moves a positive multiple of 16 bytes, not {copy_bytes}")
    n_slices = max(1, copy_bytes // COPY_SLICE_MIN)
    return copy_bytes // 16 // n_slices * 16, n_slices


def staged_copy_torch(x: torch.Tensor, sched: CopySchedule, a: float, b: float) -> torch.Tensor:
    """Plain version: ``x[rows] * a + b``, the rows computed on x's device
    (no host-to-device copy, so a CUDA graph can capture it)."""
    s = torch.arange(sched.n_slots, device=x.device)
    last = s + sched.n_slots * ((sched.n_copies - 1 - s) // sched.n_slots)
    start = (last * sched.q) % sched.wrap
    rows = (start[:, None] + torch.arange(sched.q, device=x.device)).reshape(-1)
    return x[rows] * a + b


def staged_copy(x: torch.Tensor, sched: CopySchedule, a: float, b: float) -> torch.Tensor:
    """``a * x[rows] + b`` for a float32 ``x (R, W)``, ``rows`` those the
    schedule's ring ends with (slot by slot): the kernel on the card (one
    launch), the plain version on the CPU."""
    name = "staged_copy"
    _check_dtype(name, "x", x, torch.float32)
    if x.ndim != 2:
        raise ValueError(f"{name}: x must be 2-D, got shape {tuple(x.shape)}")
    R, W = x.shape
    starts = {(i * sched.q) % sched.wrap for i in range(sched.n_copies)}
    if max(starts) + sched.q > R:
        raise ValueError(f"{name}: the schedule reads rows outside x's {R}")
    if not 1 <= sched.in_flight <= 32:
        raise ValueError(f"{name}: 1 to 32 copies in flight, not {sched.in_flight}")
    if sched.in_flight > sched.n_slots and sched.n_copies > sched.n_slots:
        raise ValueError(f"{name}: {sched.in_flight} copies in flight would overwrite "
                         f"one of {sched.n_slots} slots before it lands")
    if sched.n_copies * sched.q > INT32_MAX or sched.n_slots * sched.q * W > INT32_MAX:
        raise ValueError(f"{name}: the kernel indexes rows in 32-bit arithmetic")
    if _on_cpu(name, x):
        return staged_copy_torch(x, sched, a, b)
    copy_bytes = sched.q * W * 4
    slice_bytes, n_slices = 0, 0
    if sched.staged:
        if (copy_bytes % 16 or x.data_ptr() % 16
                or any(r * W * 4 % 16 for r in starts)):
            raise ValueError(f"{name}: a bulk copy moves 16-byte multiples from 16-byte "
                             f"aligned addresses; copies of {sched.q} rows of {W} float32 "
                             f"from these rows do not")
        slice_bytes, n_slices = copy_slices(copy_bytes)
        smem = _lib_fn("jrsw_probe_copy_smem_bytes", [ctypes.c_int] * 4)(
            copy_bytes, slice_bytes, n_slices, sched.n_slots)
        if smem > SMEM_LIMIT:
            raise ValueError(f"{name}: the ring's slices need {smem} bytes of shared memory "
                             f"a block, above the {SMEM_LIMIT} a block may have")
    out = torch.empty((sched.n_slots * sched.q, W), dtype=torch.float32, device=x.device)
    vec4 = W % 4 == 0 and x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    fn = _lib_fn("jrsw_probe_copy", [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(x.device):
        err = fn(int(sched.staged), x.data_ptr(), out.data_ptr(), W, sched.q, sched.n_copies,
                 sched.wrap, sched.n_slots, sched.in_flight, slice_bytes, n_slices, int(vec4),
                 a, b, _stream(x))
    _check_launch(name, err)
    launches["probe_copy"] += 1
    return out


# --- B: element gathers ------------------------------------------------------

_ELEM_MODES = {"flat": 0, "axis0": 1, "axis1": 2}


def gather_elems_torch(table: torch.Tensor, idx: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain version: ``table.flatten()[idx]`` or ``torch.gather`` along
    axis 0 or 1."""
    if mode == "flat":
        return table.reshape(-1)[idx.long()]
    return torch.gather(table, 0 if mode == "axis0" else 1, idx.long())


def gather_elems(table: torch.Tensor, idx: torch.Tensor, mode: str = "flat") -> torch.Tensor:
    """Gather float32 elements by int32 indices (on the card an index out
    of range traps the kernel, as PyTorch's gathers assert on the device):

    - ``"flat"``: ``out[...] = table.flatten()[idx[...]]``, out shaped as idx;
    - ``"axis0"``: ``out[r, c] = table[idx[r, c], c]``, table (R, C), idx (M, C);
    - ``"axis1"``: ``out[r, c] = table[r, idx[r, c]]``, table (M, C), idx (M, C')."""
    name = "gather_elems"
    if mode not in _ELEM_MODES:
        raise ValueError(f"{name}: unknown mode {mode!r}; available: {sorted(_ELEM_MODES)}")
    _check_dtype(name, "table", table, torch.float32)
    _check_dtype(name, "idx", idx, torch.int32)
    if mode != "flat":
        if table.ndim != 2 or idx.ndim != 2:
            raise ValueError(f"{name}: mode {mode!r} takes 2-D table and idx")
        if mode == "axis0" and idx.shape[1] != table.shape[1]:
            raise ValueError(f"{name}: axis0 needs idx's columns = table's {table.shape[1]}")
        if mode == "axis1" and idx.shape[0] != table.shape[0]:
            raise ValueError(f"{name}: axis1 needs idx's rows = table's {table.shape[0]}")
    if _on_cpu(name, table, idx):
        return gather_elems_torch(table, idx, mode)
    out = torch.empty(idx.shape, dtype=torch.float32, device=table.device)
    fn = _lib_fn("jrsw_gather_elems", [ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
    cols = idx.shape[-1] if idx.ndim else 1
    tab_cols = table.shape[-1] if table.ndim else 1
    with torch.cuda.device(table.device):
        err = fn(_ELEM_MODES[mode], table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                 idx.numel(), cols, tab_cols, table.numel(), _stream(table))
    _check_launch(name, err)
    launches["gather_elems"] += 1
    return out


# --- C: row gathers ----------------------------------------------------------

def _row_kind(table: torch.Tensor, round_bf16: bool, out_dtype: torch.dtype) -> int:
    if table.dtype == torch.float32:
        if out_dtype != torch.float32:
            raise TypeError(f"gather_rows: a float32 table gives float32 rows, not {out_dtype}")
        return 1 if round_bf16 else 0
    if round_bf16:
        raise ValueError("gather_rows: round_bf16 applies to a float32 table")
    return 2 if out_dtype == torch.bfloat16 else 3


def gather_rows_torch(table: torch.Tensor, rows: torch.Tensor, *, round_bf16: bool = False,
                      out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version: ``table[rows]``, rounded through bfloat16 or cast."""
    out = table[rows.long()]
    if round_bf16:
        out = out.to(torch.bfloat16).float()
    return out.to(out_dtype or table.dtype)


def gather_rows(table: torch.Tensor, rows: torch.Tensor, *, round_bf16: bool = False,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``table[rows]`` for a float32 or bfloat16 ``table (R, W)`` and int32
    ``rows (n,)`` (on the card a row out of range traps the kernel).
    ``round_bf16`` rounds float32 rows through bfloat16 (nearest even);
    ``out_dtype=torch.float32`` upcasts bfloat16 rows. A row must be a
    multiple of 16 bytes."""
    name = "gather_rows"
    _check_dtype(name, "table", table, torch.float32, torch.bfloat16)
    _check_dtype(name, "rows", rows, torch.int32)
    if table.ndim != 2 or rows.ndim != 1:
        raise ValueError(f"{name}: takes table (R, W) and rows (n,), got "
                         f"{tuple(table.shape)} and {tuple(rows.shape)}")
    out_dtype = out_dtype or table.dtype
    kind = _row_kind(table, round_bf16, out_dtype)
    row_bytes = table.shape[1] * table.element_size()
    if _on_cpu(name, table, rows):
        return gather_rows_torch(table, rows, round_bf16=round_bf16, out_dtype=out_dtype)
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"{name}: rows of {row_bytes} bytes are not 16-byte multiples")
    out = torch.empty((rows.shape[0], table.shape[1]), dtype=out_dtype, device=table.device)
    fn = _lib_fn("jrsw_gather_rows", [ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p])
    with torch.cuda.device(table.device):
        err = fn(kind, table.data_ptr(), rows.data_ptr(), out.data_ptr(), rows.shape[0],
                 row_bytes, table.shape[0], _stream(table))
    _check_launch(name, err)
    launches["gather_rows"] += 1
    return out


# --- D: per-row copy ring ----------------------------------------------------

def ring_rows(n_blocks: int, rows_per_blk: int, Q: int = 1, *,
              modulus: int | None = None, idx: torch.Tensor | None = None,
              device=None) -> torch.Tensor:
    """First rows of every copy, ``(n_blocks, rows_per_blk // Q)`` int64:
    ``idx`` reshaped, or ``((b rows_per_blk + i) RING_STRIDE + RING_OFFSET)
    mod modulus`` in wrapping int32 arithmetic, floor modulo."""
    n_dma = rows_per_blk // Q
    if idx is not None:
        return idx.long().reshape(n_blocks, n_dma)
    g = (torch.arange(n_blocks, device=device)[:, None] * rows_per_blk
         + torch.arange(n_dma, device=device)[None, :])
    v = (g * RING_STRIDE + RING_OFFSET) & 0xFFFFFFFF
    v = torch.where(v >= 2 ** 31, v - 2 ** 32, v)
    return torch.remainder(v, modulus)


def row_ring_torch(table: torch.Tensor, *, n_blocks: int, rows_per_blk: int, K: int,
                   Q: int = 1, modulus: int | None = None,
                   idx: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: every copy's rows, ``table[rows]`` with the rows of
    each copy in issue order, ``(n_blocks, rows_per_blk, W)``. K, the
    kernel's copies in flight, does not change the result."""
    first = ring_rows(n_blocks, rows_per_blk, Q, modulus=modulus, idx=idx, device=table.device)
    rows = first[..., None] + torch.arange(Q, device=table.device)
    return table[rows.reshape(n_blocks, rows_per_blk)]


# rings an SM (one a warp), chosen by the issuers curve of
# scripts/torch_probe_sweeps.py (PERF.md): 8 rings an SM reach device
# memory, 16 a little more
RING_ISSUERS_PER_SM = 16


def ring_bytes(K: int, copy_bytes: int, chunk: int, staged_idx: bool) -> int:
    """Shared memory of one ring, a multiple of 128 bytes: K + 1 slots of
    ``copy_bytes``, K + 2 mbarriers, then ``chunk`` staged indices at a
    16-byte boundary (the order ``csrc/probe_row_ring.cu`` places them in;
    its entry point checks that the size covers them)."""
    idx_at = _up((K + 1) * copy_bytes + 8 * (K + 2), 16)
    return _up(idx_at + (4 * chunk if staged_idx else 0), 128)


@dataclass(frozen=True)
class RingPlan:
    """How the ring kernel cuts ``n_copies`` copies (copy c = b n_dma + i of
    probe block b) into rings: ring r issues copies ``r chunk`` onwards,
    ``chunk`` of them (the last ring what is left); ``rings_per_block``
    rings a block, one a warp, one block per SM."""

    n_copies: int
    n_rings: int
    chunk: int
    rings_per_block: int
    ring_bytes: int

    @property
    def blocks(self) -> int:
        return _cdiv(self.n_rings, self.rings_per_block)

    @property
    def smem_bytes(self) -> int:
        return self.rings_per_block * self.ring_bytes

    def rings(self, n_dma: int) -> list[tuple[int, int, int]]:
        """Each ring's first copy as (probe block b, copy i in b) and its count."""
        return [(*divmod(r * self.chunk, n_dma), min(self.chunk, self.n_copies - r * self.chunk))
                for r in range(self.n_rings)]


def ring_plan(n_copies: int, K: int, copy_bytes: int, *, staged_idx: bool,
              n_sms: int) -> RingPlan:
    """Cut ``n_copies`` copies into contiguous chunks, one per ring, for
    ``RING_ISSUERS_PER_SM`` rings on each of ``n_sms`` SMs, fewer where
    shared memory holds fewer rings of K + 1 slots (or where there are fewer
    copies than rings). With staged indices a chunk is a multiple of 4
    copies, so each ring's indices start on a 16-byte boundary."""
    if n_copies < 1 or n_sms < 1:
        raise ValueError(f"ring_plan: {n_copies} copies on {n_sms} SMs")
    align = 4 if staged_idx else 1
    if staged_idx and n_copies % 4:
        raise ValueError("ring_plan: staged indices take a multiple of 4 copies")
    per_block = RING_ISSUERS_PER_SM
    while True:
        chunk = _up(_cdiv(n_copies, per_block * n_sms), align)
        rb = ring_bytes(K, copy_bytes, chunk, staged_idx)
        if per_block * rb <= SMEM_LIMIT or per_block == 1:
            break
        per_block -= 1
    if rb > SMEM_LIMIT:
        raise ValueError(f"ring_plan: a ring of {K} + 1 slots of {copy_bytes} bytes needs {rb} "
                         f"bytes of shared memory, above the {SMEM_LIMIT} a block may have")
    n_rings = _cdiv(n_copies, chunk)
    # few rings: spread them over the SMs before stacking them
    return RingPlan(n_copies, n_rings, chunk, min(per_block, _cdiv(n_rings, n_sms)), rb)


def row_ring(table: torch.Tensor, *, n_blocks: int, rows_per_blk: int, K: int, Q: int = 1,
             modulus: int | None = None, idx: torch.Tensor | None = None) -> torch.Tensor:
    """The per-row copy probe over a float32 or bfloat16 ``table (R, W)``:
    block b starts rows_per_blk / Q copies of Q rows, at most K in flight,
    from synthetic rows (``modulus``) or int32 ``idx (n_blocks
    rows_per_blk,)`` (Q = 1; on the card a row out of range traps the
    kernel), and writes every copy's rows in issue order ->
    ``(n_blocks, rows_per_blk, W)``. The Pallas probe's ring of 2K slots,
    slot s holding the last copy i with i mod 2K = s, is a selection of a
    block's rows. On the card the copies run on rings spread over every SM
    (``ring_plan``), whatever ``n_blocks``."""
    name = "row_ring"
    _check_dtype(name, "table", table, torch.float32, torch.bfloat16)
    if table.ndim != 2:
        raise ValueError(f"{name}: table must be 2-D")
    if n_blocks < 1 or Q < 1 or rows_per_blk % Q or rows_per_blk // Q < 2 * K:
        raise ValueError(f"{name}: a block starts rows_per_blk / Q copies, at least 2K")
    if not 1 <= K <= 64:
        raise ValueError(f"{name}: 1 to 64 copies in flight, not {K}")
    if (idx is None) == (modulus is None):
        raise ValueError(f"{name}: give either modulus (synthetic rows) or idx")
    if idx is not None:
        _check_dtype(name, "idx", idx, torch.int32)
        if Q != 1 or idx.shape != (n_blocks * rows_per_blk,) or rows_per_blk % 4:
            raise ValueError(f"{name}: idx takes Q = 1, one index per row, and "
                             f"rows_per_blk a multiple of 4")
    elif not 0 < modulus <= table.shape[0] - Q + 1:
        raise ValueError(f"{name}: rows r .. r+Q-1 with r < {modulus} leave the table")
    n_copies = n_blocks * (rows_per_blk // Q)
    if n_copies > INT32_MAX:
        raise ValueError(f"{name}: the kernel counts copies in 32-bit arithmetic")
    if _on_cpu(name, table, *(() if idx is None else (idx,))):
        return row_ring_torch(table, n_blocks=n_blocks, rows_per_blk=rows_per_blk, K=K, Q=Q,
                              modulus=modulus, idx=idx)
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 or table.data_ptr() % 16 or (idx is not None and idx.data_ptr() % 16):
        raise ValueError(f"{name}: a bulk copy moves 16-byte multiples from 16-byte "
                         f"aligned addresses; rows of {row_bytes} bytes do not")
    plan = ring_plan(n_copies, K, Q * row_bytes, staged_idx=idx is not None,
                     n_sms=torch.cuda.get_device_properties(table.device).multi_processor_count)
    out = torch.empty((n_blocks, rows_per_blk, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    fn = _lib_fn("jrsw_row_ring", [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2
                 + [ctypes.c_int] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                 + [ctypes.c_void_p])
    with torch.cuda.device(table.device):
        err = fn(table.data_ptr(), table.shape[0], None if idx is None else idx.data_ptr(),
                 out.data_ptr(), n_blocks, rows_per_blk, K, Q, row_bytes, RING_STRIDE,
                 RING_OFFSET, modulus or 0, plan.n_rings, plan.chunk, plan.rings_per_block,
                 plan.ring_bytes, _stream(table))
    _check_launch(name, err)
    launches["row_ring"] += 1
    return out
