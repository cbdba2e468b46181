"""The (old|new) pair table of two field stacks: one CUDA kernel and its twin.

``pair_table(fields_old, fields_new, interp=, table_dtype=)`` builds the
``(ny*nx, 2W)`` table the ray kernels read (``ops/ray_step``): row ``c =
iy*nx + ix`` holds ``[old | new]``, each half ``fields[f, (iy+dy-lo) mod
ny, (ix+dx-lo) mod nx]`` in ``(f, dy, dx)`` order, stored as float32 or
bfloat16 (round to nearest even). On CUDA tensors it launches
``csrc/pair_table.cu`` (one launch, counted in ``pair_table_launches``);
on CPU tensors it runs ``pair_table_torch``, the reference's roll path
(``rays/patch.build_patch_table`` of each stack, then
``rays/raytrace.make_pair_table``); anything else raises. The kernel is
bit-equal to the twin: a table value is a copy of a field value, rounded
once to the table's dtype.

Both go through ``PairTable``, whose backward is the table's adjoint in
plain PyTorch (``pair_table_adjoint``), as the reference's is XLA's
autodiff of its build: each ``(dy, dx)`` slice of the table's cotangent
rolled back to the cell it was read from, and summed. The CUDA kernel
takes float32 fields; the twin also float64 (the gradient checks).
"""
from __future__ import annotations

import ctypes

import torch

from ..rays.patch import PATCH_SHAPES, build_patch_table
from .ray_step import (_INTERP_ID, _REAL, _TABLE_DTYPE_ID, _pair_width, _runs_on_cpu,
                       n_channels)

__all__ = ["PairTable", "pair_table", "pair_table_adjoint", "pair_table_launches",
           "pair_table_torch"]

# launches of the CUDA kernel per interp, counted by ``PairTable`` where it
# launches it and nowhere else: host launches, a CUDA graph's capture
# included, its replays not
pair_table_launches = {name: 0 for name in _INTERP_ID}


def pair_table_torch(fields_old, fields_new, interp: str, table_dtype: str) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: the two patch tables and their
    concatenation, cast to the table's dtype."""
    from ..rays.raytrace import make_pair_table

    return make_pair_table(build_patch_table(fields_old, interp),
                           build_patch_table(fields_new, interp), table_dtype)


def pair_table_adjoint(g: torch.Tensor, interp: str, ny: int, nx: int,
                       dtype: torch.dtype) -> torch.Tensor:
    """The table's adjoint: ``(ny*nx, 2W)`` cotangent -> ``(2, F, ny, nx)``
    cotangents of the (old, new) stacks in ``dtype``. Table value ``(c, lvl,
    f, dy, dx)`` was read from cell ``(iy+dy-lo, ix+dx-lo)``, so each
    ``(dy, dx)`` slice rolls back by ``(dy-lo, dx-lo)``."""
    ph, pw, lo = PATCH_SHAPES[interp]
    G = g.to(dtype).reshape(ny, nx, 2, -1, ph, pw).permute(2, 3, 4, 5, 0, 1)
    out = None
    for dy in range(ph):
        for dx in range(pw):
            r = torch.roll(G[:, :, dy, dx], shifts=(dy - lo, dx - lo), dims=(2, 3))
            out = r if out is None else out + r
    return out


def _launch(fields_old, fields_new, interp: str, dtype: torch.dtype) -> torch.Tensor:
    from ._build import load_library

    fn = load_library().jrsw_pair_table
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    _, ny, nx = fields_old.shape
    out = torch.empty((ny * nx, _pair_width(interp)), dtype=dtype, device=fields_old.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_INTERP_ID[interp], _TABLE_DTYPE_ID[dtype], fields_old.data_ptr(),
                 fields_new.data_ptr(), out.data_ptr(), ny, nx, stream)
    if err != 0:
        raise RuntimeError(f"pair table kernel launch failed: cudaError_t {err}")
    pair_table_launches[interp] += 1
    return out


class PairTable(torch.autograd.Function):
    """``pair_table``: ``(fields_old, fields_new) -> (ny*nx, 2W)``. Forward:
    the kernel on the card (one launch), the twin on the CPU. Backward:
    ``pair_table_adjoint`` on both."""

    @staticmethod
    def forward(ctx, fields_old, fields_new, interp, table_dtype, on_cpu):
        _, ny, nx = fields_old.shape
        ctx.cfg = (interp, ny, nx, fields_old.dtype)
        if on_cpu:
            return pair_table_torch(fields_old, fields_new, interp, table_dtype)
        return _launch(fields_old, fields_new, interp, getattr(torch, table_dtype))

    @staticmethod
    def backward(ctx, g):
        d = pair_table_adjoint(g, *ctx.cfg)
        return (*(d[i] if ctx.needs_input_grad[i] else None for i in range(2)),
                None, None, None)


def pair_table(fields_old: torch.Tensor, fields_new: torch.Tensor, *, interp: str,
               table_dtype: str = "float32") -> torch.Tensor:
    """The ``(ny*nx, 2W)`` pair table of two ``(F, ny, nx)`` stacks, ``F`` =
    ``n_channels(interp)``, in ``table_dtype`` ('float32' | 'bfloat16').

    CUDA tensors go through the hand-written kernel (and count one launch);
    CPU tensors go through the twin (float32 or float64 fields).
    Differentiable (``PairTable``). Anything else raises."""
    if table_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown table_dtype {table_dtype!r}; available: "
                         "['bfloat16', 'float32']")
    _pair_width(interp)
    if fields_old.dim() != 3:
        raise ValueError(f"fields_old must be (F, ny, nx), got {tuple(fields_old.shape)}")
    shape = (n_channels(interp), *fields_old.shape[1:])
    on_cpu = _runs_on_cpu((("fields_old", fields_old, shape, _REAL),
                           ("fields_new", fields_new, shape, (fields_old.dtype,))),
                          name="pair table", backward=True)
    return PairTable.apply(fields_old, fields_new, interp, table_dtype, on_cpu)
