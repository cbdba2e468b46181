"""The yardstick's arithmetic: the card's peaks, the bytes the ray kernels'
functions must move, and the floating-point work of a whole step.

Byte counts are of the function a kernel computes, whatever implements
it: each input read once and each output written once. The ray kernels
read the pair-table rows of the cells that hold a packet, at the
configuration's declared table dtype and width, the packets' state, and
write their outputs. The birth/death kernel reads what a packet's fate
needs (a dead packet's state is drawn, not read) and writes the whole
state and the dead mask.

Operation counts are of the algorithm a step runs: a real 2-D FFT of n x
n points is 2.5 n^2 log2(n^2) flops (half of 5 N log2 N), a block apply
of a C x C complex matrix 8 C^2 flops a mode, and the ray stages count
their interpolation and right-hand sides.
"""
from __future__ import annotations

import math

__all__ = ["HBM_BYTES_PER_S", "FP32_FLOPS_PER_S", "TABLE_BYTES", "patch_width",
           "table_row_bytes", "ray_step_bytes", "ray_attempt_bytes", "birth_death_bytes",
           "bound_s", "fft_flops", "flow_step_flops", "fields_flops", "ray_flops_per_packet"]

# NVIDIA H100 SXM data sheet, at its 700 W power limit: HBM3 bandwidth and
# the float32 rate outside the tensor cores (the step is float32 and
# complex64 throughout)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

TABLE_BYTES = {"float32": 4, "bfloat16": 2}
# interp -> (patch height, patch width, fields a row holds)
PATCH = {"bilinear": (4, 4, 5), "bspline": (6, 6, 5), "bicubic": (4, 4, 20)}


def patch_width(interp: str) -> int:
    """Values in one time level of a pair-table row."""
    ph, pw, nf = PATCH[interp]
    return ph * pw * nf


def table_row_bytes(interp: str, table_dtype: str) -> int:
    """Bytes of one (old | new) pair-table row."""
    return 2 * patch_width(interp) * TABLE_BYTES[table_dtype]


def ray_step_bytes(held_rows: float, n: int, interp: str, table_dtype: str) -> float:
    """One RK4 substep: the rows of the cells holding a packet, st (5, N)
    float32 read, (4, N) float32 written."""
    return held_rows * table_row_bytes(interp, table_dtype) + (5 + 4) * 4 * n


def ray_attempt_bytes(held_rows: float, n: int, interp: str, table_dtype: str) -> float:
    """One DP5(4) attempt: the same rows and st, (5, N) float32 written
    (the state and each packet's error sum)."""
    return held_rows * table_row_bytes(interp, table_dtype) + (5 + 5) * 4 * n


# float32 words a packet of the birth/death kernel reads (a live one x y k l
# sign age lifetime; a dead one its age and lifetime) and writes (all seven,
# then a byte of the dead mask)
BD_LIVE_READS, BD_DEAD_READS, BD_WRITES = 7, 2, 7


def birth_death_bytes(n: int, deaths: float) -> float:
    """One birth/death step of ``n`` packets, ``deaths`` of them dead."""
    return 4 * (BD_LIVE_READS * (n - deaths) + BD_DEAD_READS * deaths + BD_WRITES * n) + n


def bound_s(nbytes: float) -> float:
    """The least time a function moving ``nbytes`` can take."""
    return nbytes / HBM_BYTES_PER_S


def fft_flops(n: int) -> float:
    """One real 2-D FFT (either direction) of n x n points."""
    return 2.5 * n * n * math.log2(n * n)


def flow_step_flops(work: dict, n: int) -> float:
    """One IF-AB3 flow step of a configuration's ``work`` (its file's:
    ``flow_transforms`` of N a step, inverse and forward, and the
    operator's ``block`` size C): the transforms, the products and
    derivatives around them (about 10 flops a physical point a
    transformed field), and three block applies of the exponentials with
    the AB3 sums."""
    transforms, C = work["flow_transforms"], work["block"]
    modes = n * (n // 2 + 1)
    return (transforms * fft_flops(n) + 10.0 * transforms * n * n
            + modes * C * (3 * 8 * C + 6 * 2))


def fields_flops(work: dict, n: int) -> float:
    """The interpolation fields: ``field_transforms`` inverse transforms
    and the spectral products before them."""
    k = work["field_transforms"]
    return k * fft_flops(n) + 6 * k * n * (n // 2 + 1)


# one stage of the ray right-hand side: bilinear weights (10), 5 fields x 2
# time levels x 4 taps (80), the time blend (15), omega, the group velocity
# and the refraction terms (25)
STAGE_FLOPS = 10 + 80 + 15 + 25


def ray_flops_per_packet(method: str) -> float:
    """RK4: 4 stages, their state updates (2 flops a component a term)
    and the combination; DP5(4): 7 stages, the 5th-order and the error
    combinations and the scaled error sum."""
    if method == "rk4":
        return 4 * STAGE_FLOPS + 4 * 2 * (1 + 1 + 1) + 4 * 2 * 5
    return 7 * STAGE_FLOPS + 4 * 2 * 21 + 2 * 4 * 2 * 7 + 4 * 7
