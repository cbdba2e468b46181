"""Gather forms on (N / 128, 128) rows (port of
``benchmarks/profiling/prof_pallas2.py``).

A float32 table ``tab3`` (2048, 128) (512^2 values, 1 MB), seed 0 as the
script:

- A: ``take_along_axis`` on axis 0, idx (8192, 128): ``torch.gather``;
- B: a row take of 8192 rows: ``index_select`` (the script's D, XLA's row
  take, is this probe's library call);
- C: a one-hot bf16 matmul row gather on the TPU, which rounds each row
  through bfloat16: the row gather with that rounding;
- E: a row take by a scalar loop with the indices in SMEM: the same rows
  as B, through the same kernel.

    python -m juliaraytracingsw_tpu_torch.profiling prof_pallas2
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import probes
from ._timing import Result, measure, unique_rows

N = 1 << 20
R = 512 * 512 // 128      # 2048 rows of 128


def tables(device):
    """tab3, ridx2d, rows1d as the script draws them (seed 0)."""
    rng = np.random.default_rng(0)
    tab3 = rng.standard_normal((R, 128)).astype(np.float32)
    ridx2d = rng.integers(0, R - 8, (N // 128, 128)).astype(np.int32)
    rows1d = rng.integers(0, R - 8, N // 128).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device) for a in (tab3, ridx2d, rows1d))


def run(device, card: str) -> list[Result]:
    print(f"# prof_pallas2 [{card}]", flush=True)
    tab3, ridx2d, rows1d = tables(device)
    ridx64 = ridx2d.long()          # torch.gather takes int64 indices
    out = [measure("A take_along_axis 0, idx (8192, 128) into (2048, 128) f32", card,
                   kernel="gather_elems", n_rows=N,
                   nbytes=4 * (2 * N + unique_rows(ridx2d * 128
                                                   + torch.arange(128, device=device))),
                   fn=lambda: probes.gather_elems(tab3, ridx2d, "axis0"),
                   plain=lambda: probes.gather_elems_torch(tab3, ridx2d, "axis0"),
                   library=lambda: torch.gather(tab3, 0, ridx64), library_name="torch.gather")]
    n = rows1d.numel()
    row_bytes = 128 * 4
    nbytes = 4 * n + row_bytes * (n + unique_rows(rows1d))
    for name, rnd, lib in (("B row take", False, "index_select"),
                           ("C one-hot bf16 row gather (rows rounded through bf16)", True, None),
                           ("E scalar-loop row take", False, "index_select")):
        out.append(measure(f"{name}, 8192 rows of (2048, 128) f32", card, kernel="gather_rows",
                           n_rows=n, nbytes=nbytes,
                           fn=lambda r=rnd: probes.gather_rows(tab3, rows1d, round_bf16=r),
                           plain=lambda r=rnd: probes.gather_rows_torch(tab3, rows1d,
                                                                        round_bf16=r),
                           library=(lambda: torch.index_select(tab3, 0, rows1d)) if lib else None,
                           library_name=lib))
    return out

