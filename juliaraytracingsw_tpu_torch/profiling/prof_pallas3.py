"""Gather-form variants (port of ``benchmarks/profiling/prof_pallas3.py``).

- A: ``take_along_axis`` on axis 0 as in prof_pallas2 (the TPU block of
  256 index rows; the function is the same);
- A2: ``take_along_axis`` on axis 1 within each of 8192 rows of 128,
  ``out[r, c] = src[r, lidx[r, c]]``: ``torch.gather`` on axis 1.

    python -m juliaraytracingsw_tpu_torch.profiling prof_pallas3
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import probes
from . import prof_pallas2
from ._timing import Result, measure, unique_rows

N = 1 << 20


def run(device, card: str) -> list[Result]:
    print(f"# prof_pallas3 [{card}]", flush=True)
    # the script draws tab3 and ridx2d as prof_pallas2 does, then lidx, src
    rng = np.random.default_rng(0)
    R = prof_pallas2.R
    tab3 = torch.as_tensor(rng.standard_normal((R, 128)).astype(np.float32), device=device)
    ridx2d = torch.as_tensor(rng.integers(0, R - 8, (N // 128, 128)).astype(np.int32),
                             device=device)
    lidx = torch.as_tensor(rng.integers(0, 128, (N // 128, 128)).astype(np.int32), device=device)
    src = torch.as_tensor(rng.standard_normal((N // 128, 128)).astype(np.float32), device=device)
    ridx64, lidx64 = ridx2d.long(), lidx.long()      # torch.gather takes int64 indices
    # indices and output once each, the table values they touch once
    touched = unique_rows(ridx2d * 128 + torch.arange(128, device=device))
    src_touched = unique_rows(lidx + 128 * torch.arange(N // 128, device=device)[:, None])
    return [
        measure("A take_along_axis 0 (block 256), idx (8192, 128) into (2048, 128) f32", card,
                kernel="gather_elems", n_rows=N, nbytes=4 * (2 * N + touched),
                fn=lambda: probes.gather_elems(tab3, ridx2d, "axis0"),
                plain=lambda: probes.gather_elems_torch(tab3, ridx2d, "axis0"),
                library=lambda: torch.gather(tab3, 0, ridx64), library_name="torch.gather"),
        measure("A2 take_along_axis 1, (8192, 128) f32", card, kernel="gather_elems",
                n_rows=N, nbytes=4 * (2 * N + src_touched),
                fn=lambda: probes.gather_elems(src, lidx, "axis1"),
                plain=lambda: probes.gather_elems_torch(src, lidx, "axis1"),
                library=lambda: torch.gather(src, 1, lidx64), library_name="torch.gather"),
    ]

