"""How fast is an element gather from a resident table? (port of
``benchmarks/profiling/prof_pallas_gather.py``)

1,048,576 int32 indices into a float32 table of 512^2 elements (1 MB, in
L2), seed 0 as the script: ``k1`` gathers with indices blocked (2048, 512);
``k2`` (a row take of (2048, 128) and a lane select on the TPU) gives the
same values as an (N, 1) column. Both run the flat element gather; the
script's XLA ``take`` becomes ``torch.take``.

    python -m juliaraytracingsw_tpu_torch.profiling prof_pallas_gather
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import probes
from ._timing import Result, measure, unique_rows

NX = NY = 512
N = 1 << 20
BC = 512     # the script's index block width


def run(device, card: str) -> list[Result]:
    print(f"# prof_pallas_gather [{card}]", flush=True)
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.standard_normal(NY * NX).astype(np.float32), device=device)
    idx = torch.as_tensor(rng.integers(0, NX * NY, N).astype(np.int32), device=device)
    # indices and output once each, the table's touched elements once
    nbytes = 4 * (2 * N + unique_rows(idx))
    idx64 = idx.long()           # torch.take takes int64 indices
    out = []
    for name, shape in (("k1 flat take, idx (2048, 512)", (-1, BC)),
                        ("k2 row take + lane select, out (N, 1)", (-1, 1))):
        shaped, shaped64 = idx.reshape(shape), idx64.reshape(shape)
        out.append(measure(f"{name}, table (512^2,) f32", card, kernel="gather_elems",
                           n_rows=N, nbytes=nbytes,
                           fn=lambda i=shaped: probes.gather_elems(table, i),
                           plain=lambda i=shaped: probes.gather_elems_torch(table, i, "flat"),
                           library=lambda i=shaped64: torch.take(table, i),
                           library_name="torch.take"))
    return out

