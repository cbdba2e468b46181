"""The asynchronous-copy features one at a time (port of
``benchmarks/profiling/prof_r5_dma_bisect.py``).

On (256, 128) float32 (seed 0 as the script), ``k0``..``k5`` of the script
through the staged copy kernel (``ops/probes.COPY_PROBES``): plain loads; one
whole-buffer bulk copy (TMA) into shared memory on an mbarrier; the same on
an mbarrier array; copies at a runtime offset; a loop of serial copies, each
waited; a ring of 4 copies in flight with delayed waits. Each output is
``2 x`` of the rows the copies leave, beside ``torch.mul`` of those rows.

    python -m juliaraytracingsw_tpu_torch.profiling prof_r5_dma_bisect
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import probes
from ._timing import Result, measure

CASES = {"k0": "vmem-elementwise (plain loads)", "k1": "one bulk copy + mbarrier",
         "k2": "mbarrier array", "k3": "runtime-offset copies",
         "k4": "loop of serial copies", "k5": "ring of 4 in flight"}


def run(device, card: str) -> list[Result]:
    print(f"# prof_r5_dma_bisect [{card}]", flush=True)
    X = torch.as_tensor(np.random.default_rng(0).standard_normal((256, 128)).astype(np.float32),
                        device=device)
    row_ids = torch.arange(256, dtype=torch.float32, device=device)[:, None]
    out = []
    for name, what in CASES.items():
        sched, a, b, _ = probes.COPY_PROBES[name]
        # the rows the plain version keeps, which are one run in each case
        rows = probes.staged_copy_torch(row_ids, sched, 1.0, 0.0)[:, 0].long().tolist()
        lo, hi = rows[0], rows[-1] + 1
        assert rows == list(range(lo, hi)) and b == 0.0
        out.append(measure(f"{name} {what}: 2 x[{lo}:{hi}]", card, kernel="probe_copy",
                           n_rows=hi - lo, nbytes=2 * (hi - lo) * 128 * 4,
                           fn=lambda s=sched, a=a, b=b: probes.staged_copy(X, s, a, b),
                           plain=lambda s=sched, a=a, b=b: probes.staged_copy_torch(X, s, a, b),
                           library=lambda lo=lo, hi=hi, a=a: torch.mul(X[lo:hi], a),
                           library_name="torch.mul"))
    return out

