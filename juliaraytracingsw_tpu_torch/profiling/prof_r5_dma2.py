"""The rate of per-row copies, in the forms the script's second round tried
(port of ``benchmarks/profiling/prof_r5_dma2.py``).

131,072 rows of 160 f32 from a table of 512^2 rows (seed 0 as the script):

(a) synthetic rows, Q consecutive rows per copy, (K, Q) in (8, 1), (32, 1),
    (8, 8), (8, 32), modulus R - Q;
(b) real scattered indices, staged per block into shared memory first,
    K in (8, 32).

Each at the script's split (16 blocks of 8192 rows) and at 256 blocks of
512; the kernel spreads the copies of either over every SM.

    python -m juliaraytracingsw_tpu_torch.profiling prof_r5_dma2
"""
from __future__ import annotations

import numpy as np
import torch

from ._timing import Result
from .prof_r5_dma_probe import RING_SPLITS, ring

R = 1 << 18
W2 = 160
ROWS = 1 << 17
KQ = ((8, 1), (32, 1), (8, 8), (8, 32))


def run(device, card: str) -> list[Result]:
    print(f"# prof_r5_dma2 [{card}]", flush=True)
    rng = np.random.default_rng(0)
    T32 = torch.as_tensor(rng.standard_normal((R, W2)).astype(np.float32), device=device)
    idx = torch.as_tensor(rng.integers(0, R, ROWS).astype(np.int32), device=device)
    out = []
    for K, Q in KQ:
        for n_blocks, rpb in RING_SPLITS:
            out.append(ring(card, f"(a) synthetic rows K={K} Q={Q}", T32, n_blocks=n_blocks,
                            rows_per_blk=rpb, K=K, Q=Q, modulus=R - Q))
    for K in (8, 32):
        for n_blocks, rpb in RING_SPLITS:
            out.append(ring(card, f"(b) staged indices K={K}", T32, n_blocks=n_blocks,
                            rows_per_blk=rpb, K=K, idx=idx))
    return out

