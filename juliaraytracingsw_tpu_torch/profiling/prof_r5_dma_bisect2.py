"""The per-row copy ring across row widths, loop lengths and depths (port
of ``benchmarks/profiling/prof_r5_dma_bisect2.py``).

The script's six cases (row width W, copies per block, blocks, K, dtype)
over a table of 512^2 rows drawn per case from one seed-0 stream, synthetic
rows modulo R. The cases of 8192 copies per block run again at 256 blocks
of 512, which the kernel spreads over the card as it does the script's.

    python -m juliaraytracingsw_tpu_torch.profiling prof_r5_dma_bisect2
"""
from __future__ import annotations

import numpy as np
import torch

from ._timing import Result
from .prof_r5_dma_probe import ring

R = 1 << 18
CASES = [  # (W, copies per block, blocks, K, dtype), prof_r5_dma_bisect2.py:84-91
    (128, 16, 8, 4, torch.float32),
    (160, 16, 8, 4, torch.float32),
    (128, 8192, 16, 8, torch.float32),
    (160, 8192, 16, 8, torch.float32),
    (128, 8192, 16, 32, torch.float32),
    (160, 8192, 16, 8, torch.bfloat16),
]


def run(device, card: str) -> list[Result]:
    print(f"# prof_r5_dma_bisect2 [{card}]", flush=True)
    rng = np.random.default_rng(0)
    out = []
    for W, it, g, K, dtype in CASES:
        table = torch.as_tensor(rng.standard_normal((R, W)).astype(np.float32),
                                device=device).to(dtype)
        tag = f"W={W}{'b' if dtype == torch.bfloat16 else ''} it={it} K={K}"
        splits = [(g, it)] + ([(g * it // 512, 512)] if it == 8192 else [])
        for n_blocks, rpb in splits:
            out.append(ring(card, tag, table, n_blocks=n_blocks, rows_per_blk=rpb, K=K,
                            modulus=R))
    return out

