"""How fast can the card gather the ray path's pair-table rows? (port of
``benchmarks/profiling/prof_r5_dma_probe.py``)

A pair table of R = 512^2 rows of 160 (the bilinear (old|new) row) in
float32 and bfloat16, and 1,048,576 random row indices (seed 0 as the
script), the ray path's gather:

1. row gathers, 16-byte chunks over the flat output: f32 rows, bf16 rows,
   bf16 rows upcast to f32 (the form the ray kernels read), and narrow rows
   of 4 and 8 floats (permuting packet state through a sort order), each
   beside ``index_select``; ``argsort`` of the indices (a library call);
2. the per-row copy ring, one bulk copy (TMA) per row with K = 8 or 32 in
   flight, 131,072 rows at the script's split (16 blocks of 8192 rows) and
   at 256 blocks of 512 (the kernel spreads either over every SM), f32 and
   bf16, each beside ``index_select`` of the same rows;
3. the sorted-window one-hot prototype (a library computation, as the
   script's was XLA): blocks of 2048 sorted cells take their rows from a
   window of 1024 or 2048 table rows by a one-hot bf16 matmul.

    python -m juliaraytracingsw_tpu_torch.profiling prof_r5_dma_probe
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import probes
from ._timing import Result, measure, unique_rows

R = 1 << 18          # table rows (512^2 cells)
W2 = 160             # pair-row width (bilinear)
N = 1 << 20          # the hero's packets
ROWS = 1 << 17       # rows per copy-ring timing (1/8 of the hero gather)
RING_SPLITS = ((16, 8192), (256, 512))     # (blocks, rows per block)
B = 2048             # packets per sorted block
WINDOWS = (1024, 2048)


def row_gather(card, name, table, idx, *, out_dtype=None, library=None, library_name=None):
    """One row-gather probe: ``gather_rows(table, idx)`` against its plain
    version, timed beside ``library``."""
    out_dtype = out_dtype or table.dtype
    n = idx.numel()
    row_in = table.shape[1] * table.element_size()
    row_out = table.shape[1] * torch.empty((), dtype=out_dtype).element_size()
    nbytes = 4 * n + row_out * n + row_in * unique_rows(idx)
    return measure(name, card, kernel="gather_rows", n_rows=n, nbytes=nbytes,
                   fn=lambda: probes.gather_rows(table, idx, out_dtype=out_dtype),
                   plain=lambda: probes.gather_rows_torch(table, idx, out_dtype=out_dtype),
                   library=library, library_name=library_name)


def ring(card, name, table, *, n_blocks, rows_per_blk, K, Q=1, modulus=None, idx=None):
    """One copy-ring probe: ``row_ring`` against its plain version, timed
    beside ``index_select`` of the same rows. The bound counts the table
    rows the copies read once, the rows written and the indices."""
    kw = dict(n_blocks=n_blocks, rows_per_blk=rows_per_blk, K=K, Q=Q, modulus=modulus, idx=idx)
    first = probes.ring_rows(n_blocks, rows_per_blk, Q, modulus=modulus, idx=idx,
                             device=table.device)
    rows = (first[..., None] + torch.arange(Q, device=table.device)).reshape(-1)
    row_bytes = table.shape[1] * table.element_size()
    nbytes = (row_bytes * (unique_rows(rows) + rows.numel())
              + (0 if idx is None else 4 * idx.numel()))
    return measure(f"{name}, {n_blocks} blocks x {rows_per_blk} rows", card, kernel="row_ring",
                   n_rows=rows.numel(), nbytes=nbytes,
                   fn=lambda: probes.row_ring(table, **kw),
                   plain=lambda: probes.row_ring_torch(table, **kw),
                   library=lambda: torch.index_select(table, 0, rows),
                   library_name="index_select")


def sorted_window_onehot(Tb16, cells, WIN, chunk=64):
    """The script's XLA prototype (:164-190) in PyTorch: block j of B sorted
    cells takes the window of WIN table rows from its first cell (clamped
    into the table, as ``dynamic_slice`` clamps) and its rows as a one-hot
    (B, WIN) @ (WIN, W) bf16 product, cells past the window clipped to its
    last row. -> (N, W) float32."""
    nblk = cells.numel() // B
    starts = cells[::B].clamp(max=R - WIN)
    loc = (cells.reshape(nblk, B) - starts[:, None]).clamp(0, WIN - 1)
    iota = torch.arange(WIN, device=cells.device)
    outs = []
    for c in range(0, nblk, chunk):
        win = Tb16[starts[c:c + chunk, None] + iota]                  # (chunk, WIN, W)
        onehot = (loc[c:c + chunk, :, None] == iota).to(torch.bfloat16)   # (chunk, B, WIN)
        outs.append(torch.bmm(onehot, win))
    return torch.cat(outs).reshape(-1, Tb16.shape[1]).float()


def run(device, card: str) -> list[Result]:
    print(f"# prof_r5_dma_probe [{card}]", flush=True)
    rng = np.random.default_rng(0)
    T32 = torch.as_tensor(rng.standard_normal((R, W2)).astype(np.float32), device=device)
    Tb16 = T32.to(torch.bfloat16)
    idx = torch.as_tensor(rng.integers(0, R, N).astype(np.int32), device=device)
    out = [
        row_gather(card, "take W=160 f32, 1M rows", T32, idx,
                   library=lambda: torch.index_select(T32, 0, idx), library_name="index_select"),
        row_gather(card, "take W=160 bf16, 1M rows", Tb16, idx,
                   library=lambda: torch.index_select(Tb16, 0, idx),
                   library_name="index_select"),
        row_gather(card, "take W=160 bf16 -> f32, 1M rows (the ray kernels' input)", Tb16, idx,
                   out_dtype=torch.float32,
                   library=lambda: torch.index_select(Tb16, 0, idx).float(),
                   library_name="index_select + .float() (two calls)"),
    ]
    for Wn in (4, 8):
        Tn = torch.as_tensor(rng.standard_normal((N, Wn)).astype(np.float32), device=device)
        out.append(row_gather(card, f"take W={Wn} (1M rows, permute-like)", Tn, idx,
                              library=lambda Tn=Tn: torch.index_select(Tn, 0, idx),
                              library_name="index_select"))
    out.append(measure("argsort 1M i32", card, n_rows=N, nbytes=4 * N + 8 * N,
                       library=lambda: torch.argsort(idx), library_name="torch.argsort"))

    for K in (8, 32):
        for table, tag in ((T32, "f32"), (Tb16, "bf16")):
            for n_blocks, rpb in RING_SPLITS:
                out.append(ring(card, f"per-row copy ring K={K} {tag}", table,
                                n_blocks=n_blocks, rows_per_blk=rpb, K=K, modulus=R))

    cells = torch.sort(idx).values
    for WIN in WINDOWS:
        starts = cells[::B].clamp(max=R - WIN)
        covered = torch.zeros(R, dtype=torch.bool, device=device)
        covered[starts[:, None] + torch.arange(WIN, device=device)] = True
        got = sorted_window_onehot(Tb16, cells, WIN)
        loc = (cells.reshape(-1, B) - starts[:, None]).clamp(0, WIN - 1)
        if not torch.equal(got, Tb16[(starts[:, None] + loc).reshape(-1)].float()):
            raise AssertionError(f"sorted window WIN={WIN}: the one-hot product is not the "
                                 f"row gather it stands for")
        out.append(measure(f"sorted-window WIN={WIN} one-hot bf16 bmm (prototype)", card,
                           n_rows=N, nbytes=4 * N + 4 * W2 * N + 2 * W2 * int(covered.sum()),
                           library=lambda WIN=WIN: sorted_window_onehot(Tb16, cells, WIN),
                           library_name="torch.bmm in chunks"))
    return out

