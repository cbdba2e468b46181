"""Four sweeps of the probe kernels' design on an NVIDIA GPU: what the
per-row copy ring's issuing chain costs by rings per SM, what one bulk
copy's latency adds to the staged copies, what the staged copy's slice
size does, and what bounds the gathers.

    python3 scripts/torch_probe_sweeps.py [--json PATH] [ring chain slices gathers]

(all four without names)

1. Variants of the ring kernel that the package does not ship, compiled
   here from ``scripts/torch_probe_sweeps.cu``, over the probes' shapes:
   131,072 rows of 160 float32 from a table of 512^2 rows (seed 0), one row
   a copy, synthetic rows (``prof_r5_dma2`` (a), K = 8), cut into rings on
   every SM. For each chain

   - ``loads``: the copies alone (each ring waits for a copy, then starts
     the one K later into its slot; out is not written),
   - ``loads+fence``: the same with a proxy fence before each copy,
   - ``store``: the function, each landed copy written back by a bulk store
     (the package's ``csrc/probe_row_ring.cu``),

   each packing of rings (one per warp, or one per lane of one warp) and 1,
   2, 4, 8, 16 and 32 rings per SM: the device time (a CUDA graph,
   ``_timing.device_ms``), the time one copy costs its ring (the time over
   the copies a ring issues) and the copies an SM starts per microsecond.
   The ``store`` rows are held bit-equal to the plain version first. Then
   the copies alone at one ring per SM with K = 1 to 64 in flight, the
   function at K = 4, 16 and 32 at 16 rings per SM, bf16 rows, and the
   package's own ``row_ring`` beside the ``store`` variant at its 16 rings
   per SM.
2. A chain of n dependent bulk copies of 2 KB (the staged copy's slice),
   one thread, from a (256, 128) float32 buffer in L2: n = 0 is a launch
   alone; the chain of 1, 4 and 8 copies is the least time of the staged
   probes k1-k5 (1, 1, 4, 8 and 4 dependent copies: k5 starts 16, 4 in
   flight), measured apart from their kernel.
3. The staged copy (``csrc/probe_copy.cu``) on the schedules of
   ``prof_r5_dma_bisect`` k1-k5, (256, 128) float32, with every copy cut
   into slices of at least 256, 512, 1024, 2048 (the package's
   ``COPY_SLICE_MIN``) and 4096 bytes, each held bit-equal to the plain
   version and timed as above.
4. The gathers (``csrc/probe_gather.cu``), with variants compiled from
   the same ``.cu``:

   - ``l2``: 1,048,576 random 4-byte reads from a 1 MB table (512^2 f32)
     with no index or output stream, 0 (the launch alone), 1, 4, 8 and 16
     reads a thread: the least of them is the L2-sector bound of an
     element gather from a resident table;
   - ``cluster``: the flat element gather of ``prof_pallas_gather`` (1M
     indices into 512^2 f32, seed 0) with the table spread over the shared
     memory of clusters of 8 blocks, beside the package's ``gather_elems``;
   - ``rows``: the row gather's chunk mapping in one pass (a thread a
     chunk for every U rows) with 1, 2, 4 and 8 rows in flight a thread and
     three sets of cache hints (none; streaming stores, the package's;
     streaming index loads, evict-last table loads and streaming stores)
     on ``prof_r5_dma_probe``'s 1M rows of 160 f32 and bf16, those bf16
     rows upcast to f32, 1M rows of 4 and 8 f32 and ``prof_pallas2``'s
     8192 rows of 128 f32 (kB);
   - ``geometry``: with the package's hints, the same rows in flight on a
     grid the card holds, striding over the rows, on the same forms,
     beside the package's ``gather_rows``;
   - ``library``: ``index_select`` on the same forms (but the upcast) with
     the int32 and with an int64 index;
   - ``small``: kB alone, the package's ``gather_rows`` (one warp a row
     there) beside the sweeps' own warp a row and the chunk mapping in one
     pass with 1 and 2 rows in flight, without and with the package's
     hints, timed in 7 rounds, the order reversed every other round, each
     variant's median and spread.

   Every variant is held bit-equal to the plain version first.

Needs a CUDA device and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from juliaraytracingsw_tpu_torch.ops import _build, probes  # noqa: E402
from juliaraytracingsw_tpu_torch.profiling import prof_pallas2  # noqa: E402
from juliaraytracingsw_tpu_torch.profiling._timing import (  # noqa: E402
    card_line, device_ms, require_cuda)

R, W2, N_BLOCKS, ROWS_PER_BLK = 1 << 18, 160, 16, 8192
ISSUERS = (1, 2, 4, 8, 16, 32)
CHAINS = {"store": 0, "loads": 1, "loads+fence": 2}
CHAIN_COPIES = (0, 1, 4, 8, 16, 32)
CHAIN_BYTES = 2048
MIN_SLICES = (256, 512, 1024, 2048, 4096)
N_GATHER, TAB_LOG2 = 1 << 20, 18      # the gather probes' indices and 512^2 table
L2_READS_PER_THREAD = (0, 1, 4, 8, 16)
ROWS_IN_FLIGHT = (1, 2, 4, 8)
ROW_HINTS = ("none", "streaming stores",
             "streaming index loads, evict-last loads, streaming stores")
PACKAGE_HINT = 1
# dependent copies on each staged probe's critical path
DEPTH = {"k1": 1, "k2": 1, "k3": 4, "k4": 8, "k5": 4}


def build() -> ctypes.CDLL:
    """Compile ``torch_probe_sweeps.cu`` into the package's ignored build
    directory and load it."""
    src = Path(__file__).with_suffix(".cu")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD_DIR / "torch_probe_sweeps.so"
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        tmp = Path(work) / "lib.so"
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                               "-I", str(_build.CSRC), "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, lib)
    so = ctypes.CDLL(str(lib))
    so.sweep_ring.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
                              + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    so.sweep_copy_chain.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_void_p]
    so.sweep_l2_reads.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]
    so.sweep_cluster_max.argtypes = [ctypes.c_int]
    so.sweep_cluster_gather.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_void_p]
    so.sweep_warp_rows.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                             ctypes.c_longlong, ctypes.c_void_p])
    so.sweep_rows.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                                        ctypes.c_longlong] + [ctypes.c_int] * 4
                              + [ctypes.c_void_p])
    return so


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(what: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{what}: launch failed, cudaError_t {err}")


def ring_point(so, table, card, n_sms, *, chain, issuers, lanes, K=8) -> dict:
    """One ring configuration: the variant's time and the chain's cost."""
    n_copies = N_BLOCKS * ROWS_PER_BLK
    row_bytes = table.shape[1] * table.element_size()
    ring_bytes = _cdiv((K + 1) * (row_bytes + 8), 128) * 128
    issuers = min(issuers, probes.SMEM_LIMIT // ring_bytes)    # as many as shared memory holds
    chunk = _cdiv(n_copies, issuers * n_sms)
    n_rings = _cdiv(n_copies, chunk)
    per_block = min(issuers, _cdiv(n_rings, n_sms))
    lanes = min(lanes, per_block)
    warps = _cdiv(per_block, lanes)
    blocks = _cdiv(n_rings, warps * lanes)

    def run():
        # the chains without writeback leave out unwritten
        out = torch.empty_like(table[:n_copies]) if chain == "store" else table
        _check("sweep_ring", so.sweep_ring(
            table.data_ptr(), table.shape[0], out.data_ptr(), n_copies, K, row_bytes,
            probes.RING_STRIDE, probes.RING_OFFSET, R, n_rings, chunk, warps, lanes,
            ring_bytes, CHAINS[chain], _stream()))
        return out

    if chain == "store":
        want = probes.row_ring_torch(table, n_blocks=N_BLOCKS, rows_per_blk=ROWS_PER_BLK, K=K,
                                     modulus=R).reshape(n_copies, -1)
        if not torch.equal(run(), want):
            raise AssertionError(f"{chain}, {issuers} rings per SM, lanes {lanes}: the variant "
                                 f"disagrees with the plain version")
    ms = device_ms(run)
    res = dict(chain=chain, issuers_per_sm=issuers, lanes=lanes, K=K,
               dtype=str(table.dtype).removeprefix("torch."), rings=n_rings, chunk=chunk,
               blocks=blocks, rings_per_block=warps * lanes, ms=ms,
               us_per_copy_and_ring=ms * 1e3 / chunk,
               copies_per_sm_per_us=n_copies / blocks / (ms * 1e3))
    print(f"{chain:12s} K={K:2d} {res['dtype']:8s} rings/SM {warps * lanes:2d} "
          f"(lanes {lanes:2d}, {blocks} blocks, {chunk} copies a ring): "
          f"{ms:.4f} ms, {res['us_per_copy_and_ring']:.4f} us per copy and ring, "
          f"{res['copies_per_sm_per_us']:.3f} copies per SM and us [{card}]", flush=True)
    return res


def package_ring(table, card) -> dict:
    """The package's ``row_ring`` at the same shape (16 rings an SM)."""
    kw = dict(n_blocks=N_BLOCKS, rows_per_blk=ROWS_PER_BLK, K=8, modulus=R)
    if not torch.equal(probes.row_ring(table, **kw), probes.row_ring_torch(table, **kw)):
        raise AssertionError("row_ring disagrees with its plain version")
    ms = device_ms(lambda: probes.row_ring(table, **kw))
    print(f"package row_ring K= 8 {str(table.dtype).removeprefix('torch.'):8s} rings/SM "
          f"{probes.RING_ISSUERS_PER_SM}: {ms:.4f} ms [{card}]", flush=True)
    return dict(chain="package row_ring", K=8, ms=ms)


def copy_chains(so, card, device) -> list[dict]:
    """One thread's chain of n dependent 2 KB bulk copies from L2."""
    x = torch.zeros((256, 128), dtype=torch.float32, device=device)
    out = []
    for n in CHAIN_COPIES:
        ms = device_ms(lambda n=n: _check("sweep_copy_chain", so.sweep_copy_chain(
            x.data_ptr(), CHAIN_BYTES, n, x.numel() * 4, _stream())))
        out.append(dict(copies=n, bytes=CHAIN_BYTES, ms=ms))
        print(f"chain of {n:2d} dependent {CHAIN_BYTES} B bulk copies from L2: {ms:.4f} ms "
              f"[{card}]", flush=True)
    t = {p["copies"]: p["ms"] for p in out}
    lat = (t[32] - t[0]) / 32
    print(f"one dependent copy adds {lat * 1e3:.4f} us ((chain of 32 - launch) / 32); "
          f"latency-chain bound of the staged probes: "
          + ", ".join(f"{k} {t[d]:.4f} ms ({d} copies)" for k, d in DEPTH.items())
          + f" [{card}]", flush=True)
    return out


def slices(card, device) -> list[dict]:
    """The staged copies k1-k5 at each least slice size, through the
    package's kernel with the slices cut here."""
    x = torch.as_tensor(np.random.default_rng(0).standard_normal((256, 128)).astype(np.float32),
                        device=device)
    fn = probes._lib_fn("jrsw_probe_copy", [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                        + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_float,
                                                ctypes.c_void_p])
    out = []
    for min_slice in MIN_SLICES:
        for name in DEPTH:
            sched, a, b, shape = probes.COPY_PROBES[name]
            copy_bytes = sched.q * shape[1] * 4
            n = max(1, copy_bytes // min_slice)
            slice_bytes = copy_bytes // 16 // n * 16

            def run(name=name, sched=sched, a=a, b=b, slice_bytes=slice_bytes, n=n):
                got = torch.empty((sched.n_slots * sched.q, shape[1]), device=device)
                _check(name, fn(1, x.data_ptr(), got.data_ptr(), shape[1], sched.q,
                                sched.n_copies, sched.wrap, sched.n_slots, sched.in_flight,
                                slice_bytes, n, 1, a, b, _stream()))
                return got

            if not torch.equal(run(), probes.staged_copy_torch(x, sched, a, b)):
                raise AssertionError(f"{name}, slices of {min_slice}: the kernel disagrees "
                                     f"with its plain version")
            ms = device_ms(run)
            out.append(dict(probe=name, min_slice=min_slice, blocks=n, ms=ms))
            print(f"staged copy {name}, slices of at least {min_slice} B ({n} blocks): "
                  f"{ms:.4f} ms [{card}]", flush=True)
    return out


def l2_reads(so, card, device) -> list[dict]:
    """Random 4-byte reads from the 1 MB table alone, by reads a thread."""
    table = torch.as_tensor(np.random.default_rng(0).standard_normal(1 << TAB_LOG2)
                            .astype(np.float32), device=device)
    sink = torch.zeros(1, device=device)
    out = []
    for per in L2_READS_PER_THREAD:
        ms = device_ms(lambda per=per: _check("sweep_l2_reads", so.sweep_l2_reads(
            table.data_ptr(), TAB_LOG2, N_GATHER, per, sink.data_ptr(), _stream())))
        out.append(dict(reads_per_thread=per, ms=ms))
        print(f"l2 {N_GATHER} random 4-byte reads from a {4 << TAB_LOG2 >> 20} MB table, "
              f"{per:2d} a thread: {ms:.4f} ms ({N_GATHER * 32 / 1e6:.1f} MB of 32-byte sectors)"
              f" [{card}]", flush=True)
    best = min(p["ms"] for p in out if p["reads_per_thread"])
    print(f"l2-sector bound of a 1M-element gather from the 1 MB table: {best:.4f} ms (the "
          f"least above) [{card}]", flush=True)
    return out


def cluster_gather(so, card, device) -> list[dict]:
    """The flat gather from clusters' shared memory, beside the package's."""
    rng = np.random.default_rng(0)
    table = torch.as_tensor(rng.standard_normal(1 << TAB_LOG2).astype(np.float32), device=device)
    idx = torch.as_tensor(rng.integers(0, 1 << TAB_LOG2, N_GATHER).astype(np.int32),
                          device=device)
    want = probes.gather_elems_torch(table, idx, "flat")
    s = TAB_LOG2 - 3                       # 8 blocks of 2^s floats
    clusters = so.sweep_cluster_max(s)
    if clusters < 1:
        raise RuntimeError(f"no cluster of 8 blocks with {4 << s} bytes of shared memory each "
                           f"fits the card ({clusters})")

    def run():
        got = torch.empty_like(want)
        _check("sweep_cluster_gather", so.sweep_cluster_gather(
            table.data_ptr(), s, idx.data_ptr(), got.data_ptr(), N_GATHER, clusters, _stream()))
        return got

    out = []
    for name, fn in (("cluster-resident table", run),
                     ("package gather_elems", lambda: probes.gather_elems(table, idx))):
        if not torch.equal(fn(), want):
            raise AssertionError(f"{name}: the flat gather disagrees with its plain version")
        ms = device_ms(fn)
        out.append(dict(variant=name, clusters=clusters, ms=ms))
        print(f"cluster flat gather, 1M of 512^2 f32, {name}"
              f"{f' ({clusters} clusters of 8 blocks)' if fn is run else ''}: {ms:.4f} ms "
              f"[{card}]", flush=True)
    return out


def _row_point(so, card, sweep, form, table, idx, *, u, hint, upcast=False,
               card_grid=True) -> dict:
    """One row-gather variant, held bit-equal to the plain version, timed."""
    out_dtype = torch.float32 if upcast else table.dtype
    row_bytes = table.shape[1] * table.element_size()

    def run():
        got = torch.empty((idx.numel(), table.shape[1]), dtype=out_dtype, device=table.device)
        _check("sweep_rows", so.sweep_rows(
            table.data_ptr(), idx.data_ptr(), got.data_ptr(), idx.numel(), row_bytes,
            table.shape[0], u, ROW_HINTS.index(hint), int(upcast), int(card_grid), _stream()))
        return got

    what = (f"{sweep} {form}, {u} in flight, {hint}, "
            f"{'grid the card holds' if card_grid else 'one pass'}")
    if not torch.equal(run(), table[idx.long()].to(out_dtype)):
        raise AssertionError(f"{what}: the variant disagrees with the plain version")
    ms = device_ms(run)
    print(f"{what}: {ms:.4f} ms [{card}]", flush=True)
    return dict(sweep=sweep, form=form, in_flight=u, hints=hint, card_grid=card_grid, ms=ms)


def row_variants(so, card, device) -> list[dict]:
    """The row gather by rows in flight and L2 hints in one pass, by rows
    in flight on a card-sized grid, the package's, and ``index_select`` by
    index dtype."""
    rng = np.random.default_rng(0)
    T32 = torch.as_tensor(rng.standard_normal((R, W2)).astype(np.float32), device=device)
    idx = torch.as_tensor(rng.integers(0, R, N_GATHER).astype(np.int32), device=device)
    # (table, indices, upcast) by form
    forms = {"1M x 160 f32": (T32, idx, False), "1M x 160 bf16": (T32.to(torch.bfloat16), idx,
                                                                  False)}
    for w in (4, 8):
        forms[f"1M x {w} f32"] = (torch.as_tensor(
            rng.standard_normal((N_GATHER, w)).astype(np.float32), device=device), idx, False)
    forms["1M x 160 bf16 -> f32"] = (forms["1M x 160 bf16"][0], idx, True)
    tab3, _, rows1d = prof_pallas2.tables(device)
    forms["kB 8192 x 128 f32"] = (tab3, rows1d, False)
    out = [_row_point(so, card, "rows", form, table, i, u=u, hint=hint, upcast=upcast,
                      card_grid=False)
           for form, (table, i, upcast) in forms.items() for u in ROWS_IN_FLIGHT
           for hint in ROW_HINTS]
    for form, (table, i, upcast) in forms.items():
        out += [_row_point(so, card, "geometry", form, table, i, u=u,
                           hint=ROW_HINTS[PACKAGE_HINT], upcast=upcast)
                for u in ROWS_IN_FLIGHT]
        kw = dict(out_dtype=torch.float32) if upcast else {}
        ms = device_ms(lambda table=table, i=i, kw=kw: probes.gather_rows(table, i, **kw))
        out.append(dict(sweep="package", form=form, ms=ms))
        print(f"package gather_rows {form}: {ms:.4f} ms [{card}]", flush=True)
        if upcast:
            continue
        for kind, ii in (("int32", i), ("int64", i.long())):
            ms = device_ms(lambda table=table, ii=ii: torch.index_select(table, 0, ii))
            out.append(dict(sweep="library", form=form, index=kind, ms=ms))
            print(f"library index_select {form}, {kind} index: {ms:.4f} ms [{card}]", flush=True)
    return out


def small_rows(so, card, device, rounds: int = 7) -> list[dict]:
    """kB's 8192 rows of 512 bytes: the package, one warp a row, and the
    chunk mapping's one pass by rows in flight and hints, in alternating
    order."""
    table, _, rows = prof_pallas2.tables(device)
    want = table[rows.long()]
    row_bytes, n = table.shape[1] * 4, rows.numel()

    def variant(u, h):
        def run():
            got = torch.empty_like(want)
            _check("sweep_rows", so.sweep_rows(table.data_ptr(), rows.data_ptr(), got.data_ptr(),
                                               n, row_bytes, table.shape[0], u, h, 0, 0,
                                               _stream()))
            return got
        return run

    def warp_rows():
        got = torch.empty_like(want)
        _check("sweep_warp_rows", so.sweep_warp_rows(table.data_ptr(), rows.data_ptr(),
                                                     got.data_ptr(), n, row_bytes,
                                                     table.shape[0], _stream()))
        return got

    fns = {"package gather_rows": lambda: probes.gather_rows(table, rows),
           "one warp a row": warp_rows}
    for u in (1, 2):
        for h in (0, PACKAGE_HINT):
            fns[f"one pass, {u} in flight, {ROW_HINTS[h]}"] = variant(u, h)
    for name, fn in fns.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"small {name}: disagrees with the plain version")
    times = {name: [] for name in fns}
    for k in range(rounds):
        for name in (list(fns) if k % 2 == 0 else list(reversed(fns))):
            times[name].append(device_ms(fns[name]))
    out = []
    for name, ts in times.items():
        med = float(np.median(ts))
        out.append(dict(variant=name, median_ms=med, ms=ts))
        print(f"small kB 8192 x 128 f32, {name}: median {med:.4f} ms over {rounds} rounds "
              f"({min(ts):.4f}-{max(ts):.4f}) [{card}]", flush=True)
    return out


SWEEPS = ("ring", "chain", "slices", "gathers")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the points to this JSON file")
    ap.add_argument("sweeps", nargs="*", choices=SWEEPS, help="the sweeps to run (default all)")
    args = ap.parse_args()
    todo = args.sweeps or SWEEPS
    device = require_cuda()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    so = build()
    points = {"card": card}
    if "ring" in todo:
        n_sms = torch.cuda.get_device_properties(device).multi_processor_count
        rng = np.random.default_rng(0)
        T32 = torch.as_tensor(rng.standard_normal((R, W2)).astype(np.float32), device=device)
        point = lambda table, **kw: ring_point(so, table, card, n_sms, **kw)  # noqa: E731
        rings = [point(T32, chain=chain, issuers=n, lanes=lanes)
                 for chain in ("loads", "loads+fence", "store") for lanes in (1, 32)
                 for n in ISSUERS]
        rings += [point(T32, chain="loads", issuers=1, lanes=1, K=K)
                  for K in (1, 2, 4, 16, 32, 64)]
        rings += [point(T32, chain="store", issuers=16, lanes=1, K=K) for K in (4, 16, 32)]
        rings += [point(T32.to(torch.bfloat16), chain="store", issuers=n, lanes=1)
                  for n in ISSUERS]
        rings += [point(T32, chain="store", issuers=16, lanes=1), package_ring(T32, card)]
        points["rings"] = rings
        del T32
    if "chain" in todo:
        points["chains"] = copy_chains(so, card, device)
    if "slices" in todo:
        points["slices"] = slices(card, device)
    if "gathers" in todo:
        points["l2"] = l2_reads(so, card, device)
        points["cluster"] = cluster_gather(so, card, device)
        points["rows"] = row_variants(so, card, device)
        points["small"] = small_rows(so, card, device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(points, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
