"""Three sweeps of the probe kernels' design on an NVIDIA GPU: what the
per-row copy ring's issuing chain costs by rings per SM, what one bulk
copy's latency adds to the staged copies, and what the staged copy's
slice size does.

    python3 scripts/torch_probe_sweeps.py [--json PATH]

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
from juliaraytracingsw_tpu_torch.profiling._timing import (  # noqa: E402
    card_line, device_ms, require_cuda)

R, W2, N_BLOCKS, ROWS_PER_BLK = 1 << 18, 160, 16, 8192
ISSUERS = (1, 2, 4, 8, 16, 32)
CHAINS = {"store": 0, "loads": 1, "loads+fence": 2}
CHAIN_COPIES = (0, 1, 4, 8, 16, 32)
CHAIN_BYTES = 2048
MIN_SLICES = (256, 512, 1024, 2048, 4096)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write the points to this JSON file")
    args = ap.parse_args()
    device = require_cuda()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    so = build()
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    rng = np.random.default_rng(0)
    T32 = torch.as_tensor(rng.standard_normal((R, W2)).astype(np.float32), device=device)
    point = lambda table, **kw: ring_point(so, table, card, n_sms, **kw)  # noqa: E731
    rings = [point(T32, chain=chain, issuers=n, lanes=lanes)
             for chain in ("loads", "loads+fence", "store") for lanes in (1, 32)
             for n in ISSUERS]
    rings += [point(T32, chain="loads", issuers=1, lanes=1, K=K) for K in (1, 2, 4, 16, 32, 64)]
    rings += [point(T32, chain="store", issuers=16, lanes=1, K=K) for K in (4, 16, 32)]
    rings += [point(T32.to(torch.bfloat16), chain="store", issuers=n, lanes=1) for n in ISSUERS]
    rings += [point(T32, chain="store", issuers=16, lanes=1), package_ring(T32, card)]
    chains = copy_chains(so, card, device)
    sliced = slices(card, device)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rings": rings, "chains": chains, "slices": sliced}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
