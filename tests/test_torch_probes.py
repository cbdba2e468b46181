"""The 19 Pallas probe kernels of ``benchmarks/profiling/`` against the
port's plain versions (``juliaraytracingsw_tpu_torch/ops/probes.py``), on
the CPU.

The probe scripts run their probes when imported, so their kernel bodies
and ``pallas_call`` builders are read from the scripts' source with ``ast``
and executed in a namespace that gives the scripts' module constants at a
test size and a ``pl`` whose ``pallas_call`` interprets (``interpret=True``).
Calls the scripts make at module level are restated here, each beside the
lines it restates. Every comparison is bit-equality: the probes only move
values (the copies' ``2x + 1`` and ``2x`` are exact in float32 either way).
"""
import ast
import functools
import inspect
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from juliaraytracingsw_tpu_torch.ops import probes  # noqa: E402
from torch_probe_cases import EXTRA_COPY_SCHEDULES  # noqa: E402

PROF = Path(__file__).resolve().parent.parent / "benchmarks" / "profiling"

# a `pl` whose pallas_call runs in interpret mode on the CPU
_pl = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("__")})
_pl.pallas_call = functools.partial(pl.pallas_call, interpret=True)


def _load(script: str, *names: str, **consts) -> dict:
    """Execute the function definitions ``names`` (at any depth) of a probe
    script in a namespace holding ``consts``; return the namespace."""
    path = PROF / script
    tree = ast.parse(path.read_text(), str(path))
    defs = {n.name: n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)}
    missing = set(names) - set(defs)
    assert not missing, f"{script} no longer defines {missing}"
    ns = dict(jax=jax, jnp=jnp, np=np, pl=_pl, pltpu=pltpu, **consts)
    exec(compile(ast.Module(body=[defs[n] for n in names], type_ignores=[]), str(path),
                 "exec"), ns)
    return ns


def _t(a) -> torch.Tensor:
    """A numpy or JAX array as a CPU tensor (bfloat16 kept)."""
    if getattr(a, "dtype", None) == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _equal(port: torch.Tensor, pallas) -> None:
    ref = _t(pallas)
    assert port.shape == ref.shape and port.dtype == ref.dtype
    assert torch.equal(port, ref), float((port.float() - ref.float()).abs().max())


# --- A: the copy probes ------------------------------------------------------

def _bisect_call(X, kern, out_rows, scratch=None, sem=None, grid=None):
    """prof_r5_dma_bisect.py:51-164: the module-level pallas_calls of k0..k5."""
    if grid:
        kw = dict(grid=grid, out_specs=_pl.BlockSpec((out_rows, 128), lambda i: (0, 0),
                                                     memory_space=pltpu.VMEM))
    else:
        kw = dict(out_specs=_pl.BlockSpec(memory_space=pltpu.VMEM))
    return _pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((out_rows, 128), jnp.float32),
        in_specs=[_pl.BlockSpec(memory_space=pl.ANY if scratch else pltpu.VMEM)],
        scratch_shapes=[s for s in (scratch, sem) if s is not None], **kw)(X)


_BISECT = {   # name: (out rows, scratch rows, semaphore shape, grid), from :51-164
    "k0": (256, None, None, None),
    "k1": (256, 256, (), None),
    "k2": (256, 256, (2,), None),
    "k3": (8, 8, (), (4,)),
    "k4": (8, 8, (), None),
    "k5": (64, 64, (4,), None),
}


@pytest.mark.parametrize("name", ["trivial", *_BISECT])
def test_copy_probe_matches_pallas(name):
    """prof_pallas_probe.py:37-56 ``trivial`` and prof_r5_dma_bisect.py
    ``k0``..``k5``, at the scripts' own shapes."""
    sched, a, b, shape = probes.COPY_PROBES[name]
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if name == "trivial":
        kernel = _load("prof_pallas_probe.py", "kernel")["kernel"]
        # prof_pallas_probe.py:47-53
        got = _pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                              in_specs=[_pl.BlockSpec(memory_space=pltpu.VMEM)],
                              out_specs=_pl.BlockSpec(memory_space=pltpu.VMEM))(jnp.asarray(x))
    else:
        rows, scr, sem, grid = _BISECT[name]
        kern = _load("prof_r5_dma_bisect.py", name)[name]
        got = _bisect_call(jnp.asarray(x), kern, rows,
                           None if scr is None else pltpu.VMEM((scr, 128), jnp.float32),
                           None if sem is None else pltpu.SemaphoreType.DMA(sem), grid)
    assert sched.staged == (name not in ("trivial", "k0"))
    _equal(probes.staged_copy(torch.from_numpy(x), sched, a, b), got)


def _simulated_ring(x, sched, a, b):
    """A schedule run one copy at a time into a ring of slots, as the Pallas
    probes and the kernel run it (in-flight copies land in issue order)."""
    ring = np.zeros((sched.n_slots, sched.q, x.shape[1]), np.float32)
    for i in range(sched.n_copies):
        start = (i * sched.q) % sched.wrap
        ring[i % sched.n_slots] = x[start:start + sched.q]
    return ring.reshape(-1, x.shape[1]) * np.float32(a) + np.float32(b)


@pytest.mark.parametrize("case", range(len(EXTRA_COPY_SCHEDULES)))
def test_copy_plain_version_is_the_ring_it_simulates(case):
    """The plain version of the schedules the GPU tests add, against the
    ring run copy by copy."""
    sched, shape = EXTRA_COPY_SCHEDULES[case]
    x = np.random.default_rng(case).standard_normal(shape).astype(np.float32)
    got = probes.staged_copy(torch.from_numpy(x), sched, 2.0, 0.5)
    assert torch.equal(got, torch.from_numpy(_simulated_ring(x, sched, 2.0, 0.5)))


@pytest.mark.parametrize("copy_bytes", [16, 48, 512, 2032, 2048, 4096, 4112, 5008, 20480,
                                        131072, 262144, 262160])
def test_copy_slices_tile_every_copy(copy_bytes):
    """The staged kernel's slices of one copy: 16-byte multiples that tile
    it, none empty, at least 2 KB each where the copy is, the last the
    longest by less than 16 bytes a slice."""
    slice_bytes, n = probes.copy_slices(copy_bytes)
    bounds = [(s * slice_bytes, (s + 1) * slice_bytes if s + 1 < n else copy_bytes)
              for s in range(n)]
    assert bounds[0][0] == 0 and bounds[-1][1] == copy_bytes
    assert all(hi > lo and lo % 16 == 0 and hi % 16 == 0 for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert n == max(1, copy_bytes // probes.COPY_SLICE_MIN)
    sizes = [hi - lo for lo, hi in bounds]
    assert max(sizes) == sizes[-1] < slice_bytes + 16 * n
    if copy_bytes >= probes.COPY_SLICE_MIN:
        assert min(sizes) >= probes.COPY_SLICE_MIN


def test_copy_slices_of_the_pallas_schedules():
    """k1 and k2's 128 KB copy on 64 blocks, the 4 KB copies of k3-k5 on 2;
    a copy that is no 16-byte multiple is refused."""
    got = {name: probes.copy_slices(sched.q * shape[1] * 4)
           for name, (sched, _, _, shape) in probes.COPY_PROBES.items() if sched.staged}
    assert got == {"k1": (2048, 64), "k2": (2048, 64), "k3": (2048, 2), "k4": (2048, 2),
                   "k5": (2048, 2)}
    with pytest.raises(ValueError, match="16 bytes"):
        probes.copy_slices(40)


def test_copy_schedules_name_the_surviving_rows():
    """The rows the Pallas probes end with (prof_r5_dma_bisect.py:89-164),
    as the plain version takes them: x holds each row's index."""
    x = torch.arange(256, dtype=torch.float32)[:, None]
    rows = {name: probes.staged_copy_torch(x, probes.COPY_PROBES[name][0], 1.0, 0.0)[:, 0]
            .long().tolist() for name in ("k3", "k4", "k5")}
    assert rows == {"k3": list(range(24, 32)), "k4": list(range(56, 64)),
                    "k5": list(range(64, 128))}


# --- B: element gathers ------------------------------------------------------

def _gather_case(name):
    """(port output, Pallas output) at a test size: the scripts' block
    shapes, fewer rows."""
    rng = np.random.default_rng(0)
    if name in ("k1", "k2"):
        # prof_pallas_gather.py:30-37: table (ny nx,), 1M indices; here 64^2, 16k
        R, N = 64 * 64, 1 << 14
        table = rng.standard_normal(R).astype(np.float32)
        idx = rng.integers(0, R, N).astype(np.int32)
        ns = _load("prof_pallas_gather.py", "k1", "g1", "k2", "g2", BR=8, BC=512, B2=1024)
        if name == "k1":
            idx2d = idx.reshape(-1, 512)                     # :62
            got = ns["g1"](jnp.asarray(idx2d), jnp.asarray(table))
            port = probes.gather_elems(torch.from_numpy(table), torch.from_numpy(idx2d))
        else:
            got = ns["g2"](jnp.asarray(idx), jnp.asarray(table))
            port = probes.gather_elems(torch.from_numpy(table),
                                       torch.from_numpy(idx.reshape(-1, 1)))
        return port, got
    # prof_pallas2.py:13-31 / prof_pallas3.py:12-30: tab3 (R, 128), ridx2d
    # (N / 128, 128); here R = 64, N / 128 = 256
    R, N = 64, 128 * 256
    tab3 = rng.standard_normal((R, 128)).astype(np.float32)
    ridx2d = rng.integers(0, R - 8, (N // 128, 128)).astype(np.int32)
    consts = dict(R=R, N=N, tab3=jnp.asarray(tab3), ridx2d=jnp.asarray(ridx2d))
    if name == "kA2":
        # prof_pallas3.py:62-63
        lidx = rng.integers(0, 128, (N // 128, 128)).astype(np.int32)
        src = rng.standard_normal((N // 128, 128)).astype(np.float32)
        ns = _load("prof_pallas3.py", "kA2", "gA2", BA=128, lidx=jnp.asarray(lidx),
                   src=jnp.asarray(src), **consts)
        port = probes.gather_elems(torch.from_numpy(src), torch.from_numpy(lidx), "axis1")
        return port, ns["gA2"](jnp.int32(0))
    script = "prof_pallas2.py" if name == "kA" else "prof_pallas3.py"
    # the block of 1024 index rows (prof_pallas2.py:37) or 256 (prof_pallas3.py:36)
    ns = _load(script, "kA", "gA", BA=128 if name == "kA" else 256, **consts)
    port = probes.gather_elems(torch.from_numpy(tab3), torch.from_numpy(ridx2d), "axis0")
    return port, ns["gA"](jnp.int32(0))


@pytest.mark.parametrize("name", ["k1", "k2", "kA", "kA_256", "kA2"])
def test_gather_elems_matches_pallas(name):
    """prof_pallas_gather.py ``k1``/``g1`` (flat take) and ``k2``/``g2``
    (row take + lane select), prof_pallas2.py ``kA``/``gA`` and
    prof_pallas3.py ``kA``/``gA`` (take_along_axis 0) and ``kA2``/``gA2``
    (take_along_axis 1)."""
    port, got = _gather_case("kA3" if name == "kA_256" else name)
    _equal(port, got)


# --- C: row gathers ----------------------------------------------------------

@pytest.mark.parametrize("name", ["kB", "kC", "kE"])
def test_gather_rows_matches_pallas(name):
    """prof_pallas2.py ``kB``/``gB`` (row take), ``kC``/``gC`` (one-hot bf16
    matmul: rows rounded through bfloat16) and ``kE``/``gE`` (a scalar loop
    with the indices in SMEM), rows of 128 from (R, 128)."""
    rng = np.random.default_rng(0)
    R, N = 256, 128 * 512                                    # scripts: 2048, 1M
    tab3 = rng.standard_normal((R, 128)).astype(np.float32)
    rows1d = rng.integers(0, R - 8, N // 128).astype(np.int32)
    ns = _load("prof_pallas2.py", name, "g" + name[1], R=R, N=N, BB=128, BC=128,
               tab3=jnp.asarray(tab3), rows1d=jnp.asarray(rows1d))
    port = probes.gather_rows(torch.from_numpy(tab3), torch.from_numpy(rows1d),
                              round_bf16=name == "kC")
    got = ns["g" + name[1]](jnp.int32(0))
    if name == "kC":
        assert not np.array_equal(np.asarray(got), tab3[rows1d])   # it does round
    _equal(port, got)


def test_gather_rows_bf16_forms():
    """The bf16 forms timed at the ray path's shapes: a bf16 copy and the
    bf16 -> f32 upcast, against index_select."""
    rng = np.random.default_rng(1)
    tab = torch.from_numpy(rng.standard_normal((64, 160)).astype(np.float32)).bfloat16()
    rows = torch.from_numpy(rng.integers(0, 64, 300).astype(np.int32))
    assert torch.equal(probes.gather_rows(tab, rows), tab.index_select(0, rows))
    up = probes.gather_rows(tab, rows, out_dtype=torch.float32)
    assert up.dtype == torch.float32 and torch.equal(up, tab.index_select(0, rows).float())


# --- D: the per-row copy rings -----------------------------------------------

R_RING = 4096       # table rows at test size (the scripts: 2^18); R - Q is no power of 2


def _last_ring(block, K, Q):
    """The ring a Pallas probe block ends with, from the port's rows of that
    block in issue order: slot s holds the last copy i with i mod 2K = s."""
    copies = block.reshape(-1, Q, block.shape[-1])
    last = torch.arange(copies.shape[0] - 2 * K, copies.shape[0])
    ring = torch.empty_like(copies[:2 * K])
    ring[last % (2 * K)] = copies[last]
    return ring.reshape(2 * K * Q, -1)


def _ring_case(name, K, Q, dtype, W=16):
    """(port rows, Pallas ring) at the scripts' block split (16 blocks of
    8192 rows: indices pass the int32 overflow from block 7 on)."""
    rng = np.random.default_rng(0)
    ROWS, rpb = 1 << 17, 8192
    consts = dict(R=R_RING, W2=W, ROWS=ROWS)
    if name == "row_dma_kernel":
        T32 = rng.standard_normal((R_RING, W)).astype(np.float32)
        ns = _load("prof_r5_dma_probe.py", "row_dma_kernel", "make_row_dma",
                   T32=jnp.asarray(T32), Tb16=jnp.asarray(T32).astype(jnp.bfloat16), **consts)
        jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
        got = ns["make_row_dma"](ROWS, rpb, K, jdtype)(jnp.int32(1))
        table = _t(ns["T32"] if dtype == "f32" else ns["Tb16"])
        port = probes.row_ring(table, n_blocks=16, rows_per_blk=rpb, K=K, modulus=R_RING)
    elif name == "kern_a":
        T32 = rng.standard_normal((R_RING, W)).astype(np.float32)
        ns = _load("prof_r5_dma2.py", "kern_a", "make_a", T32=jnp.asarray(T32), **consts)
        got = ns["make_a"](K, Q)(jnp.int32(1))
        port = probes.row_ring(torch.from_numpy(T32), n_blocks=16, rows_per_blk=rpb, K=K,
                               Q=Q, modulus=R_RING - Q)
    elif name == "kern_b":
        T32 = rng.standard_normal((R_RING, W)).astype(np.float32)
        idx = rng.integers(0, R_RING, ROWS).astype(np.int32)
        ns = _load("prof_r5_dma2.py", "kern_b", "make_b", T32=jnp.asarray(T32),
                   IDX=jnp.asarray(idx), **consts)
        got = ns["make_b"](K)(jnp.int32(1))
        port = probes.row_ring(torch.from_numpy(T32), n_blocks=16, rows_per_blk=rpb, K=K,
                               idx=torch.from_numpy(idx))
    else:   # prof_r5_dma_bisect2.py make_case: (W, iterations, K, grid, dtype)
        W, it, g = Q
        ns = _load("prof_r5_dma_bisect2.py", "make_case", R=R_RING,
                   rng=np.random.default_rng(0))
        jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
        got = ns["make_case"](W, it, K, g, jdtype)(jnp.int32(1))
        # make_case draws its table first from the rng it is given
        table = _t(jnp.asarray(np.random.default_rng(0).standard_normal((R_RING, W)), jdtype))
        port = probes.row_ring(table, n_blocks=g, rows_per_blk=it, K=K, modulus=R_RING)
    return port, got


_RING_CASES = [
    # prof_r5_dma_probe.py:152-159: K in (8, 32), f32 and bf16
    ("row_dma_kernel", 8, 1, "f32"), ("row_dma_kernel", 32, 1, "bf16"),
    # prof_r5_dma2.py:96: (K, Q), modulus R - Q
    ("kern_a", 8, 1, "f32"), ("kern_a", 32, 1, "f32"), ("kern_a", 8, 8, "f32"),
    ("kern_a", 8, 32, "f32"),
    # prof_r5_dma2.py:168: indices staged per block
    ("kern_b", 8, 1, "f32"), ("kern_b", 32, 1, "f32"),
    # prof_r5_dma_bisect2.py:84-91: (W, iterations, grid) in place of Q
    ("make_case", 4, (128, 16, 8), "f32"), ("make_case", 4, (160, 16, 8), "f32"),
    ("make_case", 8, (128, 8192, 16), "f32"), ("make_case", 8, (160, 8192, 16), "f32"),
    ("make_case", 32, (128, 8192, 16), "f32"), ("make_case", 8, (160, 8192, 16), "bf16"),
]


@pytest.mark.parametrize("name,K,Q,dtype", _RING_CASES)
def test_row_ring_matches_pallas(name, K, Q, dtype):
    """The TPU grid runs in order and its one output block ends as the last
    block's ring; the port writes every block's copies, of which that ring
    is a selection."""
    port, got = _ring_case(name, K, Q, dtype)
    q = 1 if name == "make_case" else Q      # make_case takes (W, iterations, grid) there
    _equal(_last_ring(port[-1], K, q), got)


def test_ring_rows_wrap_like_int32():
    """The synthetic row walk in wrapping int32 with a floor modulo, as jnp
    computes ``((base + i) * 40503 + 12345) % m``, across the overflow at
    base + i = 53,021 and for a modulus that is no power of two."""
    rpb = 8192
    for m in (1 << 18, (1 << 18) - 32, 4095):
        rows = probes.ring_rows(16, rpb, modulus=m).reshape(-1)
        g = jnp.arange(16 * rpb, dtype=jnp.int32)
        want = np.asarray((g * 40503 + 12345) % m)
        assert int((np.arange(16 * rpb, dtype=np.int64) * 40503 + 12345 >= 2 ** 31).sum()) > 0
        assert (want < 0).sum() == 0 and np.array_equal(rows.numpy(), want)


_RING_PLANS = [   # (n_blocks, rows_per_blk, Q, K, staged indices, SMs)
    (16, 8192, 1, 8, False, 132),      # the scripts' split ...
    (256, 512, 1, 8, False, 132),      # ... and one that filled the card
    (16, 8192, 1, 32, True, 132),      # kern_b: staged indices
    (16, 8192, 32, 8, False, 132),     # Q = 32: 256 copies a block, gaps between
    (16, 8192, 8, 8, False, 7),        # Q = 8 on a few SMs: shared memory caps the rings
    (3, 1001, 1, 8, False, 132),       # copies not divisible by the rings
    (8, 16, 1, 4, False, 132),         # fewer copies than rings
    (1, 64, 1, 8, False, 132),         # n_blocks = 1
    (1, 8, 1, 4, True, 132),           # one ring of staged indices
    (7, 572, 1, 8, True, 3),           # staged, a ragged last chunk
    (5, 12, 1, 2, True, 132),          # staged, fewer copies than rings
    (16, 8192, 1, 8, False, 1),        # one SM
]


@pytest.mark.parametrize("case", _RING_PLANS)
def test_ring_plan_issues_every_copy_once(case):
    """Every copy (b, i) of the probe is issued by exactly one ring, walking
    from the ring's first (b, i) as the kernel does (i + 1, on to block b + 1
    where i reaches n_dma, so Q > 1 skips the block's unused walk); staged
    index chunks start at a multiple of 4; the block fits shared memory."""
    n_blocks, rpb, Q, K, staged, n_sms = case
    n_dma = rpb // Q
    row_bytes = 640
    plan = probes.ring_plan(n_blocks * n_dma, K, Q * row_bytes, staged_idx=staged,
                            n_sms=n_sms)
    issued = np.zeros((n_blocks, n_dma), np.int64)
    rings = plan.rings(n_dma)
    assert len(rings) == plan.n_rings
    for r, (b, i, count) in enumerate(rings):
        assert count >= 1 and (count == plan.chunk or r == plan.n_rings - 1)
        if staged:
            assert (b * rpb + i) % 4 == 0 and count % 4 == 0
        for _ in range(count):
            issued[b, i] += 1
            i += 1
            if i == n_dma:
                b, i = b + 1, 0
    assert (issued == 1).all()
    assert plan.smem_bytes <= probes.SMEM_LIMIT and plan.blocks <= n_sms
    assert 1 <= plan.rings_per_block <= probes.RING_ISSUERS_PER_SM
    assert plan.ring_bytes == probes.ring_bytes(K, Q * row_bytes, plan.chunk, staged)
    assert plan.ring_bytes % 128 == 0
    assert plan.ring_bytes >= (K + 1) * Q * row_bytes + 8 * (K + 2) + 4 * plan.chunk * staged


def test_ring_plan_fills_the_card_whatever_the_split():
    """The 16-block and the 256-block split of the same 131,072 rows give
    the kernel the same rings, 16 a block on 131 of 132 SMs; shared memory
    caps the rings a block where a ring's slots are large."""
    plans = {split: probes.ring_plan(split[0] * split[1], 8, 640, staged_idx=False, n_sms=132)
             for split in ((16, 8192), (256, 512))}
    assert len(set(plans.values())) == 1
    plan = plans[16, 8192]
    assert plan.rings_per_block == probes.RING_ISSUERS_PER_SM and plan.blocks >= 131
    big = probes.ring_plan(4096, 8, 32 * 640, staged_idx=False, n_sms=132)
    assert big.rings_per_block == 1 and big.smem_bytes <= probes.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        probes.ring_plan(4096, 64, 32 * 640, staged_idx=False, n_sms=132)
    with pytest.raises(ValueError, match="multiple of 4"):
        probes.ring_plan(4098, 8, 640, staged_idx=True, n_sms=132)


_RING_REFUSALS = [   # (keyword arguments of row_ring over a (64, 8) table, what it says)
    (dict(idx=torch.zeros(31, dtype=torch.int32)), "one index per row"),     # short idx
    (dict(idx=torch.zeros(33, dtype=torch.int32)), "one index per row"),     # long idx
    (dict(idx=torch.zeros(32, dtype=torch.int64)), "int32"),
    (dict(idx=torch.zeros((4, 8), dtype=torch.int32)), "one index per row"),
    (dict(), "either modulus"),
    (dict(modulus=64, idx=torch.zeros(32, dtype=torch.int32)), "either modulus"),
    (dict(modulus=0), "leave the table"),
    (dict(modulus=64, K=65, rows_per_blk=256), "1 to 64"),
]


@pytest.mark.parametrize("case", range(len(_RING_REFUSALS)))
def test_row_ring_refuses_what_the_kernel_cannot_take(case):
    """Indices of the wrong length, dtype or shape, a missing or doubled
    row source, a modulus off the table and K past the kernel's slots are
    refused before anything launches, on the CPU as on the card."""
    kw, msg = _RING_REFUSALS[case]
    kw = dict(dict(n_blocks=1, rows_per_blk=32, K=4), **kw)
    with pytest.raises((TypeError, ValueError), match=msg):
        probes.row_ring(torch.zeros((64, 8)), **kw)
    assert probes.launches == dict.fromkeys(probes.launches, 0)


# --- the wrappers ------------------------------------------------------------

def test_wrappers_refuse_what_they_cannot_do():
    tab = torch.zeros((16, 8))
    rows = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        probes.gather_rows(tab, rows.long())
    with pytest.raises(TypeError, match="float32"):
        probes.gather_elems(tab.double(), rows)
    with pytest.raises(ValueError, match="contiguous"):
        probes.gather_rows(tab.t(), rows)
    with pytest.raises(ValueError, match="unknown mode"):
        probes.gather_elems(tab, rows, "axis2")
    with pytest.raises(ValueError, match="2K"):
        probes.row_ring(tab, n_blocks=1, rows_per_blk=8, K=8, modulus=16)
    with pytest.raises(ValueError, match="leave the table"):
        probes.row_ring(tab, n_blocks=1, rows_per_blk=64, K=4, Q=4, modulus=16)
    with pytest.raises(ValueError, match="overwrite"):
        probes.staged_copy(tab, probes.CopySchedule(q=4, n_copies=4, in_flight=2), 1.0, 0.0)
    with pytest.raises(RuntimeError, match="meta"):
        probes.gather_rows(tab.to("meta"), rows.to("meta"))
    assert probes.launches == dict.fromkeys(probes.launches, 0)   # the CPU path counts nothing


def test_profiling_modules_exist_for_every_probe_script():
    from juliaraytracingsw_tpu_torch import profiling

    scripts = {"prof_pallas_probe", "prof_pallas_gather", "prof_pallas2", "prof_pallas3",
               "prof_r5_dma_probe", "prof_r5_dma2", "prof_r5_dma_bisect",
               "prof_r5_dma_bisect2"}
    assert set(profiling.MODULES) == scripts
    for name in scripts:
        assert (PROF / f"{name}.py").exists()
        mod = profiling.load(name)
        assert inspect.isfunction(mod.run)


# --- the probe entry point, rehearsed on the CPU -----------------------------

# module constants cut to a CPU size (the shapes' structure kept)
_SMALL = {
    "prof_pallas_probe": dict(NX=32, NY=32, STAGE_N=(256, 512)),
    "prof_pallas_gather": dict(NX=64, NY=64, N=4096),
    "prof_pallas2": dict(N=128 * 64, R=64),
    "prof_pallas3": dict(N=128 * 64),
    "prof_r5_dma_probe": dict(R=4096, N=8192, RING_SPLITS=((2, 2048), (8, 512))),
    "prof_r5_dma2": dict(R=4096, ROWS=4096, RING_SPLITS=((2, 2048), (8, 512))),
    "prof_r5_dma_bisect": {},
    "prof_r5_dma_bisect2": dict(R=4096),
}


@pytest.mark.parametrize("name", sorted(_SMALL))
def test_probe_module_runs_on_cpu_at_a_small_size(name, monkeypatch, capsys):
    """Each module's probes, wiring and checks at a small size on the CPU,
    where the wrappers run the plain versions; the timer is stubbed (a CPU
    time is no device metric) and every line is printed."""
    from juliaraytracingsw_tpu_torch import profiling
    from juliaraytracingsw_tpu_torch.profiling import _timing, prof_pallas2, prof_pallas_probe

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    calls = []

    def fake_time_ms(fn):
        fn()
        calls.append(fn)
        return 1.0

    monkeypatch.setattr(_timing, "time_ms", fake_time_ms)
    monkeypatch.setattr(_timing, "device_ms", fake_time_ms)
    monkeypatch.setattr(prof_pallas_probe, "time_ms", fake_time_ms)
    mod = profiling.load(name)
    for key, value in _SMALL[name].items():
        monkeypatch.setattr(mod, key, value)
    if name == "prof_pallas3":
        monkeypatch.setattr(prof_pallas2, "R", 64)
    results = mod.run("cpu", "CPU rehearsal")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if not ln.startswith("#")]
    assert results and len(lines) == len(results) and calls
    for res in results:
        assert res.ms == 1.0 and res.nbytes > 0 and res.bound_ms > 0
        assert res.kernel in (None, *probes.launches)
        if res.kernel is not None:
            assert res.max_abs_err == 0.0
    assert probes.launches == dict.fromkeys(probes.launches, 0)
