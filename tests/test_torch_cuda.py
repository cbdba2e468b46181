"""The fused RK4 substep and DP5(4) attempt kernels on an NVIDIA GPU, in
their first cut and their table form, against their plain twins, and the
probe kernels against their plain versions.

These tests need a CUDA device and ``nvcc``, and skip without one. They
import neither JAX nor its package, so they also run where JAX is absent,
without the suite's ``conftest.py``:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu_torch.ops import ray_step  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.packets import Packets  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.patch import build_patch_table  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.raytrace import (  # noqa: E402
    RayParams, _gather_patch_rows, make_pair_table)

INTERPS = ["bilinear", "bspline", "bicubic"]
L = 2 * np.pi
NX = 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(interp, device, n, seed=0, nx=NX):
    """Smooth fields (a few low modes) on an nx^2 grid, packets over three
    periods so base cells wrap, one substep of h = 2e-3."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(nx) * L / nx, np.arange(nx) * L / nx, indexing="ij")
    nch = ray_step.n_channels(interp)
    amp, kx, ky, ph = rng.uniform(0.1, 0.5, (4, 2, nch, 1, 1))
    fo, fn = (torch.as_tensor((a * np.sin(np.rint(4 * i) * xx + np.rint(4 * j) * yy + 6 * p))
                              .astype(np.float32), device=device)
              for a, i, j, p in zip(amp, kx, ky, ph))
    T_pair = make_pair_table(build_patch_table(fo, interp), build_patch_table(fn, interp))
    rp = RayParams(f=3.0, Cg=1.0, x0=-L / 2, y0=-L / 2, dx=L / nx, dy=L / nx,
                   interp=interp)
    x, y = rng.uniform(-1.5 * L, 1.5 * L, (2, n))
    phase = rng.uniform(0, 2 * np.pi, n)
    sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    p = Packets(*(torch.as_tensor(a.astype(np.float32), device=device) for a in
                  (x, y, 5.2 * np.cos(phase), 5.2 * np.sin(phase), sign)))
    rows, bx, by = _gather_patch_rows(T_pair, p, rp, nx, nx)
    st = torch.stack([p.x, p.y, p.k, p.l, p.sign, bx, by])
    scal = torch.tensor([0.25, 2e-3], device=device)
    return rows.t().contiguous(), st, scal, rp


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4099])
@pytest.mark.parametrize("interp", INTERPS)
def test_kernel_matches_twin(interp, n, cuda_device):
    """A ragged N (not a multiple of the 256-thread block) and N = 1."""
    rows_T, st, scal, rp = _inputs(interp, cuda_device, n)
    before = ray_step.launches[interp]
    out = ray_step.fused_substep(rows_T, st, scal, rp=rp, interp=interp, da=0.5)
    torch.cuda.synchronize()
    assert ray_step.launches[interp] == before + 1
    twin = ray_step.substep_torch(rows_T, st, scal, cfg=ray_step.substep_cfg(rp, interp),
                                  interp=interp, da=0.5, x0=rp.x0, y0=rp.y0)
    # the same formulas in the same order, up to FMA contraction
    torch.testing.assert_close(out, twin, rtol=1e-5, atol=1e-6)
    assert float((out[:2] - st[:2]).abs().max()) > 1e-4      # packets moved


@pytest.mark.cuda
def test_kernel_refuses_what_it_cannot_do(cuda_device):
    rows_T, st, scal, rp = _inputs("bilinear", cuda_device, 64)
    call = dict(rp=rp, interp="bilinear", da=1.0)
    with pytest.raises(NotImplementedError, match="backward"):
        ray_step.fused_substep(rows_T.clone().requires_grad_(), st, scal, **call)
    with pytest.raises(ValueError, match="is on"):
        ray_step.fused_substep(rows_T, st.cpu(), scal, **call)
    before = dict(ray_step.launches)
    out = ray_step.fused_substep(rows_T.cpu(), st.cpu(), scal.cpu(), **call)
    assert out.device.type == "cpu" and ray_step.launches == before


def _attempt_scal(device):
    """[a0, dah, h, rtol, atol] at the adaptive hero's tolerances."""
    return torch.tensor([0.25, 0.5, 0.4, 1e-3, 1e-6], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4099])
@pytest.mark.parametrize("interp", INTERPS)
def test_attempt_kernel_matches_twin(interp, n, cuda_device):
    """One attempt of h = 0.4 on a 16^2 grid: the packets move about one
    cell and the error estimate lies far above its float32 round-off (batch
    norm 4e-3 to 0.3), so the error row is tested too."""
    rows_T, st, _, rp = _inputs(interp, cuda_device, n, nx=16)
    scal = _attempt_scal(cuda_device)
    before = ray_step.attempt_launches[interp]
    out = ray_step.fused_attempt(rows_T, st, scal, rp=rp, interp=interp)
    torch.cuda.synchronize()
    assert ray_step.attempt_launches[interp] == before + 1
    twin = ray_step.attempt_torch(rows_T, st, scal, cfg=ray_step.substep_cfg(rp, interp),
                                  interp=interp, x0=rp.x0, y0=rp.y0)
    # the same formulas in the same order, up to FMA contraction
    torch.testing.assert_close(out[:4], twin[:4], rtol=1e-5, atol=1e-6)
    # the error row esum cancels O(1-10) stage slopes down to the
    # truncation error: held to 2% of each packet's esum plus 2e-5 of the
    # largest, and the batch norm sqrt(sum / 4N) that the controller reads
    # to 5e-3 relative (the float32 twin against float64 on the CPU uses a
    # quarter of the first bound and reaches 5.1e-4 in the norm)
    esum_max = float(twin[4].max())
    assert esum_max > 0
    torch.testing.assert_close(out[4], twin[4], rtol=2e-2, atol=2e-5 * esum_max)
    norm_k, norm_t = (float(torch.sqrt(o[4].double().sum() / (4 * n))) for o in (out, twin))
    assert abs(norm_k - norm_t) <= 5e-3 * norm_t
    assert float((out[:2] - st[:2]).abs().max()) > 1e-1      # packets moved


@pytest.mark.cuda
def test_attempt_kernel_refuses_what_it_cannot_do(cuda_device):
    """Forward only; one device; CPU tensors run the twin and count nothing."""
    rows_T, st, _, rp = _inputs("bilinear", cuda_device, 64)
    scal = _attempt_scal(cuda_device)
    call = dict(rp=rp, interp="bilinear")
    with pytest.raises(NotImplementedError, match="backward"):
        ray_step.fused_attempt(rows_T, st.clone().requires_grad_(), scal, **call)
    with pytest.raises(ValueError, match="is on"):
        ray_step.fused_attempt(rows_T, st, scal.cpu(), **call)
    before = dict(ray_step.attempt_launches)
    out = ray_step.fused_attempt(rows_T.cpu(), st.cpu(), scal.cpu(), **call)
    assert out.device.type == "cpu" and ray_step.attempt_launches == before


# --- the table forms: the kernels read the pair table themselves -------------

def _table_inputs(interp, table_dtype, device, n, nx=NX, seed=0):
    """A pair table of smooth fields and st (5, N): packets over three
    periods, every seventh one on a cell face (x0 + k dx rounded to float32)
    or one ulp beside it, where the cell index is most easily got wrong."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(nx) * L / nx, np.arange(nx) * L / nx, indexing="ij")
    nch = ray_step.n_channels(interp)
    amp, kx, ky, ph = rng.uniform(0.1, 0.5, (4, 2, nch, 1, 1))
    fo, fn = (torch.as_tensor((a * np.sin(np.rint(4 * i) * xx + np.rint(4 * j) * yy + 6 * p))
                              .astype(np.float32), device=device)
              for a, i, j, p in zip(amp, kx, ky, ph))
    T_pair = make_pair_table(build_patch_table(fo, interp), build_patch_table(fn, interp),
                             table_dtype)
    rp = RayParams(f=3.0, Cg=1.0, x0=-L / 2, y0=-L / 2, dx=L / nx, dy=L / nx,
                   interp=interp, table_dtype=table_dtype)
    x, y = rng.uniform(-1.5 * L, 1.5 * L, (2, n)).astype(np.float32)
    faces = (rp.x0 + rng.integers(-3 * nx, 3 * nx, n) * rp.dx).astype(np.float32)
    faces = np.nextafter(faces, faces + rng.integers(-1, 2, n).astype(np.float32))
    on_face = np.arange(n) % 7 == 3
    x[on_face] = faces[on_face]
    y[np.arange(n) % 7 == 5] = faces[np.arange(n) % 7 == 5]
    phase = rng.uniform(0, 2 * np.pi, n)
    sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    st = torch.as_tensor(np.stack([x, y, 5.2 * np.cos(phase), 5.2 * np.sin(phase), sign])
                         .astype(np.float32), device=device)
    return T_pair, st, rp


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 4099])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interp", INTERPS)
def test_table_kernel_matches_twin(interp, table_dtype, n, cuda_device):
    """The table substep against its twin, and bit-equal to the first cut
    on the rows the ray path gathers (the bf16 upcast is exact, the stage
    code is the same). N = 33 and 4,099 leave a ragged last warp and block."""
    T_pair, st, rp = _table_inputs(interp, table_dtype, cuda_device, n)
    scal = torch.tensor([0.25, 2e-3], device=cuda_device)
    call = dict(rp=rp, interp=interp, da=0.5)
    before = ray_step.table_launches[interp]
    out = ray_step.table_substep(T_pair, st, scal, ny=NX, nx=NX, **call)
    torch.cuda.synchronize()
    assert ray_step.table_launches[interp] == before + 1
    twin = ray_step.table_substep_torch(T_pair, st, scal, ny=NX, nx=NX, **call)
    torch.testing.assert_close(out, twin, rtol=1e-5, atol=1e-6)
    first = ray_step.fused_substep(*ray_step.first_cut_inputs(T_pair, st, rp, NX, NX), scal,
                                   **call)
    assert torch.equal(out, first)
    assert float((out[:2] - st[:2]).abs().max()) > 1e-4      # packets moved


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 4099])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interp", INTERPS)
def test_table_attempt_kernel_matches_twin(interp, table_dtype, n, cuda_device):
    """The table attempt at h = 0.4 on a 16^2 grid, as the first cut's test:
    rows 0-3 and the error row against the twin, everything bit-equal to
    the first cut on the same rows."""
    T_pair, st, rp = _table_inputs(interp, table_dtype, cuda_device, n, nx=16)
    scal = _attempt_scal(cuda_device)
    call = dict(rp=rp, interp=interp)
    before = ray_step.table_attempt_launches[interp]
    out = ray_step.table_attempt(T_pair, st, scal, ny=16, nx=16, **call)
    torch.cuda.synchronize()
    assert ray_step.table_attempt_launches[interp] == before + 1
    twin = ray_step.table_attempt_torch(T_pair, st, scal, ny=16, nx=16, **call)
    # at h = 0.4 a stage slope dk/dt reaches ~10, so FMA contraction moves a
    # wavenumber near zero by a few ulps of h dk/dt (1.7e-6 seen on one
    # bicubic packet of 4,099, the first cut alike): atol 5e-6
    torch.testing.assert_close(out[:4], twin[:4], rtol=1e-5, atol=5e-6)
    esum_max = float(twin[4].max())
    assert esum_max > 0
    torch.testing.assert_close(out[4], twin[4], rtol=2e-2, atol=2e-5 * esum_max)
    first = ray_step.fused_attempt(*ray_step.first_cut_inputs(T_pair, st, rp, 16, 16), scal,
                                   **call)
    assert torch.equal(out, first)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["substep", "attempt"])
def test_table_kernels_refuse_what_they_cannot_do(kind, cuda_device):
    """Bad dtype, width, row count, contiguity, device (the table on another
    device), gradients, a table off a 16-byte boundary; CPU tensors run the
    twin and count nothing."""
    T_pair, st, rp = _table_inputs("bilinear", "bfloat16", cuda_device, 64)
    if kind == "substep":
        scal = torch.tensor([0.0, 1e-3], device=cuda_device)

        def call(T, s=st, sc=scal):
            return ray_step.table_substep(T, s, sc, rp=rp, interp="bilinear", da=1.0, ny=NX,
                                          nx=NX)
        counts = ray_step.table_launches
    else:
        scal = _attempt_scal(cuda_device)

        def call(T, s=st, sc=scal):
            return ray_step.table_attempt(T, s, sc, rp=rp, interp="bilinear", ny=NX, nx=NX)
        counts = ray_step.table_attempt_launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        call(T_pair.half())
    with pytest.raises(ValueError, match="shape"):
        call(T_pair[:, :-8].contiguous())
    with pytest.raises(ValueError, match="shape"):
        call(T_pair[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        call(T_pair.t().contiguous().t())
    with pytest.raises(ValueError, match="is on"):
        call(T_pair.cpu())
    with pytest.raises(ValueError, match="is on"):
        call(T_pair, sc=scal.cpu())
    with pytest.raises(NotImplementedError, match="backward"):
        call(T_pair, s=st.clone().requires_grad_())
    shifted = torch.empty(T_pair.numel() + 1, dtype=T_pair.dtype, device=cuda_device)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        call(shifted.view(T_pair.shape))
    before = dict(counts)
    out = call(T_pair.cpu(), s=st.cpu(), sc=scal.cpu())
    assert out.device.type == "cpu" and counts == before


# --- the copy and gather probe kernels (ops/probes.py) ------------------------

def _probes():
    from juliaraytracingsw_tpu_torch.ops import probes
    return probes


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["trivial", "k0", "k1", "k2", "k3", "k4", "k5"])
def test_copy_probe_matches_plain(name, cuda_device):
    """Each Pallas feature probe's schedule at its own shape, bit-equal."""
    probes = _probes()
    sched, a, b, shape = probes.COPY_PROBES[name]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(0)).to(cuda_device)
    before = probes.launches["probe_copy"]
    out = probes.staged_copy(x, sched, a, b)
    torch.cuda.synchronize()
    assert probes.launches["probe_copy"] == before + 1
    assert torch.equal(out, probes.staged_copy_torch(x, sched, a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["flat", "axis0", "axis1"])
def test_gather_elems_matches_plain(mode, cuda_device):
    probes = _probes()
    g = torch.Generator().manual_seed(1)
    table = torch.randn((300, 128), generator=g)
    hi = {"flat": table.numel(), "axis0": 300, "axis1": 128}[mode]
    idx = torch.randint(0, hi, (1000 if mode == "flat" else 300, 128), generator=g,
                        dtype=torch.int32)
    table, idx = table.to(cuda_device), idx.to(cuda_device)
    before = probes.launches["gather_elems"]
    out = probes.gather_elems(table, idx, mode)
    torch.cuda.synchronize()
    assert probes.launches["gather_elems"] == before + 1
    assert torch.equal(out, probes.gather_elems_torch(table, idx, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["f32", "f32_round_bf16", "bf16", "bf16_to_f32", "narrow"])
def test_gather_rows_matches_plain(form, cuda_device):
    """Rows of 160 (40 16-byte chunks: lanes loop) and of 4 floats."""
    probes = _probes()
    g = torch.Generator().manual_seed(2)
    W = 4 if form == "narrow" else 160
    table = torch.randn((500, W), generator=g)
    if form.startswith("bf16"):
        table = table.bfloat16()
    rows = torch.randint(0, 500, (3001,), generator=g, dtype=torch.int32)
    table, rows = table.to(cuda_device), rows.to(cuda_device)
    kw = dict(round_bf16=form == "f32_round_bf16",
              out_dtype=torch.float32 if form == "bf16_to_f32" else None)
    out = probes.gather_rows(table, rows, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, probes.gather_rows_torch(table, rows, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("K,Q,dtype,indices", [
    (8, 1, torch.float32, False), (4, 1, torch.bfloat16, False), (8, 8, torch.float32, False),
    (8, 32, torch.float32, False), (8, 1, torch.float32, True)])
def test_row_ring_matches_plain(K, Q, dtype, indices, cuda_device):
    """8 blocks of 8192 rows: block 7's rows pass the int32 overflow of
    the synthetic walk; modulus R - Q is no power of two."""
    probes = _probes()
    g = torch.Generator().manual_seed(3)
    R, rpb, nb = 4096, 8192, 8
    table = torch.randn((R, 160), generator=g).to(dtype).to(cuda_device)
    kw = dict(n_blocks=nb, rows_per_blk=rpb, K=K, Q=Q)
    if indices:
        kw["idx"] = torch.randint(0, R, (nb * rpb,), generator=g,
                                  dtype=torch.int32).to(cuda_device)
    else:
        kw["modulus"] = R - Q
    before = probes.launches["row_ring"]
    out = probes.row_ring(table, **kw)
    torch.cuda.synchronize()
    assert probes.launches["row_ring"] == before + 1
    assert out.shape == (nb, rpb, 160)
    assert torch.equal(out, probes.row_ring_torch(table, **kw))


# the ring kernel at ragged shapes: (n_blocks, rows_per_blk, K, Q, dtype, staged
# indices)
_RAGGED_RINGS = [
    (3, 1001, 8, 1, torch.float32, False),      # copies not divisible by the rings
    (8, 16, 4, 1, torch.float32, False),        # fewer copies than rings
    (1, 64, 8, 1, torch.float32, False),        # n_blocks = 1
    (4, 8192, 8, 32, torch.float32, False),     # Q = 32: gaps between blocks
    (8, 8192, 8, 1, torch.bfloat16, False),     # bf16, past the int32 wrap
    (8, 1024, 8, 8, torch.bfloat16, False),     # bf16, Q = 8
    (8, 8192, 32, 1, torch.float32, False),     # K = 32
    (7, 572, 8, 1, torch.float32, True),        # staged indices, a ragged last chunk
    (5, 12, 2, 1, torch.float32, True),         # staged, fewer copies than rings
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(_RAGGED_RINGS)))
def test_row_ring_ragged_matches_plain(case, cuda_device):
    """Ragged splits of the copies into rings, bit-equal to the plain
    version."""
    probes = _probes()
    nb, rpb, K, Q, dtype, indices = _RAGGED_RINGS[case]
    g = torch.Generator().manual_seed(4 + case)
    R = 4096
    table = torch.randn((R, 160), generator=g).to(dtype).to(cuda_device)
    kw = dict(n_blocks=nb, rows_per_blk=rpb, K=K, Q=Q)
    if indices:
        kw["idx"] = torch.randint(0, R, (nb * rpb,), generator=g,
                                  dtype=torch.int32).to(cuda_device)
    else:
        kw["modulus"] = R - Q
    before = probes.launches["row_ring"]
    out = probes.row_ring(table, **kw)
    torch.cuda.synchronize()
    assert probes.launches["row_ring"] == before + 1
    assert torch.equal(out, probes.row_ring_torch(table, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(6))
def test_copy_extra_schedules_match_plain(case, cuda_device):
    """Schedules beyond the Pallas ones: 48-byte copies (q = 3, W = 4), 37
    copies from an odd src_mod into 5 slots, 5 in flight, 3 in flight on 5
    slots (one starting thread), one 256 KB copy on 128 blocks, and the
    plain mode with rows of 6 floats (no 16-byte accesses) and of 260."""
    from torch_probe_cases import EXTRA_COPY_SCHEDULES

    probes = _probes()
    sched, shape = EXTRA_COPY_SCHEDULES[case]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(case)).to(cuda_device)
    before = probes.launches["probe_copy"]
    out = probes.staged_copy(x, sched, 2.0, 0.5)
    torch.cuda.synchronize()
    assert probes.launches["probe_copy"] == before + 1
    assert torch.equal(out, probes.staged_copy_torch(x, sched, 2.0, 0.5))


@pytest.mark.cuda
def test_probe_wrappers_refuse_what_they_cannot_do(cuda_device):
    probes = _probes()
    table = torch.zeros((64, 128), device=cuda_device)
    rows = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError, match="int32"):
        probes.gather_rows(table, rows.long())
    with pytest.raises(ValueError, match="is on"):
        probes.gather_rows(table, rows.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        probes.gather_elems(table.t(), torch.zeros((8, 64), dtype=torch.int32,
                                                   device=cuda_device), "axis0")
    with pytest.raises(ValueError, match="16-byte"):
        probes.gather_rows(torch.zeros((64, 3), device=cuda_device), rows)
    with pytest.raises(ValueError, match="shared memory"):
        probes.staged_copy(torch.zeros((1024, 128), device=cuda_device),
                           probes.CopySchedule(q=1, n_copies=1024, n_slots=1024), 1.0, 0.0)
    with pytest.raises(ValueError, match="16-byte"):
        # copy 1 starts at row 2 of rows of one float: 8 bytes in
        probes.staged_copy(torch.zeros((64, 1), device=cuda_device),
                           probes.CopySchedule(q=8, n_copies=3, src_mod=6), 1.0, 0.0)
    before = dict(probes.launches)
    out = probes.gather_rows(table.cpu(), rows.cpu())
    assert out.device.type == "cpu" and probes.launches == before
