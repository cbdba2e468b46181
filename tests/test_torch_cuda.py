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
    # rows that need a gradient launch the kernel once; the backward is the
    # per-stage formulation, no launch
    before = ray_step.launches["bilinear"]
    leaf = rows_T.clone().requires_grad_()
    (g,) = torch.autograd.grad(ray_step.fused_substep(leaf, st, scal, **call)[2].sum(), leaf)
    assert ray_step.launches["bilinear"] == before + 1
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
    with pytest.raises(TypeError, match="float64"):
        ray_step.fused_substep(rows_T, st.double(), scal, **call)
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
@pytest.mark.parametrize("n", [1, 33, 4099])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interp", INTERPS)
def test_table_substep_backward_matches_twin_autograd(interp, table_dtype, n, cuda_device):
    """``TableSubstep`` on the card: the forward is one kernel launch, the
    backward (the per-stage formulation) launches none, and its cotangents
    agree with plain autograd through the twin. Both scatter the table's
    cotangent with atomics in no fixed order: the float32 table's to 1e-4
    of its largest value, the bfloat16 table's finite and on the same
    rows; the state's and the scalars' to rtol 1e-4, atol 1e-6 of their
    largest. The packets are moved 0.2 cells or more off any face: there the
    bilinear interpolant's derivative jumps, and the kernel's patch-local
    and the per-stage formulation's global coordinates may round a stage
    to either side."""
    T_pair, st, rp = _table_inputs(interp, table_dtype, cuda_device, n)
    for row, origin, step in ((0, rp.x0, rp.dx), (1, rp.y0, rp.dy)):
        fi = (st[row].double() - origin) / step
        st[row] = (origin + (torch.floor(fi) + 0.2 + 0.6 * (fi - torch.floor(fi))) * step).float()
    scal = torch.tensor([0.25, 2e-3], device=cuda_device)
    geo = dict(rp=rp, interp=interp, da=0.5, ny=NX, nx=NX)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (T_pair, st, scal)]
        out = fn(*leaves, **geo)
        loss = torch.sum(out[2] ** 2 + out[3] ** 2) + torch.sum(out[0] * out[1])
        return torch.autograd.grad(loss, leaves)

    before = ray_step.table_launches[interp]
    got = grads(ray_step.table_substep)
    torch.cuda.synchronize()
    assert ray_step.table_launches[interp] == before + 1
    ref = grads(ray_step.table_substep_torch)
    assert got[0].dtype == T_pair.dtype and bool(torch.isfinite(got[0]).all())
    rows = [(g != 0).any(dim=1) for g in (got[0], ref[0])]
    assert torch.equal(*rows) and bool(rows[0].any())
    if table_dtype == "float32":
        torch.testing.assert_close(got[0], ref[0], rtol=0,
                                   atol=1e-4 * float(ref[0].abs().max()))
    for a, b in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["substep", "attempt"])
def test_table_kernels_refuse_what_they_cannot_do(kind, cuda_device):
    """Bad dtype, width, row count, contiguity, device (the table on another
    device), a float64 state, gradients through the attempt (forward only),
    a table off a 16-byte boundary; CPU tensors run the
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
    with pytest.raises(TypeError, match="float64"):
        call(T_pair, s=st.double())
    if kind == "attempt":
        with pytest.raises(NotImplementedError, match="forward only"):
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


# (mode, table shape, idx shape, idx's offset in its buffer): element counts
# that are not a multiple of 4 leave a tail; rows of 1, 3 or 5 columns put
# one thread's four elements in several rows; an offset of one element
# leaves idx off the 16-byte boundary (the element-by-element form)
_ELEM_CASES = [
    ("flat", (300, 128), (1000, 128), 0),
    ("flat", (300, 128), (1,), 0),
    ("flat", (300, 128), (4099,), 0),
    ("flat", (512 * 512,), (1_000_003,), 0),
    ("flat", (300, 128), (4099,), 1),
    ("axis0", (300, 128), (300, 128), 0),
    ("axis0", (300, 3), (1001, 3), 0),
    ("axis0", (300, 1), (999, 1), 0),
    ("axis0", (2048, 128), (8191, 128), 0),
    ("axis0", (300, 5), (33, 5), 1),
    ("axis1", (300, 128), (300, 128), 0),
    ("axis1", (300, 7), (300, 3), 0),
    ("axis1", (301, 128), (301, 1), 0),
    ("axis1", (300, 128), (300, 5), 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,tab_shape,idx_shape,offset", _ELEM_CASES,
                         ids=[f"{m}-{'x'.join(map(str, t))}-{'x'.join(map(str, i))}-off{o}"
                              for m, t, i, o in _ELEM_CASES])
def test_gather_elems_matches_plain(mode, tab_shape, idx_shape, offset, cuda_device):
    """Bit-equal to the plain version, one launch a call."""
    probes = _probes()
    g = torch.Generator().manual_seed(1)
    table = torch.randn(tab_shape, generator=g)
    hi = {"flat": table.numel(), "axis0": tab_shape[0], "axis1": tab_shape[-1]}[mode]
    n = int(np.prod(idx_shape))
    buf = torch.randint(0, hi, (n + offset,), generator=g, dtype=torch.int32)
    table, buf = table.to(cuda_device), buf.to(cuda_device)
    idx = buf[offset:].view(idx_shape)
    assert (idx.data_ptr() % 16 == 0) == (offset == 0)
    before = probes.launches["gather_elems"]
    out = probes.gather_elems(table, idx, mode)
    torch.cuda.synchronize()
    assert probes.launches["gather_elems"] == before + 1
    assert torch.equal(out, probes.gather_elems_torch(table, idx, mode))


_ROW_FORMS = ["f32", "f32_round_bf16", "bf16", "bf16_to_f32"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 3001, 100_003])
@pytest.mark.parametrize("row_bytes", [16, 32, 48, 320, 640, 4112])
@pytest.mark.parametrize("form", _ROW_FORMS)
def test_gather_rows_matches_plain(form, row_bytes, n, cuda_device):
    """Rows of 1 to 257 16-byte chunks (a warp covers 32 rows down to an
    eighth of one; the widest outgrows a block), one or two rows in flight a
    thread by width, ragged against both; up to 3001 rows one warp a row
    (32 n threads fit one wave of an H100), 100,003 the chunk mapping.
    Bit-equal, one launch a call."""
    probes = _probes()
    g = torch.Generator().manual_seed(2)
    bf16 = form.startswith("bf16")
    table = torch.randn((500, row_bytes // (2 if bf16 else 4)), generator=g)
    if bf16:
        table = table.bfloat16()
    rows = torch.randint(0, 500, (n,), generator=g, dtype=torch.int32)
    table, rows = table.to(cuda_device), rows.to(cuda_device)
    kw = dict(round_bf16=form == "f32_round_bf16",
              out_dtype=torch.float32 if form == "bf16_to_f32" else None)
    before = probes.launches["gather_rows"]
    out = probes.gather_rows(table, rows, **kw)
    torch.cuda.synchronize()
    assert probes.launches["gather_rows"] == before + 1
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


@pytest.mark.cuda
def test_cli_gpu_matches_cpu(tmp_path, cuda_device):
    """The port's command line at 64^2 x 4,096 packets, patch gather, 20
    spinup steps and 5 frames of 20, on the card against the CPU:
    diagnostics within rtol 1e-5, the last packets within 1e-4. Read from
    the command line's files, or where h5py is not installed (the command
    line cannot write) from the driver its own setup builds, as
    ``chip_smoke.py`` phase 6d does."""
    import importlib.util

    from chip_smoke import cli_outputs, kernel_runs

    have_h5py = importlib.util.find_spec("h5py") is not None

    def argv(platform):
        return ["rsw", "--nx", "64", "--sqrt-npackets", "64", "--gather", "patch", "--seed", "42",
                "--ag", "0.5", "--aw", "0.05", "--spinup-T", "0.1", "--T", "0.6",
                "--output-dt", "0.1", "--out-dir", str(tmp_path / platform),
                "--platform", platform]

    # the table kernel's runs on the card, the frames' graph replays included
    with kernel_runs() as runs:
        gd, gp = cli_outputs(argv("cuda"), have_h5py)
    assert runs["table"] == 100
    cd, cp = cli_outputs(argv("cpu"), have_h5py)
    assert sorted(gd) == sorted(cd) == ["kinetic_energy", "potential_energy", "t"]
    for key in cd:
        assert len(cd[key]) == 5
        np.testing.assert_allclose(gd[key], cd[key], rtol=1e-5, err_msg=key)
    for key in cp:
        np.testing.assert_allclose(gp[key], cp[key], rtol=0, atol=1e-4, err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], ["--baroclinic"], ["--nlayers", "3"]],
                         ids=["barotropic", "baroclinic", "3-layers"])
def test_twolayer_frame_gpu_matches_cpu(extra, cuda_device):
    """One coupled two-layer (or 3-layer) frame at 64^2 x 4,096 packets
    through the command line's set-up, on the card (the table kernel, 5
    launches) against the CPU: ``sol`` within 1e-5 of its largest mode,
    packets within 1e-4, as ``chip_smoke.py`` phase 3 holds a frame."""
    from chip_smoke import coupled_argv, drive_cli

    before = ray_step.table_launches["bilinear"]
    sims = [drive_cli(coupled_argv("twolayer", 64, 64, 1, *extra, platform=p),
                      lambda line: None)[0].sim for p in ("cuda", "cpu")]
    assert ray_step.table_launches["bilinear"] - before == 5
    gpu, cpu = sims
    assert float((gpu.sol.cpu() - cpu.sol).abs().max() / cpu.sol.abs().max()) < 1e-5
    for name in ("x", "y", "k", "l"):
        torch.testing.assert_close(getattr(gpu.packets, name).cpu(), getattr(cpu.packets, name),
                                   rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("stepper", ["IFRK4", "AB3", "FilteredAB3", "RK4", "FilteredRK4",
                                     "ETDRK4", "FilteredETDRK4"])
def test_new_steppers_gpu_match_cpu(stepper, cuda_device):
    """10 steps of each stepper the IF-AB3 slice lacked, on the card
    against the CPU: RSW at 64^2 (a block L), Thomas-Yamada for the ETDRK4
    names (a diagonal L); ``sol`` within 1e-5 of its largest mode."""
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import (
        band_geo_wave_ic, ty_initial_condition)
    from juliaraytracingsw_tpu_torch.models import rsw, thomasyamada
    from juliaraytracingsw_tpu_torch.models.base import build_stepper, run

    out = []
    for device in (cuda_device, "cpu"):
        grid = make_grid(64, device=device)
        rng = np.random.default_rng(5)
        if "ETDRK4" in stepper:
            model = thomasyamada.make_model(grid)
            sol = ty_initial_condition(grid, rng, (2, 6), (0, 4), 0.1, 0.1, 0.05)
        else:
            model = rsw.make_model(grid, nu=1e-12, nnu=4, f=3.0, Cg=1.0)
            sol = band_geo_wave_ic(grid, rng, ag=0.5, aw=0.1, f=3.0, Cg=1.0)
        init, step = build_stepper(model, stepper, 1e-3)
        sol, clock, _ = run(step, sol, zero_clock(device=device), init(sol), 10)
        assert sol.device.type == torch.device(device).type and clock.step == 10
        out.append(sol.cpu())
    assert float((out[0] - out[1]).abs().max() / out[1].abs().max()) < 1e-5


def _bd_inputs(n, dtype, device, seed=0):
    from juliaraytracingsw_tpu_torch.rays import prng
    from juliaraytracingsw_tpu_torch.rays.resample import init_birth_death

    rng = np.random.default_rng(seed)
    cols = (rng.uniform(-np.pi, np.pi, n), rng.uniform(-np.pi, np.pi, n), rng.normal(size=n),
            rng.normal(size=n), np.where(rng.uniform(size=n) < 0.5, 1.0, -1.0))
    p = [torch.as_tensor(c, dtype=dtype, device=device) for c in cols]
    bd = init_birth_death(prng.prng_key(seed + 1, device=device), n, dtype=dtype)
    return p, list(bd)


def _ulps(a, b):
    """|a - b| in units of b's ulp."""
    a, b = a.cpu().double(), b.cpu()
    spacing = torch.as_tensor(np.spacing(np.abs(b.numpy())), dtype=torch.float64)
    return float(((a - b.double()).abs() / spacing).max()) if a.numel() else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 4099, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k_shape", [1.5, 2.0])
def test_birth_death_matches_twin(n, dtype, k_shape, cuda_device):
    """The birth/death kernel against its twin on the card, 3 chained steps
    (each fed the kernel's last output) with a dt that kills many packets:
    everything bit-equal but lifetimes, within 1 ulp (float64 log and pow
    rounded once); the twin on the card bit-equal to the twin on the CPU
    (float64 lifetimes within 6 ulps: the two devices' libm)."""
    from juliaraytracingsw_tpu_torch.ops import birth_death as bd

    p, st = _bd_inputs(n, dtype, cuda_device)
    consts = dict(Lx=L, Ly=L, k0=5.2, k_shape=k_shape, lam=10.0, x0=-L / 2, y0=-L / 2)
    bd.reset_launches()
    for step in range(3):
        state = [*p, *st]
        dt = torch.tensor(3.0 + step, dtype=dtype, device=cuda_device)
        out = bd.birth_death(*state, dt, **consts)
        ref = bd.birth_death_torch(*state, dt, **consts)
        cpu = bd.birth_death_torch(*(t.cpu() for t in state), dt.cpu(), **consts)
        torch.cuda.synchronize()
        for i, (a, b, c) in enumerate(zip(out, ref, cpu)):
            if i == 6:
                assert _ulps(a, b) <= 1.0, (step, _ulps(a, b))
                # float64 log and pow: the card's (log within 1 ulp, pow
                # within 2) against the CPU's libm, then the product with
                # lam: up to ~5.4 ulps apart (measured 3); float32 rounds
                # that away
                assert (_ulps(b, c) <= 6.0 if dtype == torch.float64
                        else torch.equal(b.cpu(), c)), (step, _ulps(b, c))
            else:
                assert torch.equal(a, b), (step, i)
                assert torch.equal(b.cpu(), c), (step, i)
        assert out[9].dtype == torch.bool and out[8].dtype == torch.int32
        assert out[7].dtype == torch.uint32
        p, st = list(out[:5]), list(out[5:9])
    assert bd.launches["birth_death"] == 3
    if n > 1000:
        assert int(st[3]) > n // 10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_birth_death_gradient_matches_twin(dtype, cuda_device):
    """The kernel's gradient (a live packet's cotangents through, its age's
    also to dt; a dead one's 0) against autograd through the twin on the
    card, with a dt that kills about a third of the packets."""
    from juliaraytracingsw_tpu_torch.ops import birth_death as bd

    n = 100_003
    p, st = _bd_inputs(n, dtype, cuda_device, seed=4)
    consts = dict(Lx=L, Ly=L, k0=5.2, k_shape=1.5, lam=10.0, x0=-L / 2, y0=-L / 2)
    rng = np.random.default_rng(5)
    w = [torch.as_tensor(rng.normal(size=n), dtype=dtype, device=cuda_device)
         for _ in range(7)]
    grads, deaths = [], []
    bd.reset_launches()
    for fn in (bd.birth_death, bd.birth_death_torch):
        ins = [t.clone().requires_grad_() for t in (*p, st[0], st[1])]
        dt = torch.tensor(4.0, dtype=dtype, device=cuda_device, requires_grad=True)
        out = fn(*ins, st[2], st[3], dt, **consts)
        loss = sum((o * wi).sum() for o, wi in zip(out[:7], w))
        grads.append(torch.autograd.grad(loss, [*ins, dt]))
        deaths.append(int(out[9].sum()))
    assert bd.launches["birth_death"] == 1
    assert deaths[0] == deaths[1] > n // 10
    for i, (a, b) in enumerate(zip(*grads)):
        if i < 7:
            assert torch.equal(a, b), i
        else:
            # dt's: one sum over the live packets in each
            torch.testing.assert_close(a, b, rtol=1e-12 if dtype == torch.float64 else 1e-5,
                                       atol=1e-9 if dtype == torch.float64 else 1e-3)


@pytest.mark.cuda
def test_birth_death_refuses_mixed_dtypes(cuda_device):
    from juliaraytracingsw_tpu_torch.ops import birth_death as bd

    p, st = _bd_inputs(64, torch.float32, cuda_device)
    consts = dict(Lx=L, Ly=L, k0=5.2, k_shape=1.5, lam=10.0, x0=-L / 2, y0=-L / 2)
    with pytest.raises(TypeError, match="one dtype"):
        bd.birth_death(*p, st[0].double(), *st[1:], 1.0, **consts)
    with pytest.raises(ValueError, match="uint32"):
        bd.birth_death(*p, st[0], st[1], st[2].to(torch.int64), st[3], 1.0, **consts)


@pytest.fixture
def nccl_mesh(cuda_device):
    """A mesh of one process over NCCL, its process group destroyed after
    the test."""
    import torch.distributed as dist

    from juliaraytracingsw_tpu_torch.parallel.mesh import make_mesh

    yield make_mesh(device="cuda")
    dist.destroy_process_group()


@pytest.mark.cuda
def test_nccl_mesh_of_one_slab_fft(nccl_mesh, cuda_device):
    """A mesh of one process over NCCL (``parallel/mesh.make_mesh``): the
    slab FFT's transposes go through NCCL's ``all_to_all_single`` and the
    transform agrees with ``torch.fft`` on the card; the gather of a
    complex block goes through its float view."""
    import torch.distributed as dist

    from juliaraytracingsw_tpu_torch.parallel.fft import padded_nkr, slab_irfft2, slab_rfft2
    from juliaraytracingsw_tpu_torch.parallel.mesh import all_gather

    mesh = nccl_mesh
    assert dist.get_backend() == "nccl" and mesh.size == 1 and mesh.device.type == "cuda"
    field = torch.randn(7, 128, 128, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(0))
    spec = slab_rfft2(field, mesh)
    assert spec.shape == (7, 128, padded_nkr(128, 1))
    ref = torch.fft.rfft2(field)
    assert float((spec - ref).abs().max() / ref.abs().max()) < 1e-5
    assert float((slab_irfft2(spec, 128, mesh) - field).abs().max()) < 1e-5
    assert torch.equal(all_gather(spec, -1, mesh), spec)
    assert mesh.counts["all_to_all"] == 2


@pytest.mark.cuda
def test_sharded_frame_is_bit_equal_across_runs(nccl_mesh, cuda_device):
    """The sharded coupled frame on a mesh of one (NCCL) is deterministic:
    two runs from the same state give bit-equal state and packets, each
    with one table-kernel launch per flow step."""
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import band_geo_wave_ic
    from juliaraytracingsw_tpu_torch.models import rsw
    from juliaraytracingsw_tpu_torch.parallel.mesh import shard_packets
    from juliaraytracingsw_tpu_torch.parallel.sharded_rsw import ShardedRSW
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets

    g = make_grid(128, device=cuda_device)
    model = rsw.make_model(g, nu=1e-12, nnu=4, f=3.0, Cg=1.0)
    sol0 = band_geo_wave_ic(g, np.random.default_rng(1), Kg=(10, 13), Kw=(0, 5), ag=0.5,
                            aw=0.05, f=3.0, Cg=1.0)
    mesh = nccl_mesh
    sh = ShardedRSW(g, model.params, mesh, dt=1e-3)
    rp = RayParams(f=3.0, Cg=1.0, x0=float(g.x[0]), y0=float(g.y[0]), dx=g.dx, dy=g.dy,
                   table_dtype="bfloat16")
    k0 = float(np.sqrt(3.0) * 3.0)
    packets = shard_packets(lattice_packets(64, g.Lx, g.Ly, k0=k0, k_ring=True,
                                            device=cuda_device), mesh)
    init, _ = sh.stepper()
    runs = []
    for _ in range(2):
        ray_step.reset_launches()
        frame = sh.make_coupled_frame(rp, 3, k_cutoff=300.0, k0=k0)
        sol = sh.shard_solution(sol0)
        runs.append(frame(sol, zero_clock(device=cuda_device), init(sol), packets))
        torch.cuda.synchronize()
        assert ray_step.table_launches["bilinear"] == 3
    (sa, _, _, pa), (sb, _, _, pb) = runs
    assert torch.equal(sa, sb) and all(torch.equal(a, b) for a, b in zip(pa, pb))
    assert float((pa.x - packets.x).abs().max()) > 1e-4
