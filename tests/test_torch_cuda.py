"""The port on an NVIDIA GPU: the hand-written kernels against their
plain twins, and every path that runs them against the same path on the
CPU, with the kernels' runs counted.

- the fused RK4 substep and DP5(4) attempt kernels, in their first cut and
  their table form, at ragged sizes and at the hero's (1,048,576 packets
  over a 512^2 table), the attempt's error row where the truncation error
  dominates, the substep's backward; the adaptive loop's start, decision
  and apply kernels against the CPU's controller; the kernel library's
  entry points;
- the probe kernels against their plain versions;
- the birth/death kernel against its twin;
- the coupled paths through the command line's set-up, GPU against CPU:
  RK4, adaptive and midpoint frames, a frame's gradient and remat, the
  two-layer, 3-layer, RSW-variant and single-wave frames, every stepper,
  birth/death frames and their checkpoint, steady raytracing, NUFFT rays,
  1-D rays and forced RSW; the table kernels the driver runs, and no
  other; a checkpoint of the card restored on the CPU;
- ``parallel/`` on a mesh of one process over NCCL.

These tests need a CUDA device and ``nvcc``, and skip without one. They
import neither JAX nor its package, so they also run where JAX is absent,
without the suite's ``conftest.py``:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py \
        tests/test_torch_graph_frames.py tests/test_torch_pair_table.py
"""
import importlib.util
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_card import (DT, HERO_IC, cli_driver, cli_outputs, coupled_argv,  # noqa: E402
                        cuda_device, drive_cli, hero_fields, kernel_runs,  # noqa: F401
                        packet_gap, quiet, random_state, rel_gap, setup_case)

from juliaraytracingsw_tpu_torch.ops import ray_step  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.packets import Packets  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.patch import build_patch_table  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.raytrace import (  # noqa: E402
    RayParams, _gather_patch_rows, make_pair_table)

INTERPS = ["bilinear", "bspline", "bicubic"]
L = 2 * np.pi
NX = 64


@pytest.mark.cuda
def test_kernel_library_builds_and_exports_every_entry_point(cuda_device):
    """``ops/_build`` compiles every ``csrc/*.cu`` into one library, which
    exports exactly the C entry points the wrappers bind with ``ctypes``,
    and each resolves."""
    import re
    from pathlib import Path

    from juliaraytracingsw_tpu_torch.ops import _build

    lib = _build.load_library()
    assert _build.build_info.path.exists()
    ops = Path(_build.__file__).parent
    bound = {name for f in ops.glob("*.py") for name in re.findall(r"\bjrsw_\w+", f.read_text())}
    exported = {name for f in _build.CSRC.glob("*.cu")
                for name in re.findall(r'extern "C" \w+ (jrsw_\w+)\(', f.read_text())}
    assert bound == exported and {"jrsw_ray_step_table", "jrsw_ray_attempt_table",
                                  "jrsw_pair_table", "jrsw_birth_death"} <= bound
    for name in sorted(bound):
        assert callable(getattr(lib, name)), name


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


# (init_substeps, max_steps, the error norm each slot's esum column gives)
SLOT_CASES = {"accept": (4, 16, (0.5, 0.3, 0.7)), "reject": (4, 16, (2.0, 1.5, 0.9)),
              "last": (1, 16, (0.01, 0.01)), "max_steps": (4, 2, (0.5, 0.5))}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4099, 400_003])
@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_adaptive_slot_kernels_match_the_controller(case, n, cuda_device):
    """The device loop's start, decision and apply kernels
    (``ops/adaptive_loop``) slot by slot against the controller of
    ``raytrace_adaptive``'s ``body`` on the CPU (``_adapt``), fed the card's
    state before each slot and an error column that gives a chosen norm:
    accept and reject as the CPU decides them, the counters and the loop
    test exact, t, h and the next attempt's scal within float32 rounding
    (the error column is summed in another order), the packets replaced by
    p5 on an accepted slot and untouched otherwise. "last" accepts the
    whole interval, after which a slot changes nothing; "max_steps" stops
    the loop short of t1. 400,003 packets: more than the decision's 1,024
    blocks of 256 threads cover in one pass."""
    from juliaraytracingsw_tpu_torch.ops.adaptive_loop import CTL_F, CTL_I, DeviceLoop
    from juliaraytracingsw_tpu_torch.rays.raytrace import _adapt

    init_substeps, max_steps, errs = SLOT_CASES[case]
    T_pair, st, rp = _table_inputs("bilinear", "float32", cuda_device, n, nx=16)
    t0, t1 = (torch.tensor(v, device=cuda_device) for v in (0.25, 0.75))
    loop = DeviceLoop(T_pair, Packets(*st.unbind(0)), t0, t1, rp=rp, ny=16, nx=16,
                      rtol=1e-3, atol=1e-6, max_steps=max_steps, init_substeps=init_substeps,
                      exponent=0.2)
    loop.start()
    f, i = loop.ctl_f.cpu(), loop.ctl_i.cpu()
    span, eps = t1.cpu() - t0.cpu(), 1e-9 * torch.abs(t1.cpu() - t0.cpu())
    assert (f[CTL_F["t"]], f[CTL_F["h"]], f[CTL_F["eps"]]) == (t0.cpu(), span / init_substeps,
                                                               eps)
    assert i[:4].tolist() == [0, 0, 0, 1] and loop.go()
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    for slot, err_target in enumerate(errs):
        f, i, before = loop.ctl_f.cpu(), loop.ctl_i.cpu(), loop.st.clone()
        u = torch.rand(n, generator=gen, device=cuda_device) + 0.5
        esum = u * (4 * n * err_target ** 2 / float(u.double().sum()))
        p5 = loop.st[:4] + torch.rand(4, n, generator=gen, device=cuda_device)
        loop.out5.copy_(torch.cat([p5, esum[None]]))
        loop.decide()
        loop.apply()
        t, h, t1c, eps = (f[CTL_F[k]] for k in ("t", "h", "t1", "eps"))
        done = t >= t1c - eps
        h_eff = torch.minimum(h, t1c - t)
        err = torch.sqrt(esum.cpu().sum() / (4.0 * n))
        accept, reject, t_next, h_next = _adapt(err, t, h, h_eff, done, eps, 0.2)
        f2, i2 = loop.ctl_f.cpu(), loop.ctl_i.cpu()
        assert bool(i2[CTL_I["accepted"]]) == bool(accept)
        assert int(i2[CTL_I["n_accepted"]]) == int(i[CTL_I["n_accepted"]]) + int(accept)
        assert int(i2[CTL_I["n_rejected"]]) == int(i[CTL_I["n_rejected"]]) + int(reject)
        assert int(i2[CTL_I["slots"]]) == slot + 1
        torch.testing.assert_close(f2[CTL_F["t"]], t_next, rtol=1e-6, atol=0)
        torch.testing.assert_close(f2[CTL_F["h"]], h_next, rtol=1e-5, atol=0)
        t2, h2 = f2[CTL_F["t"]], f2[CTL_F["h"]]
        assert bool(i2[CTL_I["go"]]) == (bool(t2 < t1c - eps) and slot + 1 < max_steps)
        h_att = torch.where(t2 >= t1c - eps, h2, torch.minimum(h2, t1c - t2))
        assert loop.scal.cpu().tolist() == torch.stack(
            [(t2 - t0.cpu()) / span, h_att / span, h_att, torch.tensor(1e-3),
             torch.tensor(1e-6)]).tolist()
        assert torch.equal(loop.st, torch.cat([p5, before[4:]]) if accept else before)
    acc, rej = int(loop.ctl_i[CTL_I["n_accepted"]]), int(loop.ctl_i[CTL_I["n_rejected"]])
    assert (acc, rej) == {"accept": (3, 0), "reject": (1, 2), "last": (1, 0),
                          "max_steps": (2, 0)}[case]
    assert not loop.go() if case in ("last", "max_steps") else loop.go()
    if case == "last":
        assert float(loop.ctl_f[CTL_F["t"]]) == 0.75


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


# --- at the hero's size ----------------------------------------------------------

def _hero_inputs(n, nx, interp, table_dtype, device):
    """The pair table of two hero flows at nx^2 (``torch_card.hero_fields``)
    and n packets at random positions on the hero's wavenumber ring."""
    from juliaraytracingsw_tpu_torch.rays.raytrace import build_pair

    grid, rp, fo, fn = hero_fields(nx, interp, device)
    rp = rp._replace(table_dtype=table_dtype)
    st = random_state(n, grid, float(np.sqrt(3.0) * rp.f / rp.Cg), device)
    return build_pair(fo, fn, rp), st, rp


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["substep", "attempt"])
def test_table_kernels_at_the_hero_size(kind, cuda_device):
    """1,048,576 packets at random positions over the bf16 bilinear pair
    table of two 512^2 hero flows, one step of the hero's dt (the attempt
    at the adaptive hero's tolerances): one launch, the kernel against its
    twin, and bit-equal to the first cut on the rows the ray path gathers."""
    n, nx = 1 << 20, 512
    T_pair, st, rp = _hero_inputs(n, nx, "bilinear", "bfloat16", cuda_device)
    geo = dict(rp=rp, interp="bilinear")
    if kind == "substep":
        geo["da"] = 1.0
        scal = torch.tensor([0.0, DT], device=cuda_device)
        kernel, twin, first_cut = (ray_step.table_substep, ray_step.table_substep_torch,
                                   ray_step.fused_substep)
        counts = ray_step.table_launches
    else:
        scal = torch.tensor([0.0, 1.0, DT, 1e-3, 1e-6], device=cuda_device)
        kernel, twin, first_cut = (ray_step.table_attempt, ray_step.table_attempt_torch,
                                   ray_step.fused_attempt)
        counts = ray_step.table_attempt_launches
    before = counts["bilinear"]
    out = kernel(T_pair, st, scal, ny=nx, nx=nx, **geo)
    torch.cuda.synchronize()
    assert counts["bilinear"] == before + 1
    torch.testing.assert_close(out, twin(T_pair, st, scal, ny=nx, nx=nx, **geo),
                               rtol=1e-5, atol=1e-6)
    rows_T, st7 = ray_step.first_cut_inputs(T_pair, st, rp, nx, nx)
    assert torch.equal(out, first_cut(rows_T, st7, scal, **geo))
    assert float((out[:2] - st[:2]).abs().max()) > 1e-4      # packets moved


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["first cut", "float32", "bfloat16"])
@pytest.mark.parametrize("interp", INTERPS)
def test_attempt_error_row_where_truncation_dominates(interp, form, cuda_device):
    """The attempt's error row esum = |h (b - b4) . k / scale|^2 cancels
    O(1-10) stage slopes down to the truncation error, which at the hero's
    dt lies below float32's resolution. So it is held at h = 20 dt, rtol =
    atol = 1e-6 (batch norm ~0.2, the scale the controller decides on), on
    1,048,576 packets over two 512^2 hero flows, for the first cut (float32
    rows) and the table form on either table: rows 0-3 as the kernel tests
    hold them, esum to 1% of its largest value, the batch norm sqrt(sum(esum)
    / 4N) to 1e-3 relative (the float32 twin against float64 on the CPU at N
    = 16,384: 1.9e-3 of the largest esum, 5.1e-5 in the norm). The packets
    move about two cells, into the patch's clamped extension, which kernel
    and twin compute alike."""
    n, nx = 1 << 20, 512
    T_pair, st, rp = _hero_inputs(n, nx, interp, "float32" if form == "first cut" else form,
                                  cuda_device)
    scal = torch.tensor([0.0, 1.0, 20 * DT, 1e-6, 1e-6], device=cuda_device)
    if form == "first cut":
        rows_T, st7 = ray_step.first_cut_inputs(T_pair, st, rp, nx, nx)
        out = ray_step.fused_attempt(rows_T, st7, scal, rp=rp, interp=interp)
        twin = ray_step.attempt_torch(rows_T, st7, scal, cfg=ray_step.substep_cfg(rp, interp),
                                      interp=interp, x0=rp.x0, y0=rp.y0)
    else:
        geo = dict(rp=rp, interp=interp, ny=nx, nx=nx)
        out = ray_step.table_attempt(T_pair, st, scal, **geo)
        twin = ray_step.table_attempt_torch(T_pair, st, scal, **geo)
    torch.testing.assert_close(out[:4], twin[:4], rtol=1e-5, atol=1e-6)
    esum_max = float(twin[4].max())
    assert esum_max > 0
    assert float((out[4] - twin[4]).abs().max()) <= 1e-2 * esum_max
    norm_k, norm_t = (float(torch.sqrt(o[4].double().sum() / (4 * n))) for o in (out, twin))
    assert abs(norm_k - norm_t) <= 1e-3 * norm_t


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
    line cannot write) from the driver its own setup builds. The card's
    frames run the table kernel once a step and no first cut."""
    have_h5py = importlib.util.find_spec("h5py") is not None

    def argv(platform):
        return ["rsw", "--nx", "64", "--sqrt-npackets", "64", "--gather", "patch", "--seed", "42",
                "--ag", "0.5", "--aw", "0.05", "--spinup-T", "0.1", "--T", "0.6",
                "--output-dt", "0.1", "--out-dir", str(tmp_path / platform),
                "--platform", platform]

    # the table kernel's runs on the card, the frames' graph replays included
    with kernel_runs() as runs:
        gd, gp = cli_outputs(argv("cuda"), have_h5py)
    assert runs["table"] == 100 and runs["first cut"] == 0
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
    packets within 1e-4."""
    before = ray_step.table_launches["bilinear"]
    sims = [drive_cli(coupled_argv("twolayer", 64, 64, 1, *extra, platform=p)).sim
            for p in ("cuda", "cpu")]
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


# the adaptive hero's ray options: the reference's production tolerances,
# one attempt an interval to start
ADAPTIVE = ("--ray-method", "adaptive", "--ray-rtol", "1e-3", "--ray-atol", "1e-6",
            "--ray-max-steps", "16")


def _driver(argv):
    """(driver, case) of a command line; an adaptive one at the adaptive
    hero's loop ('while', one attempt an interval to start)."""
    drv, _, case = cli_driver(argv)
    if drv.ray_method == "adaptive":
        drv.ray_opts.update(init_substeps=1, loop="while")
    return drv, case


def _cutoffs(args, case):
    """The command line's k-cutoff and reset wavenumber of a case."""
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli

    return dict(k_cutoff=100.0 * case.f / case.Cg, k0=cli._k0(args, case.f, case.Cg))


def _first_cut_launches():
    return sum(ray_step.launches.values()) + sum(ray_step.attempt_launches.values())


@pytest.mark.cuda
def test_adaptive_frame_gpu_matches_cpu(cuda_device):
    """One adaptive DP5(4) frame of 5 steps at the adaptive hero's options,
    128^2 x 16,384 packets, float32 tables, through the command line's
    driver, on the card against the CPU: the same accepted and rejected
    attempts each step, one table-attempt launch an attempt and no other
    ray kernel, ``sol`` within 1e-5 of its largest mode, packets within
    1e-4."""
    ends, decisions = [], []
    for platform in (cuda_device, "cpu"):
        drv, case = _driver(coupled_argv("rsw", 128, 128, 1, *HERO_IC, *ADAPTIVE,
                                         "--table-dtype", "float32", platform=platform))
        before = (dict(ray_step.table_attempt_launches), dict(ray_step.table_launches),
                  _first_cut_launches())
        drv.run(1, 5)
        ends.append(drv.sim)
        decisions.append([(int(i["n_accepted"]), int(i["n_rejected"])) for i in drv.ray_infos])
        if platform == cuda_device:
            attempts = sum(a + r for a, r in decisions[0])
            assert attempts >= 5
            assert ray_step.table_attempt_launches == {
                **before[0], "bilinear": before[0]["bilinear"] + attempts}
            assert ray_step.table_launches == before[1]
            assert _first_cut_launches() == before[2]
    assert decisions[0] == decisions[1]
    gpu, cpu = ends
    assert rel_gap(gpu.sol, cpu.sol) < 1e-5
    assert packet_gap(gpu.packets, cpu.packets) < 1e-4
    assert float((cpu.packets.x - case.packets.x).abs().max()) > 1e-4      # packets moved


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["rk4", "adaptive"])
@pytest.mark.parametrize("interp", INTERPS)
def test_driver_runs_only_the_table_kernels(interp, method, cuda_device):
    """The driver's two main paths, 3 frames of 5 steps at 64^2 x 4,096
    packets over bf16 tables, run the table kernels and nothing else of
    ours, as a profiler trace counts them (a graphed RK4 frame's replays
    included): a step builds one pair table and runs one table substep
    (RK4) or one table attempt an attempt (adaptive); no first cut, no
    other interp's kernel launched. The state stays finite, |k| under the
    k-cutoff, the energy within 1%."""
    from juliaraytracingsw_tpu_torch.models import rsw

    extra = ADAPTIVE if method == "adaptive" else ()
    drv, case = _driver(coupled_argv("rsw", 64, 64, 1, *HERO_IC, *extra, "--interp", interp))
    grid, params = case.model.grid, case.model.params
    e0 = float(rsw.total_energy(case.sol0, grid, params))
    others = {k: v for k, v in ray_step.table_launches.items() if k != interp}
    others_attempt = {k: v for k, v in ray_step.table_attempt_launches.items() if k != interp}
    with kernel_runs() as runs:
        drv.run(3, 5)
    attempts = sum(int(i["n_accepted"]) + int(i["n_rejected"]) for i in drv.ray_infos)
    if method == "rk4":
        assert runs["table"] == 15 and runs["table attempt"] == 0
    else:
        assert runs["table attempt"] == attempts >= 15 and runs["table"] == 0
    assert runs["pair table"] == 15 and runs["first cut"] == 0 and runs["roll"] == 0
    assert {k: v for k, v in ray_step.table_launches.items() if k != interp} == others
    assert ({k: v for k, v in ray_step.table_attempt_launches.items() if k != interp}
            == others_attempt)
    sim = drv.sim
    assert bool(torch.isfinite(sim.sol.abs()).all())
    assert float(torch.sqrt(sim.packets.k ** 2 + sim.packets.l ** 2).max()) < drv.k_cutoff
    assert abs(float(rsw.total_energy(sim.sol, grid, params)) - e0) < 0.01 * e0


def _frame(argv, flow_steps, **kw):
    """(case, ``make_coupled_frame`` over the command line's case with
    IF-AB3 at its dt, its k-cutoff and reset wavenumber, the state at a
    ``sol``)."""
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.driver import SimState, make_coupled_frame
    from juliaraytracingsw_tpu_torch.models.base import build_stepper
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih

    args, case = setup_case(argv)
    init, step = build_stepper(case.model, "IFMAB3", args.dt)
    frame = make_coupled_frame(case.model, step, case.psih_fn, case.rp, flow_steps,
                               **_cutoffs(args, case), **kw)

    def state(sol):
        fields = fields_from_psih(case.psih_fn(sol), case.model.grid, case.rp.interp)
        return SimState(sol, zero_clock(device=sol.device), init(sol), case.packets, fields)

    return case, frame, state


def _loss_grad(case, frame, state):
    """d mean(k^2 + l^2) / d sol after ``frame`` from the case's state."""
    sol = case.sol0.clone().requires_grad_()
    end = frame(state(sol))
    return torch.autograd.grad(torch.mean(end.packets.k ** 2 + end.packets.l ** 2), sol)[0]


@pytest.mark.cuda
def test_frame_gradient_gpu_matches_cpu(cuda_device):
    """The gradient of mean(k^2 + l^2) with respect to ``sol`` through one
    RK4 frame of 5 steps, 128^2 x 16,384 packets, float32 tables, on the
    card (5 table-kernel launches, no first cut) against the CPU: relative
    L2 within 1e-4 (cuFFT against the CPU's FFT, FMA contraction in the
    kernel, atomics in the scatters). Then one implicit-midpoint frame,
    forward, which runs no table kernel: ``sol`` within 1e-5, packets within
    1e-4."""
    def argv(platform):
        return coupled_argv("rsw", 128, 128, 1, *HERO_IC, "--table-dtype", "float32",
                            platform=platform)

    before = (ray_step.table_launches["bilinear"], _first_cut_launches())
    gpu = _loss_grad(*_frame(argv(cuda_device), 5))
    torch.cuda.synchronize()
    assert ray_step.table_launches["bilinear"] == before[0] + 5
    assert _first_cut_launches() == before[1]
    cpu = _loss_grad(*_frame(argv("cpu"), 5))
    assert float(torch.linalg.vector_norm(gpu.cpu() - cpu)
                 / torch.linalg.vector_norm(cpu)) <= 1e-4

    before = dict(ray_step.table_launches)
    ends = []
    for platform in (cuda_device, "cpu"):
        case, frame, state = _frame(argv(platform), 5, ray_method="midpoint")
        ends.append(frame(state(case.sol0)))
    assert ray_step.table_launches == before
    assert rel_gap(ends[0].sol, ends[1].sol) < 1e-5
    assert packet_gap(ends[0].packets, ends[1].packets) < 1e-4
    assert float((ends[1].packets.x - case.packets.x).abs().max()) > 1e-4


@pytest.mark.cuda
def test_fwd_bwd_step_runs_the_table_kernel_once(cuda_device):
    """The hero's differentiable step (one flow step, then one RK4 ray
    substep over bf16 tables; the value and gradient of mean(k^2 + l^2)
    with respect to ``sol``) at 128^2 x 16,384 packets: one table-kernel
    launch, none of the first cut or the attempt; the gradient finite and
    nonzero."""
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.models.base import build_stepper
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih, raytrace

    args, case = setup_case(coupled_argv("rsw", 128, 128, 1, *HERO_IC))
    grid, rp = case.model.grid, case.rp
    init, step = build_stepper(case.model, "IFMAB3", args.dt)
    before = (dict(ray_step.table_launches), dict(ray_step.table_attempt_launches),
              _first_cut_launches())
    sol = case.sol0.clone().requires_grad_()
    fields_old = fields_from_psih(case.psih_fn(sol), grid, rp.interp)
    sol1, _, _ = step(sol, zero_clock(device=cuda_device), init(sol))
    fields_new = fields_from_psih(case.psih_fn(sol1), grid, rp.interp)
    out = raytrace(case.packets, fields_old, fields_new, 0.0, args.dt, rp, nsubsteps=1)
    (grad,) = torch.autograd.grad(torch.mean(out.k ** 2 + out.l ** 2), sol)
    torch.cuda.synchronize()
    assert ray_step.table_launches == {**before[0], "bilinear": before[0]["bilinear"] + 1}
    assert ray_step.table_attempt_launches == before[1]
    assert _first_cut_launches() == before[2]
    assert bool(torch.isfinite(grad.abs()).all()) and float(grad.abs().max()) > 0


@pytest.mark.cuda
def test_remat_gradient_equals_plain(cuda_device):
    """The gradient through 10 coupled 512^2 steps (taps gather, 16,384
    packets) with ``remat`` (each step recomputed in the backward) and
    without: max |difference| within 1e-6 of the largest gradient (the
    recomputed steps are the same calls; only the atomics' order differs)."""
    argv = coupled_argv("rsw", 512, 128, 1, *HERO_IC, "--table-dtype", "float32",
                        platform=cuda_device, gather="taps")
    grads = [_loss_grad(*_frame(argv, 10, remat=remat)) for remat in (False, True)]
    assert bool(torch.isfinite(grads[1].abs()).all())
    assert float((grads[1] - grads[0]).abs().max() / grads[0].abs().max()) <= 1e-6


@pytest.mark.cuda
def test_card_checkpoint_restores_on_the_cpu(tmp_path, cuda_device):
    """The command line's checkpoint of a graphed run on the card (128^2 x
    16,384 packets, bf16 tables, 3 frames) restored into the command line's
    driver on the CPU: every leaf equal, on the CPU."""
    from juliaraytracingsw_tpu_torch.io.checkpoint import _flatten

    path = str(tmp_path / "card.npz")
    gpu = drive_cli(coupled_argv("rsw", 128, 128, 3, *HERO_IC, "--checkpoint", path))
    cpu = cli_driver(coupled_argv("rsw", 128, 128, 3, *HERO_IC, platform="cpu"))[0]
    cpu.restore(path)
    for (p, x), (_, y) in zip(_flatten(cpu.sim), _flatten(gpu.sim), strict=True):
        if isinstance(x, torch.Tensor):
            assert x.device.type == "cpu" and torch.equal(x, y.cpu()), p
        else:
            assert x == y, p


@pytest.mark.cuda
@pytest.mark.parametrize("cmd,extra", [
    ("rsw", ("--model", "linborg", *HERO_IC)), ("rsw", ("--model", "modified", *HERO_IC)),
    ("rsw", ("--model", "quadheight", *HERO_IC)), ("single-wave", ())],
    ids=["linborg", "modified", "quadheight", "single-wave"])
def test_other_coupled_frames_gpu_match_cpu(cmd, extra, cuda_device):
    """One coupled frame of each RSW variant at 64^2 x 4,096 packets (5
    table-kernel launches), and of ``single-wave`` at 64^2 (2 packets, 5
    spin-up steps, the taps path), through the command line's set-up on the
    card against the CPU: ``sol`` within 1e-5 of its largest mode, packets
    within 1e-4."""
    sqrtp, spinup, launches = (1, 5, 0) if cmd == "single-wave" else (64, 0, 5)
    before = ray_step.table_launches["bilinear"]
    gpu, cpu = (drive_cli(coupled_argv(cmd, 64, sqrtp, 1, *extra, platform=platform,
                                       spinup_steps=spinup)).sim
                for platform in (cuda_device, "cpu"))
    assert ray_step.table_launches["bilinear"] - before == launches
    assert rel_gap(gpu.sol, cpu.sol) < 1e-5
    assert packet_gap(gpu.packets, cpu.packets) < 1e-4


@pytest.mark.cuda
def test_thomasyamada_phases_gpu_match_cpu(cuda_device):
    """The ``thomasyamada`` command line's startup and main phases
    (``ty_driver._phase``, ETDRK4, no writer) at 64^2, 20 steps each in
    chunks of 10, on the card against the CPU: ``sol`` within 1e-5 of its
    largest mode, every diagnostic finite."""
    import time

    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled import ty_driver
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import ty_initial_condition
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli
    from juliaraytracingsw_tpu_torch.models import thomasyamada

    ends = []
    for platform in (cuda_device, "cpu"):
        args = cli.build_parser().parse_args(["thomasyamada", "--nx", "64", "--platform",
                                              platform])
        cfg = cli.setup_thomasyamada(args, quiet)
        grid = make_grid(64, Lx=cfg.Lx, device=platform)
        model = thomasyamada.make_model(grid, nu=cfg.nu, nnu=cfg.nnu, Ro=cfg.Ro)
        sol = ty_initial_condition(grid, np.random.default_rng(cfg.seed), cfg.k0g_range,
                                   cfg.k0w_range, cfg.at, cfg.ag, cfg.aw)
        clock, diags = zero_clock(device=platform), {k: [] for k in ty_driver.DIAG_KEYS}
        for label, dt in (("startup", cfg.startup_dt), ("main", cfg.dt)):
            sol, clock = ty_driver._phase(model, cfg, sol, clock, dt, 20, 10, None, diags,
                                          label, time.time())
        assert all(len(v) == 4 and np.isfinite(v).all() for v in diags.values())
        ends.append(sol)
    assert rel_gap(*ends) < 1e-5


@pytest.mark.cuda
def test_steady_raytracing_launches(cuda_device):
    """``steady-raytracing`` through the command line at 64^2 x 4,096
    packets ('auto' -> patch, bf16 tables), 2 frames of 20 substeps handed
    to a writer that keeps nothing: exactly 40 table-kernel launches, none
    of the first cut or birth/death; the packets finite."""
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli
    from juliaraytracingsw_tpu_torch.ops import birth_death

    nx = 64
    output_dt = 20 * 0.1 / 2.0 * (2 * np.pi / nx)     # 20 CFL steps at the default tune
    args = cli.build_parser().parse_args([
        "steady-raytracing", "--nx", str(nx), "--sqrt-npackets", "64", "--interp", "bilinear",
        "--table-dtype", "bfloat16", "--gather", "auto", "--output-dt", repr(output_dt),
        "--T", repr(2.5 * output_dt), "--seed", "1", "--platform", cuda_device])
    before = (dict(ray_step.table_launches), _first_cut_launches(),
              birth_death.launches["birth_death"])
    packets, _ = cli.steady_raytracing(args, cli._NullWriter(), log_fn=quiet)
    torch.cuda.synchronize()
    assert ray_step.table_launches == {**before[0], "bilinear": before[0]["bilinear"] + 40}
    assert _first_cut_launches() == before[1]
    assert birth_death.launches["birth_death"] == before[2]
    assert all(bool(torch.isfinite(a).all()) for a in packets)


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["nufft_raytrace", "raytrace1d rk4", "raytrace1d midpoint",
                                  "forced rsw"])
def test_other_paths_gpu_match_cpu(path, cuda_device):
    """``nufft_raytrace`` (64^2, 4,096 packets, 2 RK4 substeps): packets
    within 1e-4; ``raytrace1d`` (4,096 rays, 200 steps of 1e-3 through the
    integrator benchmark's field): within 1e-5 of each output's largest
    value; 5 IF-AB3 steps of forced RSW at 64^2: ``sol`` within 1e-5 of its
    largest mode. On the card against the CPU."""
    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import (band_geo_wave_ic,
                                                                        random_band_psih)
    from juliaraytracingsw_tpu_torch.models import rsw
    from juliaraytracingsw_tpu_torch.models.base import build_stepper, run
    from juliaraytracingsw_tpu_torch.rays import nufft_rays, ray1d
    from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets

    f, cg = 3.0, 1.0
    k0 = float(np.sqrt(3.0) * f / cg)
    outs = []
    for device in (cuda_device, "cpu"):
        if path == "nufft_raytrace":
            grid = make_grid(64, device=device)
            rng = np.random.default_rng(3)
            so, sn = (nufft_rays.spectra_from_psih(
                random_band_psih(grid, rng, kband=(2, 6), amp=0.2), grid) for _ in range(2))
            rp = RayParams(f=f, Cg=cg, x0=float(grid.x[0]), y0=float(grid.y[0]), dx=grid.dx,
                           dy=grid.dy)
            packets = lattice_packets(64, grid.Lx, grid.Ly, k0=k0, k_ring=True, device=device)
            outs.append(nufft_rays.nufft_raytrace(packets, so, sn, 0.0, 0.02, grid, rp,
                                                  nsubsteps=2))
        elif path.startswith("raytrace1d"):
            u, ux = (torch.as_tensor(a, dtype=torch.float32, device=device)
                     for a in ray1d.benchmark_field(512))
            outs.append(ray1d.raytrace1d(ray1d.init_rays1d(4096, device=device), u, ux, 1e-3,
                                         200, 2 * np.pi, path.split()[1]))
        else:
            grid = make_grid(64, device=device)
            Fh = torch.as_tensor(np.random.default_rng(6).normal(size=(3, 64, 33))
                                 .astype(np.complex64) * 0.3, device=device)
            model = rsw.make_model(grid, nu=1e-8, nnu=4, f=f, Cg=cg,
                                   forcing=lambda sol, t, Fh=Fh: Fh * torch.cos(5.0 * t))
            sol = band_geo_wave_ic(grid, np.random.default_rng(1), ag=0.5, aw=0.05, f=f, Cg=cg)
            init, step = build_stepper(model, "IFMAB3", DT)
            outs.append(run(step, sol, zero_clock(device=device), init(sol), 5)[0])
    if path == "nufft_raytrace":
        assert packet_gap(*outs) < 1e-4
    elif path.startswith("raytrace1d"):
        assert max(rel_gap(a, b) for a, b in zip(*outs)) < 1e-5
    else:
        assert rel_gap(*outs) < 1e-5


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


@pytest.mark.cuda
def test_birth_death_frames_on_the_card(tmp_path, cuda_device):
    """Weibull(1.5, 10) birth/death on 65,536 packets at 128^2 (float32
    tables), 4 frames of 5 RK4 steps through the command line's driver,
    graphed from the second: one table-kernel and one birth/death-kernel
    run a step, as a profiler trace counts them; the births within 5 sigma
    of N T E[1/L] (staggered ages: a packet of lifetime L dies within T
    with chance T / L). Its checkpoint (the JAX package's layout, the key
    uint32[2]) restored on the CPU, one more frame on each device: ages,
    keys and births bit-equal, lifetimes within 1 ulp (float64 log and pow,
    rounded once), ``sol`` within 1e-5 of its largest mode, packets within
    1e-4."""
    def argv(platform):
        return coupled_argv("rsw", 128, 256, 1, *HERO_IC, "--table-dtype", "float32",
                            "--birth-death", platform=platform)

    gpu = cli_driver(argv(cuda_device))[0]
    with kernel_runs() as runs:
        gpu.run(4, 5)
    assert runs["table"] == runs["birth_death"] == 20 and runs["first cut"] == 0
    n, T, births = gpu.sim.packets.n, float(gpu.sim.clock.t), int(gpu.sim.bd.births)
    expected = n * T * math.gamma(1.0 - 1.0 / gpu.bd_k_shape) / gpu.bd_lam
    assert abs(births - expected) <= 5 * math.sqrt(expected), (births, expected)

    path = str(tmp_path / "bd.npz")
    gpu.checkpoint(path)
    with np.load(path) as data:
        paths = bytes(data["__treepaths__"]).decode().split("\n")
        assert paths[-4:] == [".bd.age", ".bd.lifetime", ".bd.key", ".bd.births"]
        assert data[f"leaf_{paths.index('.bd.key')}"].dtype == np.uint32
    cpu = cli_driver(argv("cpu"))[0]
    cpu.restore(path)
    for drv in (gpu, cpu):
        drv.run(1, 5)
    g, c = gpu.sim, cpu.sim
    for name in ("age", "key", "births"):
        assert torch.equal(getattr(g.bd, name).cpu(), getattr(c.bd, name)), name
    assert _ulps(g.bd.lifetime, c.bd.lifetime) <= 1.0
    assert int(g.bd.births) > births
    assert rel_gap(g.sol, c.sol) < 1e-5
    assert packet_gap(g.packets, c.packets) < 1e-4


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


# the JAX tests' limits for a sharded run against a replicated one
def _sharded_close(got, want, packets=False):
    got, want = got.cpu(), want.cpu()
    if packets:
        return torch.allclose(got, want, rtol=5e-4, atol=5e-5)
    return torch.allclose(got, want, rtol=2e-4, atol=2e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_sharded_frame_matches_the_replicated_frame(nccl_mesh, cuda_device):
    """``ShardedRSW`` on a mesh of one (NCCL) at 128^2, 16,384 packets over
    bf16 tables, spun up 10 sharded steps, 2 frames of 5 steps: one
    table-kernel and one pair-table launch a step, no first cut, the first
    frame within the JAX tests' limits of the replicated
    ``make_coupled_frame`` from the same state; ``overlap=True`` from the
    end state gives the sequential frame's ``sol`` bit for bit and its
    packets within rtol 1e-6, atol 1e-7."""
    from juliaraytracingsw_tpu_torch.core.steppers import AB3State, zero_clock
    from juliaraytracingsw_tpu_torch.coupled.driver import SimState, make_coupled_frame
    from juliaraytracingsw_tpu_torch.models.base import build_stepper
    from juliaraytracingsw_tpu_torch.ops import pair_table
    from juliaraytracingsw_tpu_torch.parallel.mesh import gather_packets, shard_packets
    from juliaraytracingsw_tpu_torch.parallel.sharded_rsw import ShardedRSW
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih

    mesh = nccl_mesh
    args, case = setup_case(coupled_argv("rsw", 128, 128, 1, *HERO_IC, "--gather", "patch"))
    grid, model, rp = case.model.grid, case.model, case.rp
    cut = _cutoffs(args, case)
    sh = ShardedRSW(grid, model.params, mesh, dt=args.dt)
    init_fn, step_fn = sh.stepper()
    sol, clock = sh.shard_solution(case.sol0), zero_clock(device=cuda_device)
    state = init_fn(sol)
    for _ in range(10):
        sol, clock, state = step_fn(sol, clock, state)
    start = (sol, clock, state, shard_packets(case.packets, mesh))
    frame = sh.make_coupled_frame(rp, 5, **cut)
    before = (dict(ray_step.table_launches), dict(pair_table.pair_table_launches),
              _first_cut_launches())
    first = frame(*start)
    end = frame(*first)
    torch.cuda.synchronize()
    assert ray_step.table_launches == {**before[0], "bilinear": before[0]["bilinear"] + 10}
    assert pair_table.pair_table_launches == {**before[1],
                                              "bilinear": before[1]["bilinear"] + 10}
    assert _first_cut_launches() == before[2]

    sol_s, clock_s, state_s, pk_s = start
    full = sh.unshard(sol_s)
    init_r, step_r = build_stepper(model, "IFMAB3", args.dt)
    ref = make_coupled_frame(model, step_r, case.psih_fn, rp, 5, **cut)(
        SimState(full, clock_s, AB3State(sh.unshard(state_s.N1), sh.unshard(state_s.N2)),
                 gather_packets(pk_s, mesh), fields_from_psih(case.psih_fn(full), grid,
                                                              rp.interp)))
    assert _sharded_close(sh.unshard(first[0]), ref.sol)
    got = gather_packets(first[3], mesh)
    assert all(_sharded_close(getattr(got, c), getattr(ref.packets, c), packets=True)
               for c in "xykl")

    overlap = sh.make_coupled_frame(rp, 5, overlap=True, **cut)
    (sa, _, _, pa), (sb, cb, _, pb) = (f(*end) for f in (frame, overlap))
    assert torch.equal(sa, sb) and cb.step == end[1].step + 5
    assert all(torch.allclose(b, a, rtol=1e-6, atol=1e-7) for a, b in zip(pa, pb))


def _sharded_run(argv, mesh):
    """A coupled subcommand's ``--sharded`` run on ``mesh`` without
    writers, as the command line runs it -> (arguments, case, ``ShardedRun``)."""
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli

    args, case = setup_case(argv)
    cli._check_sharded_options(args)
    return args, case, cli.run_sharded(args, case, cli.make_sharded(args, case, mesh),
                                       log_fn=quiet)


@pytest.mark.cuda
def test_sharded_rsw_command_line_restores_on_the_cpu(tmp_path, nccl_mesh, cuda_device):
    """``rsw --sharded`` on a mesh of one at 128^2 x 16,384 packets, float32
    tables, 2 frames ('auto' -> patch: 10 table-kernel launches) and its
    ``--checkpoint`` (the unsharded tree) restored on the CPU by the
    replicated port: the next frame of each within 1e-5 (``sol``, of its
    largest mode) and 1e-4 (packets)."""
    from juliaraytracingsw_tpu_torch.core.steppers import AB3State, zero_clock
    from juliaraytracingsw_tpu_torch.coupled.driver import SimState
    from juliaraytracingsw_tpu_torch.io.checkpoint import load_checkpoint
    from juliaraytracingsw_tpu_torch.parallel.mesh import gather_packets
    from juliaraytracingsw_tpu_torch.rays.raytrace import fields_from_psih

    ckpt = str(tmp_path / "sharded.npz")

    def argv(platform):
        return coupled_argv("rsw", 128, 128, 2, *HERO_IC, "--table-dtype", "float32",
                            "--sharded", "--checkpoint", ckpt, platform=platform)

    before = ray_step.table_launches["bilinear"]
    args, case, res = _sharded_run(argv(cuda_device), nccl_mesh)
    torch.cuda.synchronize()
    assert case.rp.gather == "patch" and ray_step.table_launches["bilinear"] - before == 10
    frame = res.sh.make_coupled_frame(case.rp, 5, **_cutoffs(args, case))
    sol_g, _, _, pk_g = frame(res.sol, res.clock, res.state, res.packets)

    drv, _, cpu_case = cli_driver(argv("cpu"))
    like = {"sol": cpu_case.sol0, "clock": zero_clock(device="cpu"), "N1": cpu_case.sol0,
            "N2": cpu_case.sol0, "packets": cpu_case.packets}
    tree = load_checkpoint(ckpt, like)
    drv.sim = SimState(tree["sol"], tree["clock"], AB3State(tree["N1"], tree["N2"]),
                       tree["packets"], fields_from_psih(cpu_case.psih_fn(tree["sol"]),
                                                         cpu_case.model.grid, cpu_case.rp.interp))
    drv.run(1, 5)
    assert rel_gap(res.sh.unshard(sol_g), drv.sim.sol) < 1e-5
    assert packet_gap(gather_packets(pk_g, res.sh.mesh), drv.sim.packets) < 1e-4


@pytest.mark.cuda
def test_sharded_twolayer_and_thomasyamada_match_replicated(nccl_mesh, cuda_device):
    """On a mesh of one, against the replicated port on the card, within the
    JAX tests' limits: ``twolayer --sharded`` at 256^2 x 4,096 packets on
    the taps path, 2 frames (no table-kernel launch); the sharded
    Thomas-Yamada phase at 128^2 (IF-AB3, 20 steps in 2 chunks) against
    the replicated phase."""
    import time

    from juliaraytracingsw_tpu_torch.core.grid import make_grid
    from juliaraytracingsw_tpu_torch.core.steppers import zero_clock
    from juliaraytracingsw_tpu_torch.coupled import ty_driver
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import ty_initial_condition
    from juliaraytracingsw_tpu_torch.experiments import __main__ as cli
    from juliaraytracingsw_tpu_torch.models import thomasyamada
    from juliaraytracingsw_tpu_torch.parallel.mesh import gather_packets
    from juliaraytracingsw_tpu_torch.parallel.sharded import ShardedThomasYamada

    two = coupled_argv("twolayer", 256, 64, 2, platform=cuda_device, gather="taps")
    before = dict(ray_step.table_launches)
    _, case, res = _sharded_run(two + ["--sharded"], nccl_mesh)
    torch.cuda.synchronize()
    assert case.rp.gather == "taps" and ray_step.table_launches == before
    rep = drive_cli(two).sim
    assert _sharded_close(res.sh.unshard(res.sol), rep.sol)
    got = gather_packets(res.packets, res.sh.mesh)
    assert all(_sharded_close(getattr(got, c), getattr(rep.packets, c), packets=True)
               for c in "xykl")

    args = cli.build_parser().parse_args(["thomasyamada", "--nx", "128", "--platform",
                                          cuda_device])
    cfg = cli.setup_thomasyamada(args, quiet)
    cfg.stepper = "IFMAB3"
    grid = make_grid(128, Lx=cfg.Lx, device=cuda_device)
    sol0 = ty_initial_condition(grid, np.random.default_rng(cfg.seed), cfg.k0g_range,
                                cfg.k0w_range, cfg.at, cfg.ag, cfg.aw)
    model = thomasyamada.make_model(grid, nu=cfg.nu, nnu=cfg.nnu, Ro=cfg.Ro)
    tsh = ShardedThomasYamada(grid, model.params, nccl_mesh, dt=cfg.dt)
    diags = {k: [] for k in ty_driver.DIAG_KEYS}
    sharded, _ = ty_driver._phase_sharded(tsh, cfg, tsh.shard_solution(sol0),
                                          zero_clock(device=cuda_device), cfg.dt, 20, 10, None,
                                          diags, "main", time.time())
    replicated, _ = ty_driver._phase(model, cfg, sol0, zero_clock(device=cuda_device), cfg.dt,
                                     20, 10, None, {k: [] for k in ty_driver.DIAG_KEYS}, "main",
                                     time.time())
    assert _sharded_close(tsh.unshard(sharded), replicated)
