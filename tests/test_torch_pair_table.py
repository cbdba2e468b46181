"""The pair table (``ops/pair_table``): its kernel, its twin, its adjoint,
and the coupled frame that builds one table a step.

On the CPU: ``pair_table`` is its twin, the roll path
(``make_pair_table`` of two ``build_patch_table``s), and counts no
launch; ``PairTable``'s backward (the adjoint: each ``(dy, dx)`` slice of
the cotangent rolled back and summed) matches autograd through the twin
for every interp and table dtype, to the bound of a float32 sum of
``ph * pw`` terms taken in another order; what the wrapper refuses; the
fixed-step coupled frame, which builds ``build_pair(fields_old, fields)``
each step, gives the state of the frame that carried the previous step's
patch table, bit for bit.

On the card (marked ``cuda``, skipped without one): the kernel bit-equal to
the twin run on the card for 3 interps x 2 table dtypes at 512^2, on a
non-square grid and on a 37 x 53 grid that no tile divides; one launch
counted a ``build_pair``; float64 fields refused. These import no JAX:

    python -m pytest --noconftest -q tests/test_torch_pair_table.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._pytree import tree_map_only  # noqa: E402
from torch_card import cuda_device  # noqa: E402, F401

from juliaraytracingsw_tpu_torch.core.steppers import Clock  # noqa: E402
from juliaraytracingsw_tpu_torch.experiments import __main__ as cli  # noqa: E402
from juliaraytracingsw_tpu_torch.ops import pair_table as pt  # noqa: E402
from juliaraytracingsw_tpu_torch.ops.ray_step import n_channels  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.patch import PATCH_SHAPES, build_patch_table  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.raytrace import (  # noqa: E402
    build_pair, fields_from_psih, make_pair_table, raytrace_tables_fb)
from juliaraytracingsw_tpu_torch.rays.resample import k_cutoff_reset  # noqa: E402

INTERPS = ["bilinear", "bspline", "bicubic"]
DTYPES = ["float32", "bfloat16"]


def _fields(interp, ny, nx, seed=0, device="cpu", dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.standard_normal((n_channels(interp), ny, nx)).astype(dtype),
                                 device=device) for _ in range(2))


# --- the CPU: twin, adjoint, refusals -----------------------------------------

@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("interp", INTERPS)
def test_cpu_runs_the_twin_and_counts_no_launch(interp, table_dtype):
    fo, fn = _fields(interp, 7, 9)
    before = dict(pt.pair_table_launches)
    T = pt.pair_table(fo, fn, interp=interp, table_dtype=table_dtype)
    assert torch.equal(T, make_pair_table(build_patch_table(fo, interp),
                                          build_patch_table(fn, interp), table_dtype))
    assert T.dtype == getattr(torch, table_dtype)
    assert pt.pair_table_launches == before


@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("interp", INTERPS)
def test_adjoint_matches_autograd_through_the_twin(interp, table_dtype):
    """Each stack's cotangent is a sum of ph * pw table cotangents; the two
    sums differ only in their order, so by at most 2 (ph pw) 2^-24 times
    the sum of the terms' magnitudes (the adjoint of |cotangent|)."""
    fo, fn = (f.requires_grad_() for f in _fields(interp, 11, 13, seed=1))
    T = pt.pair_table(fo, fn, interp=interp, table_dtype=table_dtype)
    ref = pt.pair_table_torch(fo, fn, interp, table_dtype)
    cot = torch.as_tensor(np.random.default_rng(2).standard_normal(tuple(T.shape))
                          .astype(np.float32)).to(T.dtype)
    got = torch.autograd.grad(T, (fo, fn), cot)
    want = torch.autograd.grad(ref, (fo, fn), cot)
    ph, pw, _ = PATCH_SHAPES[interp]
    mags = pt.pair_table_adjoint(cot.abs(), interp, 11, 13, torch.float32)
    for a, b, m in zip(got, want, mags):
        assert a.dtype == b.dtype == torch.float32
        assert bool(((a - b).abs() <= 2 * ph * pw * 2.0 ** -24 * m).all())
        assert float(b.abs().max()) > 0
    # a cotangent on one level reaches that stack only
    only_new = torch.zeros_like(cot)
    only_new[:, T.shape[1] // 2:] = cot[:, T.shape[1] // 2:]
    g_old, g_new = torch.autograd.grad(pt.pair_table(fo, fn, interp=interp,
                                                     table_dtype=table_dtype), (fo, fn), only_new)
    assert not g_old.any() and g_new.any()


def test_adjoint_in_float64_and_for_one_stack():
    """float64 fields (the CPU's gradient checks) get float64 cotangents;
    a stack that needs none gets none."""
    fo, fn = _fields("bspline", 6, 10, seed=3, dtype=np.float64)
    fo.requires_grad_()
    T = pt.pair_table(fo, fn, interp="bspline")
    assert T.dtype == torch.float32 and fn.grad is None
    (T.double() ** 2).sum().backward()
    ref = torch.autograd.grad((pt.pair_table_torch(fo, fn, "bspline", "float32").double() ** 2)
                              .sum(), fo)[0]
    assert fo.grad.dtype == torch.float64
    torch.testing.assert_close(fo.grad, ref, rtol=1e-12, atol=1e-12)


def test_refuses_what_it_cannot_build():
    fo, fn = _fields("bilinear", 8, 8)
    with pytest.raises(ValueError, match="table_dtype"):
        pt.pair_table(fo, fn, interp="bilinear", table_dtype="float16")
    with pytest.raises(ValueError, match="unsupported fused interp"):
        pt.pair_table(fo, fn, interp="nearest")
    with pytest.raises(ValueError, match="shape"):
        pt.pair_table(fo, fn, interp="bicubic")          # 5 fields, not 20
    with pytest.raises(ValueError, match="shape"):
        pt.pair_table(fo, fn[:, :4], interp="bilinear")
    with pytest.raises(TypeError, match="fields_new must be float32"):
        pt.pair_table(fo, fn.double(), interp="bilinear")
    with pytest.raises(ValueError, match=r"\(F, ny, nx\)"):
        pt.pair_table(fo[0], fn[0], interp="bilinear")


# --- the coupled frame: one table a step ---------------------------------------

K = 4


def _driver(ray_method, *extra):
    args = cli.build_parser().parse_args(
        ["rsw", "--nx", "32", "--sqrt-npackets", "16", "--gather", "patch", "--interp",
         "bilinear", "--table-dtype", "bfloat16", "--ray-method", ray_method, "--seed", "5",
         "--platform", "cpu", *extra])
    case = cli.SETUPS["rsw"](args, lambda line: None)
    drv = cli.make_driver(args, case, log_fn=lambda line: None)
    drv.init(case.sol0, case.packets)
    drv.spinup(4, chunk=4)
    return drv


def _carried_table_frame(drv):
    """The fixed-step frame as it was: a patch table of the frame's first
    fields, then one a step, paired with the one the step before built."""
    rp, grid = drv.rp, drv.model.grid

    def frame(sim):
        sol, clock, sstate, packets, fields = (sim.sol, sim.clock, sim.stepper_state,
                                               sim.packets, sim.fields)
        T_old = build_patch_table(fields, rp.interp)
        for _ in range(K):
            t0 = clock.t
            if drv.frozen_flow:
                clock = Clock(clock.t + drv.dt, clock.step + 1)
                new, T_new = fields, T_old
            else:
                sol, clock, sstate = drv._step_fn(sol, clock, sstate)
                new = fields_from_psih(drv.psih_fn(sol), grid, rp.interp)
                T_new = build_patch_table(new, rp.interp)
            packets = raytrace_tables_fb(packets, make_pair_table(T_old, T_new, rp.table_dtype),
                                         fields, new, t0, clock.t, rp, grid.ny, grid.nx,
                                         nsubsteps=drv.ray_substeps, method=drv.ray_method)
            packets = k_cutoff_reset(packets, drv.k_cutoff, drv.k0)
            fields, T_old = new, T_new
        return sim._replace(sol=sol, clock=clock, stepper_state=sstate, packets=packets,
                            fields=fields)

    return frame


@pytest.mark.parametrize("ray_method,extra", [
    ("rk4", ()), ("dopri5", ()), ("midpoint", ()), ("rk4", ("--frozen-flow",))],
    ids=["rk4", "dopri5", "midpoint", "rk4_frozen"])
def test_frame_without_the_carried_table_gives_the_same_state(ray_method, extra):
    drv = _driver(ray_method, *extra)
    sim0 = drv.sim
    got = drv._get_frame("coupled", K)(tree_map_only(torch.Tensor, torch.clone, sim0))
    want = _carried_table_frame(drv)(tree_map_only(torch.Tensor, torch.clone, sim0))
    for a, b in zip((got.sol, got.clock.t, got.fields, *got.stepper_state, *got.packets),
                    (want.sol, want.clock.t, want.fields, *want.stepper_state, *want.packets)):
        assert torch.equal(a, b)
    assert got.clock.step == want.clock.step == sim0.clock.step + K
    assert not torch.equal(got.packets.x, sim0.packets.x)


# --- on the card ---------------------------------------------------------------

SHAPES = [(512, 512), (96, 160), (37, 53)]


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("interp", INTERPS)
def test_kernel_is_bit_equal_to_the_twin(interp, table_dtype, ny, nx, cuda_device):
    fo, fn = _fields(interp, ny, nx, seed=ny + nx, device=cuda_device)
    before = pt.pair_table_launches[interp]
    T = pt.pair_table(fo, fn, interp=interp, table_dtype=table_dtype)
    torch.cuda.synchronize()
    assert pt.pair_table_launches[interp] == before + 1
    ref = pt.pair_table_torch(fo, fn, interp, table_dtype)
    assert T.dtype == ref.dtype and T.shape == ref.shape
    assert torch.equal(T.view(torch.int16 if T.dtype == torch.bfloat16 else torch.int32),
                       ref.view(torch.int16 if T.dtype == torch.bfloat16 else torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("interp", INTERPS)
def test_build_pair_launches_once(interp, cuda_device):
    from juliaraytracingsw_tpu_torch.rays.raytrace import RayParams

    fo, fn = _fields(interp, 64, 64, device=cuda_device)
    rp = RayParams(f=3.0, Cg=1.0, x0=0.0, y0=0.0, dx=0.1, dy=0.1, interp=interp,
                   table_dtype="bfloat16")
    before = dict(pt.pair_table_launches)
    for i in range(3):
        build_pair(fo, fn, rp)
        assert pt.pair_table_launches == {**before, interp: before[interp] + i + 1}
    with pytest.raises(TypeError, match="float64"):
        build_pair(fo.double(), fn.double(), rp)


@pytest.mark.cuda
def test_kernel_gradient_is_the_adjoint(cuda_device):
    fo, fn = (f.requires_grad_() for f in _fields("bilinear", 37, 53, device=cuda_device))
    T = pt.pair_table(fo, fn, interp="bilinear", table_dtype="bfloat16")
    cot = torch.ones_like(T)
    g = torch.autograd.grad(T, (fo, fn), cot)
    ph, pw, _ = PATCH_SHAPES["bilinear"]
    for a in g:      # every field value is read by ph * pw rows of its level
        assert torch.equal(a, torch.full_like(a, ph * pw))


# --- the benchmark's reader of the kernel ----------------------------------------

@pytest.mark.parametrize("cell", ["rsw512_rk4", "rsw512_adaptive"])
def test_the_benchmark_reads_the_kernel_by_name(cell):
    """``rays.pair_table_ms_per_step``: the kernel's device ms over the steps
    profiled, by name; nothing where the trace holds no such kernel (the
    roll path's kernels, or a program without this one)."""
    from portbench import spec

    read = spec.reader("rays.pair_table_ms_per_step")
    ops = {"void (anonymous namespace)::pair_table_kernel<0, unsigned short>(...)": [20, 0.0008],
           "void (anonymous namespace)::ray_step_table_kernel<0, jrsw::bf16_bits>(...)":
               [20, 0.003]}
    assert read(dict(device_ops=ops, steps=20), spec.load_cell(cell)) == pytest.approx(0.04)
    rolls = {"void at::native::roll_cuda_kernel<float>(...)": [640, 0.1]}
    assert read(dict(device_ops=rolls, steps=20), spec.load_cell(cell)) is None
    assert read(dict(device_ops=ops, steps=0), spec.load_cell(cell)) is None
