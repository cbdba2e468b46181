"""The table forms of the ray kernels on the CPU: their plain twins, the
cell index they find, and what their wrappers refuse.

``ops/ray_step.table_substep`` and ``table_attempt`` read the pair table
``T_pair (ny*nx, 2W)`` themselves on the card. On the CPU they run their
twins, which are the ray path's gather, the transpose and the first cut's
twin, so they must be bit-equal to that chain. The kernels' cell index is
``floor((x - x0) / dx)`` in IEEE float32 with x0 and dx each rounded once,
wrapped with Python's ``remainder``: the tests pin the twin's gather to that
formula, computed in numpy, and to the JAX package's ``_gather_patch_rows``
run eagerly (under ``jit`` XLA divides by the constant's reciprocal, which
moves points within an ulp of a face). The kernels themselves are held
against these twins on the card, at ragged sizes and at the hero's, by
the ``cuda`` tests of ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.rays import packets as jpk  # noqa: E402
from juliaraytracingsw_tpu.rays import raytrace as jrt  # noqa: E402
from juliaraytracingsw_tpu_torch.ops import ray_step as tops  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import packets as tpk  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import raytrace as trt  # noqa: E402

INTERPS = ["bilinear", "bspline", "bicubic"]
DTYPES = ["float32", "bfloat16"]
L = 2 * np.pi
NY, NX = 24, 40


def _rp(interp="bilinear", table_dtype="float32"):
    return trt.RayParams(f=3.0, Cg=1.0, x0=-L / 2, y0=-L / 3, dx=L / NX, dy=L / NY,
                         interp=interp, table_dtype=table_dtype)


def _inputs(interp, table_dtype, n=200, seed=4):
    """A pair table of random fields on an NY x NX grid and st (5, N) of
    packets over three periods, so base cells are negative and past the
    grid."""
    rng = np.random.default_rng(seed)
    nch = tops.n_channels(interp)
    fo, fn = (torch.as_tensor((rng.standard_normal((nch, NY, NX)) * 0.1).astype(np.float32))
              for _ in range(2))
    rp = _rp(interp, table_dtype)
    T_pair = trt.build_pair(fo, fn, rp)
    x = rng.uniform(-1.5 * L, 1.5 * L, n)
    y = rng.uniform(-1.5 * L, 1.5 * L, n)
    phase = rng.uniform(0, 2 * np.pi, n)
    sign = np.where(np.arange(n) % 2 == 0, -1.0, 1.0)
    st = torch.as_tensor(np.stack([x, y, 5.2 * np.cos(phase), 5.2 * np.sin(phase), sign])
                         .astype(np.float32))
    return T_pair, st, rp


@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("interp", INTERPS)
def test_table_substep_twin_is_gather_transpose_first_cut(interp, table_dtype):
    T_pair, st, rp = _inputs(interp, table_dtype)
    scal = torch.tensor([0.25, 0.02])
    rows, bx, by = trt._gather_patch_rows(T_pair, tpk.Packets(*st.unbind(0)), rp, NY, NX)
    rows_T, st7 = rows.t().contiguous(), torch.stack([*st.unbind(0), bx, by])
    assert all(torch.equal(a, b) for a, b in
               zip((rows_T, st7), tops.first_cut_inputs(T_pair, st, rp, NY, NX)))
    before = dict(tops.table_launches)
    out = tops.table_substep(T_pair, st, scal, rp=rp, interp=interp, da=0.5, ny=NY, nx=NX)
    ref = tops.fused_substep(rows_T, st7, scal, rp=rp, interp=interp, da=0.5)
    assert out.shape == (4, st.shape[1]) and out.dtype == torch.float32
    assert torch.equal(out, ref)
    assert torch.equal(out, tops.table_substep_torch(T_pair, st, scal, rp=rp, interp=interp,
                                                     da=0.5, ny=NY, nx=NX))
    assert tops.table_launches == before
    assert float((out[:2] - st[:2]).abs().max()) > 1e-3      # packets moved


@pytest.mark.parametrize("table_dtype", DTYPES)
@pytest.mark.parametrize("interp", INTERPS)
def test_table_attempt_twin_is_gather_transpose_first_cut(interp, table_dtype):
    T_pair, st, rp = _inputs(interp, table_dtype)
    scal = torch.tensor([0.25, 0.5, 0.02, 1e-3, 1e-6])
    rows, bx, by = trt._gather_patch_rows(T_pair, tpk.Packets(*st.unbind(0)), rp, NY, NX)
    rows_T, st7 = rows.t().contiguous(), torch.stack([*st.unbind(0), bx, by])
    assert all(torch.equal(a, b) for a, b in
               zip((rows_T, st7), tops.first_cut_inputs(T_pair, st, rp, NY, NX)))
    before = dict(tops.table_attempt_launches)
    out = tops.table_attempt(T_pair, st, scal, rp=rp, interp=interp, ny=NY, nx=NX)
    ref = tops.fused_attempt(rows_T, st7, scal, rp=rp, interp=interp)
    assert out.shape == (5, st.shape[1]) and out.dtype == torch.float32
    assert torch.equal(out, ref)
    assert torch.equal(out, tops.table_attempt_torch(T_pair, st, scal, rp=rp, interp=interp,
                                                     ny=NY, nx=NX))
    assert tops.table_attempt_launches == before
    assert float(out[4].max()) > 0


def _cell_points(x0, dx, n_cells, seed):
    """float32 positions: random over several periods (negative ones
    included), the faces k dx from x0 rounded to float32 and their
    neighbours one ulp either side, and x0 one ulp below."""
    rng = np.random.default_rng(seed)
    k = np.arange(-3 * n_cells, 3 * n_cells + 1)
    faces = (x0 + k * dx).astype(np.float32)
    x0f = np.float32(x0)
    return np.concatenate([
        rng.uniform(-4 * n_cells * dx, 4 * n_cells * dx, 3000).astype(np.float32),
        faces, np.nextafter(faces, np.float32(-np.inf)), np.nextafter(faces, np.float32(np.inf)),
        [np.nextafter(x0f, np.float32(-np.inf)), x0f, np.nextafter(x0f, np.float32(np.inf))],
    ]).astype(np.float32)


@pytest.mark.parametrize("x0,y0,dx,dy", [
    (-L / 2, -L / 3, L / NX, L / NY),       # origin and cell sizes not representable
    (-4.0, 1.5, 0.125, 0.25),               # every face exactly representable
    (0.3, -0.7, 0.1, 0.3),
])
def test_cell_index_matches_formula_and_jax(x0, y0, dx, dy):
    """bx, by and the row the twin gathers against numpy's float32 formula
    (the kernels': x - x0 and the division each rounded once) and the JAX
    package's ``_gather_patch_rows``. The table's row r holds r, so the
    gathered row names the cell."""
    x = _cell_points(x0, dx, NX, 1)
    y = _cell_points(y0, dy, NY, 2)
    y = np.resize(y, x.size)[np.random.default_rng(3).permutation(x.size)]
    n = x.size
    zeros = np.zeros(n, np.float32)
    table = np.repeat(np.arange(NY * NX, dtype=np.float32)[:, None], 8, axis=1)
    rp_t = trt.RayParams(f=3.0, Cg=1.0, x0=x0, y0=y0, dx=dx, dy=dy)
    rp_j = jrt.RayParams(f=3.0, Cg=1.0, x0=x0, y0=y0, dx=dx, dy=dy)
    rows_t, bx_t, by_t = trt._gather_patch_rows(
        torch.as_tensor(table), tpk.Packets(*(torch.as_tensor(a) for a in (x, y, zeros, zeros,
                                                                            zeros))),
        rp_t, NY, NX)
    rows_j, bx_j, by_j = jrt._gather_patch_rows(
        jnp.asarray(table), jpk.Packets(*(jnp.asarray(a) for a in (x, y, zeros, zeros, zeros))),
        rp_j, NY, NX)
    bx = np.floor((x - np.float32(x0)) / np.float32(dx))
    by = np.floor((y - np.float32(y0)) / np.float32(dy))
    cell = np.remainder(by.astype(np.int64), NY) * NX + np.remainder(bx.astype(np.int64), NX)
    assert bx.dtype == np.float32
    np.testing.assert_array_equal(bx_t.numpy(), bx)
    np.testing.assert_array_equal(by_t.numpy(), by)
    np.testing.assert_array_equal(rows_t[:, 0].numpy(), cell.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(bx_j), bx)
    np.testing.assert_array_equal(np.asarray(by_j), by)
    np.testing.assert_array_equal(np.asarray(rows_j)[:, 0], cell.astype(np.float32))
    assert (bx < 0).any() and (bx >= NX).any() and (by < 0).any() and (by >= NY).any()


def _bad_cases():
    """(case, mutation of (T_pair, st, scal), expected error, message)."""
    return {
        "table dtype": (lambda T, st, sc: (T.double(), st, sc), TypeError, "float32 or bfloat16"),
        "st dtype": (lambda T, st, sc: (T, st.half(), sc), TypeError, "float32"),
        "width": (lambda T, st, sc: (T[:, :-8].contiguous(), st, sc), ValueError, "shape"),
        "row count": (lambda T, st, sc: (T[:-1], st, sc), ValueError, "shape"),
        "st rows": (lambda T, st, sc: (T, torch.cat([st, st[:2]]), sc), ValueError, "shape"),
        "contiguity": (lambda T, st, sc: (T.t().contiguous().t(), st, sc), ValueError,
                       "contiguous"),
        "device": (lambda T, st, sc: (T, st.to("meta"), sc), ValueError, "is on"),
        "no CPU or CUDA": (lambda T, st, sc: (T.to("meta"), st.to("meta"), sc.to("meta")),
                           RuntimeError, "CPU or CUDA"),
    }


@pytest.mark.parametrize("case", list(_bad_cases()))
@pytest.mark.parametrize("kind", ["substep", "attempt"])
def test_table_wrappers_refuse_bad_inputs(kind, case):
    T_pair, st, rp = _inputs("bilinear", "bfloat16", n=64)
    mutate, err, match = _bad_cases()[case]
    if kind == "substep":
        T2, st2, sc2 = mutate(T_pair, st, torch.tensor([0.0, 0.01]))
        call = lambda: tops.table_substep(T2, st2, sc2, rp=rp, interp="bilinear", da=1.0,  # noqa: E731
                                          ny=NY, nx=NX)
    else:
        T2, st2, sc2 = mutate(T_pair, st, torch.tensor([0.0, 1.0, 0.01, 1e-3, 1e-6]))
        call = lambda: tops.table_attempt(T2, st2, sc2, rp=rp, interp="bilinear",  # noqa: E731
                                          ny=NY, nx=NX)
    with pytest.raises(err, match=match):
        call()


def test_table_wrappers_refuse_interp_and_grid():
    T_pair, st, rp = _inputs("bilinear", "float32", n=16)
    scal = torch.tensor([0.0, 0.01])
    with pytest.raises(ValueError, match="available"):
        tops.table_substep(T_pair, st, scal, rp=rp, interp="cubic", da=1.0, ny=NY, nx=NX)
    # a bspline row is wider than a bilinear one
    with pytest.raises(ValueError, match="shape"):
        tops.table_substep(T_pair, st, scal, rp=rp, interp="bspline", da=1.0, ny=NY, nx=NX)
    with pytest.raises(ValueError, match="shape"):
        tops.table_substep(T_pair, st, scal, rp=rp, interp="bilinear", da=1.0, ny=NX, nx=NX)


def test_ray_paths_call_the_table_kernels(monkeypatch):
    """raytrace_tables (RK4) and the fused adaptive attempt hand the pair
    table and st (5, N) to the table wrappers, one call per substep and per
    attempt."""
    T_pair, st, rp = _inputs("bilinear", "bfloat16", n=32)
    seen = []
    for name in ("table_substep", "table_attempt"):
        real = getattr(trt, name)

        def spy(T, s, *args, _real=real, _name=name, **kw):
            seen.append((_name, tuple(T.shape), T.dtype, tuple(s.shape)))
            return _real(T, s, *args, **kw)
        monkeypatch.setattr(trt, name, spy)
    p = tpk.Packets(*st.unbind(0))
    trt.raytrace_tables(p, T_pair, 0.0, 0.02, rp, NY, NX, nsubsteps=2)
    assert seen == [("table_substep", (NY * NX, 160), torch.bfloat16, (5, 32))] * 2
    seen.clear()
    fields = [torch.as_tensor(np.random.default_rng(s).standard_normal((5, NY, NX))
                              .astype(np.float32) * 0.1) for s in (1, 2)]
    _, info = trt.raytrace_adaptive(p, *fields, 0.0, 0.02, rp, max_steps=4, init_substeps=1,
                                    loop="while")
    attempts = int(info["n_accepted"]) + int(info["n_rejected"])
    assert attempts >= 1
    assert seen == [("table_attempt", (NY * NX, 160), torch.bfloat16, (5, 32))] * attempts
