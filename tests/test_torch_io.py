"""The port's rolling HDF5 outputs and checkpoints on the CPU, against the
JAX package: the writer/reader round trip with rolling, ``save_problem``'s
header, checkpoints that restore in either package and the runs that go on
from them, bit-exact resume, and the refusal of a mismatched checkpoint;
the JLD2-shaped files (``io/jld2``, ``io/jld2_fixture``) written by either
package and read by both, ``utils/twolayer_helpers``, and ``io/collated``'s
rolling entries written by either package and read by the other.

Runs after a restore are held to ``test_torch_driver._assert_states_match``
(the flow state to 2e-6 of its largest mode, packets to 1e-5 with float32
tables).
"""
import os

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.io import checkpoint as jck  # noqa: E402
from juliaraytracingsw_tpu.io import jld2 as jjld2  # noqa: E402
from juliaraytracingsw_tpu.io import jld2_fixture as jfix  # noqa: E402
from juliaraytracingsw_tpu.io import output as jout  # noqa: E402
from juliaraytracingsw_tpu.models import rsw as jrsw  # noqa: E402
from juliaraytracingsw_tpu.models import swqg as jswqg  # noqa: E402
from juliaraytracingsw_tpu.models import twolayerqg as j2l  # noqa: E402
from juliaraytracingsw_tpu.utils import twolayer_helpers as jh  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled import driver as tdrv  # noqa: E402
from juliaraytracingsw_tpu_torch.io import checkpoint as tck  # noqa: E402
from juliaraytracingsw_tpu_torch.io import jld2 as tjld2  # noqa: E402
from juliaraytracingsw_tpu_torch.io import jld2_fixture as tfix  # noqa: E402
from juliaraytracingsw_tpu_torch.io import output as tout  # noqa: E402
from juliaraytracingsw_tpu_torch.models import rsw as trsw  # noqa: E402
from juliaraytracingsw_tpu_torch.models import swqg as tswqg  # noqa: E402
from juliaraytracingsw_tpu_torch.models import twolayerqg as t2l  # noqa: E402
from juliaraytracingsw_tpu_torch.rays import packets as tpk  # noqa: E402
from juliaraytracingsw_tpu_torch.utils import twolayer_helpers as th  # noqa: E402
from test_torch_driver import DT, _assert_states_match, _drivers  # noqa: E402

JAX_TREEPATHS = [".sol", ".clock.t", ".clock.step", ".stepper_state.N1",
                 ".stepper_state.N2", ".packets.x", ".packets.y", ".packets.k",
                 ".packets.l", ".packets.sign", ".fields"]


def _datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_writer_reader_round_trip_rolls(tmp_path):
    """Frames of CPU tensors roll into a new file every max_writes frames;
    both packages' readers read them back unchanged."""
    rng = np.random.default_rng(3)
    base, pbase = str(tmp_path / "run" / "rsw"), str(tmp_path / "run" / "packets")
    sols = {s: (rng.standard_normal((3, 8, 5)) + 1j * rng.standard_normal((3, 8, 5)))
            .astype(np.complex64) for s in (0, 4, 8, 12, 16)}
    packets = {s: rng.standard_normal((7, 2)).astype(np.float32) for s in sols}
    with tout.SequencedWriter(base, max_writes=2) as w, \
            tout.SequencedWriter(pbase, max_writes=3) as pw:
        w.write("grid/nx", 8)
        for s, sol in sols.items():
            w.write_frame(s, sol=torch.as_tensor(sol))
            w.write(f"snapshots/t/{s}", 0.5 * s)
            pw.write_packets(s, 0.5 * s, x=torch.as_tensor(packets[s]), k=packets[s] + 1)
    assert sorted(os.listdir(tmp_path / "run")) == sorted(
        [f"rsw.{i:06d}.h5" for i in range(3)] + [f"packets.{i:06d}.h5" for i in range(2)])
    for mod in (tout, jout):
        r = mod.SequencedReader(base)
        assert r.steps() == sorted(sols) and r.count() == 5
        assert r.read("grid/nx") == 8
        for s, sol in sols.items():
            np.testing.assert_array_equal(r.load(s), sol)
            assert r.read(f"snapshots/t/{s}") == 0.5 * s
        assert r.map(lambda s, a: (s, a.shape)) == [(s, (3, 8, 5)) for s in sorted(sols)]
        assert r.mapreduce(lambda s, a: s, lambda acc, v: acc + v, 0) == sum(sols)
        assert [s for s, _ in r.mapfilter(lambda s, a: (s, a), lambda s: s > 6)] == [8, 12, 16]
        assert r.params() == {"grid/nx": 8}
        pr = mod.SequencedReader(pbase)
        assert pr.packet_times() == [(s, 0.5 * s) for s in sorted(sols)]
        step, frame = pr.final_packet_frame()
        assert step == 16 and frame["t"] == 8.0
        np.testing.assert_array_equal(frame["x"], packets[16])
        np.testing.assert_array_equal(frame["k"], packets[16] + 1)


@pytest.mark.parametrize("model", ["rsw", "swqg"])
def test_save_problem_matches_jax(tmp_path, model):
    """The header holds the same keys, values and dtypes as the JAX
    package's for the same grid and parameters."""
    mods = ((jmake_grid, jrsw if model == "rsw" else jswqg, jout, {}),
            (tmake_grid, trsw if model == "rsw" else tswqg, tout, {"device": "cpu"}))
    files = []
    for i, (mk, mod, out, kw) in enumerate(mods):
        grid = mk(32, Lx=3.0, **kw)
        params = mod.make_model(grid, nu=1e-9, nnu=4, f=3.0, Cg=1.5).params
        w = out.SequencedWriter(str(tmp_path / f"p{i}"))
        out.save_problem(w, grid, params, 2.5e-3, extra={"params/extra": 7})
        w.close()
        files.append(_datasets(str(tmp_path / f"p{i}.000000.h5")))
    jd, td = files
    assert sorted(td) == sorted(jd)
    assert {"grid/nx", "grid/Lx", "clock/dt", "params/nu", "params/extra"} <= set(td)
    for key in jd:
        assert np.asarray(td[key]).dtype == np.asarray(jd[key]).dtype, key
        np.testing.assert_array_equal(td[key], jd[key], err_msg=key)


def _leaves_equal(a, b):
    for (pa, la), (pb, lb) in zip(tck._flatten(a), tck._flatten(b), strict=True):
        assert pa == pb
        if isinstance(la, torch.Tensor):
            assert la.dtype == lb.dtype and la.device == lb.device, pa
            assert torch.equal(la, lb), pa
        else:
            assert la == lb, pa


def test_checkpoint_layout_is_the_reference(tmp_path):
    """The port writes the leaves and key paths the JAX package writes for
    a SimState: complex64, float32, 0-d int32 and float32 x 7."""
    _, dt_ = _drivers()
    dt_.run(n_frames=1, flow_steps_per_frame=2)
    dt_.checkpoint(str(tmp_path / "ck.npz"))
    with np.load(tmp_path / "ck.npz") as d:
        assert bytes(d["__treepaths__"]).decode().split("\n") == JAX_TREEPATHS
        assert "__treedef__" not in d.files
        dtypes = [d[f"leaf_{i}"].dtype for i in range(len(JAX_TREEPATHS))]
        assert d["leaf_2"].shape == () and int(d["leaf_2"]) == 2
    assert dtypes == [np.complex64, np.float32, np.int32] + [np.complex64] * 2 + [np.float32] * 6


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_in_the_other_package(tmp_path, writer):
    """A checkpoint written by either package restores in the other; the
    states agree after the restore and after 2 more frames in both."""
    dj, dt_ = _drivers(nx=32)
    src = dj if writer == "jax" else dt_
    src.spinup(3)
    src.run(n_frames=1, flow_steps_per_frame=3)
    path = str(tmp_path / "ck.npz")
    src.checkpoint(path)
    dst = dt_ if writer == "jax" else dj
    dst.restore(path)
    if writer == "jax":
        assert dt_.sim.clock.step == 6 and isinstance(dt_.sim.clock.step, int)
        assert dt_.sim.sol.device.type == "cpu" and dt_.sim.sol.dtype == torch.complex64
    _assert_states_match(dt_.sim, dj.sim)
    for d in (dj, dt_):
        d.run(n_frames=2, flow_steps_per_frame=3)
    assert dt_.sim.clock.step == 12
    _assert_states_match(dt_.sim, dj.sim)


def test_resume_is_bit_exact(tmp_path):
    """Checkpoint after 2 frames, run 2 more; a fresh driver restored from
    the checkpoint runs the same 2 frames to the same bits."""
    _, a = _drivers(nx=32)
    a.spinup(4)
    a.run(n_frames=2, flow_steps_per_frame=3)
    a.checkpoint(str(tmp_path / "ck.npz"))
    a.run(n_frames=2, flow_steps_per_frame=3)
    _, b = _drivers(nx=32)
    b.restore(str(tmp_path / "ck.npz"))
    b.run(n_frames=2, flow_steps_per_frame=3)
    _leaves_equal(b.sim, a.sim)
    assert b.sim.clock.step == 16


def _mismatch(case, tmp_path, sim):
    path = str(tmp_path / "bad.npz")
    if case == "structure":
        tck.save_checkpoint(path, {"sol": sim.sol, "t": sim.clock.t})
        return path, "structure does not match"
    if case == "shape":
        small = sim._replace(packets=tpk.lattice_packets(2, 1.0, 1.0, 1.0, device="cpu"))
        tck.save_checkpoint(path, small)
        return path, "leaf 5 shape"
    if case == "leaf count":
        tck.save_checkpoint(path, sim)
        with np.load(path) as d:
            arrays = {k: d[k] for k in d.files if k != "leaf_10"}
        np.savez(path, **arrays)
        return path, "has 10 leaves, running state has 11"
    tck.save_checkpoint(path, sim)
    with np.load(path) as d:
        arrays = {k: d[k] for k in d.files if k != "__treepaths__"}
    np.savez(path, **arrays)
    return path, "no __treepaths__"


@pytest.mark.parametrize("case", ["structure", "shape", "leaf count", "no paths"])
def test_restore_rejects_mismatched_checkpoint(tmp_path, case):
    _, drv = _drivers(nx=16)
    path, msg = _mismatch(case, tmp_path, drv.sim)
    with pytest.raises(ValueError, match=msg):
        drv.restore(path)


def test_jax_restore_rejects_mismatched_port_checkpoint(tmp_path):
    """The port's file carries the key paths the reference checks."""
    dj, dt_ = _drivers(nx=16)
    small = dt_.sim._replace(packets=tpk.lattice_packets(2, 1.0, 1.0, 1.0, device="cpu"))
    path = str(tmp_path / "small.npz")
    tck.save_checkpoint(path, small)
    with pytest.raises(ValueError, match="leaf 5 shape"):
        jck.load_checkpoint(path, dj.sim)
    tck.save_checkpoint(path, {"sol": dt_.sim.sol})
    with pytest.raises(ValueError, match="structure does not match"):
        jck.load_checkpoint(path, dj.sim)


def test_restore_needs_init():
    _, t = _drivers(nx=16)
    drv = tdrv.CoupledDriver(model=t.model, psih_fn=t.psih_fn, rp=t.rp, dt=DT,
                             log_fn=lambda s: None)
    with pytest.raises(RuntimeError, match="init"):
        drv.restore("unused.npz")


def _twolayer_fixture(writer, path, rng):
    psih = (rng.standard_normal((2, 16, 9)) + 1j * rng.standard_normal((2, 16, 9))).astype(
        np.complex64)
    writer.write_twolayer_ic(path, psih, dt=2.5e-3, t=1.25, step=7, f0=3.0, b=(1.0, 0.8),
                             U=(0.2, -0.2), mu=0.05)
    return psih


@pytest.mark.parametrize("direction", ["jax-writes", "port-writes"])
def test_jld2_twolayer_ic_across_packages(tmp_path, direction):
    """The reference's two-layer IC layout written by one package reads
    the same in both: psih, t, the params struct (unicode field names),
    dt, the key list."""
    path = str(tmp_path / "ic.h5")
    psih = _twolayer_fixture(jfix if direction == "jax-writes" else tfix, path,
                             np.random.default_rng(4))
    got, want = tjld2.load_twolayer_ic(path), jjld2.load_twolayer_ic(path)
    np.testing.assert_array_equal(got[0], psih)
    np.testing.assert_array_equal(want[0], psih)
    assert got[1] == want[1] == 1.25 and got[3] == want[3] == 2.5e-3
    assert sorted(got[2]) == sorted(want[2]) == sorted(["f₀", "β", "b", "H", "U", "μ"])
    for key in want[2]:
        np.testing.assert_array_equal(got[2][key], want[2][key])
    assert tjld2.list_keys(path) == jjld2.list_keys(path)
    assert tjld2.load_scalar(path, "clock/dt") == 2.5e-3
    with h5py.File(path, "r") as f:
        assert f["_types/00000001"].attrs["julia_type"] == "Core.Complex{Core.Float32}"


def test_jld2_fixture_across_packages(tmp_path):
    """``write_jld2_fixture`` of either package: Julia-ordered (reversed)
    real and complex arrays and scalars, the same file read back by both
    readers."""

    rng = np.random.default_rng(6)
    data = {"a/real": rng.standard_normal((3, 5)),
            "a/complex": (rng.standard_normal((4, 3)) + 1j * rng.standard_normal((4, 3))),
            "scalar": 2.5}
    for name, mod in (("j.h5", jfix), ("t.h5", tfix)):
        mod.write_jld2_fixture(str(tmp_path / name), data)
    for key, want in data.items():
        for name in ("j.h5", "t.h5"):
            path = str(tmp_path / name)
            got = tjld2.load_array(path, key)
            np.testing.assert_array_equal(got, jjld2.load_array(path, key))
            np.testing.assert_array_equal(got, np.asarray(want).T if np.ndim(want) > 1
                                          else want)
    assert _datasets(str(tmp_path / "j.h5")).keys() == _datasets(str(tmp_path / "t.h5")).keys()


def test_twolayer_helpers_match_jax(tmp_path):
    """``load_two_layer_state`` (an IC file's psih to the PV state) and the
    Thompson-Young scalings against the JAX package's."""
    path = str(tmp_path / "ic.h5")
    psih = _twolayer_fixture(jfix, path, np.random.default_rng(5))
    with h5py.File(path, "a") as f:
        f["ic/psih"] = psih
    jg, tg = jmake_grid(16), tmake_grid(16, device="cpu")
    mj, mt = j2l.make_model(jg), t2l.make_model(tg)
    got = th.load_two_layer_state(path, tg, mt.params)
    want = j2l.pv_from_streamfunction(jnp.asarray(psih), jg, mj.params)
    assert got.device.type == "cpu" and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    for U, lam, mu in ((0.2, 0.3, 0.05), (1.0, 1.0, 0.5)):
        assert th.thompson_young_scales(U, lam, mu) == jh.thompson_young_scales(U, lam, mu)
        assert th.mu_from_target_scale(8.0, U, lam) == jh.mu_from_target_scale(8.0, U, lam)
    lines_t, lines_j = [], []
    th.display_energetics(0.1, 0.2, 0.2, 0.3, 0.05, log=lines_t.append)
    jh.display_energetics(0.1, 0.2, 0.2, 0.3, 0.05, log=lines_j.append)
    assert lines_t == lines_j


@pytest.mark.parametrize("writer_pkg", ["torch", "jax"])
def test_collated_round_trip_across_packages(tmp_path, writer_pkg):
    """``io/collated``: entries written by one package's ``CollatedWriter``
    roll over every ``max_lines`` entries and read back in order through
    the other package's ``map_input``."""
    from juliaraytracingsw_tpu.io import collated as jcol
    from juliaraytracingsw_tpu_torch.io import collated as tcol

    write, read = (tcol, jcol) if writer_pkg == "torch" else (jcol, tcol)
    base = str(tmp_path / "rows" / "p")
    rng = np.random.default_rng(3)
    rows = {f"x/{i}": rng.normal(size=(4, 2)).astype(np.float32) for i in range(7)}
    with write.CollatedWriter(base, max_lines=3) as w:
        for key, val in rows.items():
            w.append(key, val)
    assert sorted(os.listdir(tmp_path / "rows")) == [f"p_{i:08d}.h5" for i in range(3)]
    got = read.map_input(base, lambda key, val: (key, val))
    assert [k for k, _ in got] == list(rows)
    for key, val in got:
        np.testing.assert_array_equal(val, rows[key])
    assert tcol.map_input(str(tmp_path / "none"), lambda k, v: k) == []
