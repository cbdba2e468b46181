"""The port's omega-k chain against the JAX package's on the CPU.

One 64^2 RSW run and one 64^2 Thomas-Yamada run, written by the JAX
command line, are analysed by both command lines:

- ``omega-k`` (the wave/balanced decomposition, ``--no-decompose``,
  ``--stft-window``, ``--model ty``): every per-k file, every dataset
  within 1e-5 of its largest value (the eigenbases come from each
  package's float32 model code; the rest is the same numpy);
  ``--mem-cap-gb`` sub-blocks and ``--fanout`` processes give the files of
  one serial pass;
- ``omega-k-plot``: ``omega_k_radial.h5`` within 1e-5 and the heatmaps;
- ``b-parameter``: ``b_parameter.h5`` within 1e-5.

Also the port's copies of the numpy analysis functions against the JAX
package's on the same arrays.
"""
import glob
import os

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu.analysis import b_parameter as jbp  # noqa: E402
from juliaraytracingsw_tpu.analysis import omega_k as jok  # noqa: E402
from juliaraytracingsw_tpu.experiments.__main__ import main as jmain  # noqa: E402
from juliaraytracingsw_tpu_torch.analysis import b_parameter as tbp  # noqa: E402
from juliaraytracingsw_tpu_torch.analysis import omega_k as tok  # noqa: E402
from juliaraytracingsw_tpu_torch.experiments import __main__ as tcli  # noqa: E402

TOL = 1e-5


def _quiet(_line):
    pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{model: run dir} of a 64^2 RSW run (13 snapshots) and a 64^2
    Thomas-Yamada run (10 main-phase snapshots), by the JAX command line."""
    root = tmp_path_factory.mktemp("omega_k_runs")
    jmain(["rsw", "--nx", "64", "--sqrt-npackets", "2", "--seed", "42", "--ag", "0.5",
           "--aw", "0.05", "--spinup-T", "0", "--T", "0.12", "--output-dt", "0.01",
           "--out-dir", str(root / "rsw")])
    jmain(["thomasyamada", "--nx", "64", "--ty-dt", "0.01", "--startup-T", "0.05", "--T", "0.2",
           "--output-dt", "0.02", "--seed", "4", "--out-dir", str(root / "ty")])
    return {"rsw": str(root / "rsw"), "ty": str(root / "ty")}


def _files(out_dir, pattern="*.h5"):
    out = {}
    for path in sorted(glob.glob(os.path.join(out_dir, pattern))):
        data = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda n, o: data.__setitem__(n, o[()])
                         if isinstance(o, h5py.Dataset) else None)
        out[os.path.basename(path)] = data
    return out


def _assert_files_match(tdir, jdir, pattern="*.h5", tol=TOL):
    td, jd = _files(tdir, pattern), _files(jdir, pattern)
    assert td and sorted(td) == sorted(jd)
    for name, data in jd.items():
        assert sorted(td[name]) == sorted(data), name
        for key, want in data.items():
            got = np.asarray(td[name][key])
            assert got.shape == np.shape(want), (name, key)
            scale = max(np.abs(want).max(), 1e-30)
            assert np.abs(got - want).max() <= tol * scale, (name, key)
    return td


@pytest.mark.parametrize("model,extra", [
    ("rsw", []),
    ("rsw", ["--no-decompose"]),
    ("rsw", ["--stft-window", "6"]),
    ("ty", ["--base", "ty", "--stft-window", "4"]),
], ids=["decompose", "no-decompose", "stft", "ty"])
def test_omega_k_matches_jax(runs, tmp_path, model, extra):
    argv = ["omega-k", runs[model], "--model", model] + extra
    jmain(argv + ["--out-dir", str(tmp_path / "jax")])
    lines = []
    written = tcli.run(argv + ["--out-dir", str(tmp_path / "torch"), "--platform", "cpu"],
                       log_fn=lines.append)
    td = _assert_files_match(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert len(written) == len(td) == 33 and lines[-1].startswith("wrote 33 per-k files")
    names = set(td["radial_data_k=005.h5"])
    want = {"rsw": {"c0", "cp", "cm", "psit"}, "ty": {"U_wave", "U_total", "ug", "uw"}}[model]
    assert (want if "--no-decompose" not in extra else {"sol"}) <= names
    if "--stft-window" in extra:
        assert "stft/centers" in names


def test_omega_k_sub_blocks_and_fanout_give_one_pass(runs, tmp_path):
    """``--mem-cap-gb`` small enough for 33 sub-blocks, and ``--fanout 2``
    (two omega-k processes of the port on the CPU): the serial pass's
    files."""
    base = ["omega-k", runs["rsw"], "--platform", "cpu"]
    tcli.run(base + ["--out-dir", str(tmp_path / "one")], log_fn=_quiet)
    lines = []
    tcli.run(base + ["--out-dir", str(tmp_path / "cap"), "--mem-cap-gb", "1e-5"],
             log_fn=lines.append)
    assert "33 sub-blocks" in lines[1]
    tcli.run(base + ["--out-dir", str(tmp_path / "fan"), "--fanout", "2"], log_fn=_quiet)
    for other in ("cap", "fan"):
        _assert_files_match(str(tmp_path / other), str(tmp_path / "one"),
                            "radial_data_k=*.h5", tol=1e-12)


def test_omega_k_plot_and_b_parameter_match_jax(runs, tmp_path):
    """The per-k files (the JAX command line's) assembled into radial
    (omega, K) power and the b parameter by both command lines."""
    jmain(["omega-k", runs["rsw"], "--out-dir", str(tmp_path / "ok")])
    for pkg, run in (("jax", jmain), ("torch", tcli.run)):
        out = str(tmp_path / pkg)
        kw = {} if pkg == "jax" else dict(log_fn=_quiet)
        run(["omega-k-plot", runs["rsw"], "--omega-dir", str(tmp_path / "ok"), "--out-dir",
             out], **kw)
    td = _assert_files_match(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert set(td["omega_k_radial.h5"]) == {"omega", "K", "c0", "cp", "cm"}
    for name in ("c0", "cp", "cm"):
        assert (tmp_path / "torch" / f"omega_k_{name}.png").stat().st_size > 0
    jmain(["b-parameter", runs["rsw"], "--omega-dir", str(tmp_path / "ok"), "--n-points", "40"])
    with h5py.File(tmp_path / "ok" / "b_parameter.h5", "r") as f:
        want = {k: f[k][()] for k in f}
    b = tcli.run(["b-parameter", runs["rsw"], "--omega-dir", str(tmp_path / "ok"),
                  "--n-points", "40"], log_fn=_quiet)
    with h5py.File(tmp_path / "ok" / "b_parameter.h5", "r") as f:
        got = {k: f[k][()] for k in f}
    assert sorted(got) == ["D11", "Kd", "b", "k"] and np.isfinite(b) and b != 0
    for key, val in want.items():
        np.testing.assert_allclose(got[key], val, rtol=TOL, err_msg=key)


def test_b_parameter_needs_psit_rows(runs, tmp_path):
    tcli.run(["omega-k", runs["rsw"], "--no-decompose", "--out-dir", str(tmp_path),
              "--platform", "cpu"], log_fn=_quiet)
    with pytest.raises(SystemExit, match="no psit rows"):
        tcli.run(["b-parameter", runs["rsw"], "--omega-dir", str(tmp_path)], log_fn=_quiet)


def test_numpy_analysis_copies_match_jax():
    """``hann``, ``detrend``, ``clean_fft``, ``omega_k_spectrum``,
    ``stft_omega_k`` and ``fit_b`` of the port's copies on the same
    arrays as the JAX package's."""
    rng = np.random.default_rng(3)
    t = np.sort(rng.uniform(0, 10, 40))
    data = rng.normal(size=(40, 3, 5)) + 1j * rng.normal(size=(40, 3, 5))
    np.testing.assert_array_equal(tok.hann(17), jok.hann(17))
    np.testing.assert_array_equal(tok.detrend(t, data), jok.detrend(t, data))
    np.testing.assert_array_equal(tok.clean_fft(t, data), jok.clean_fft(t, data))
    (om_t, sp_t), (om_j, sp_j) = (m.omega_k_spectrum(t, {"a": data}) for m in (tok, jok))
    np.testing.assert_array_equal(om_t, om_j)
    np.testing.assert_array_equal(sp_t["a"], sp_j["a"])
    for a, b in zip(tok.stft_omega_k(t, data, 8), jok.stft_omega_k(t, data, 8)):
        np.testing.assert_array_equal(a, b)
    k = np.arange(1.0, 9.0)
    D = 0.3 * (k / 2.0) ** 2 + rng.normal(0, 1e-3, 8)
    assert tbp.fit_b(k, D, 2.0) == jbp.fit_b(k, D, 2.0)
