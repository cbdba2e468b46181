"""The port's command line on the CPU (``--platform cpu``), against the JAX
package's command line:

- ``rsw`` (``--ic band`` and ``--ic front``, ``--model`` linborg, modified
  and quadheight), ``swqg``, ``twolayer`` (with ``--baroclinic``,
  ``--nlayers 3``) and ``single-wave`` at 32^2 with 4 packets (2 for
  single-wave), the same seed through both: the same HDF5 files and keys,
  ``diagnostics.h5`` within rtol 1e-5, the last snapshot within 1e-5 of its
  largest mode, the packets within 1e-4 (two FFT libraries, float32;
  measured at most 1.1e-5 relative in the packets' velocities);
- ``thomasyamada`` at 32^2: its files and diagnostics within 1e-5;
- the ``twolayer-simulation`` -> ``twolayer --ic-file`` chain across the
  packages, and a two-layer checkpoint restored in the other package;
- the golden 128^2 ``rsw`` run and its ``analyze`` suite to
  ``tests/test_golden_run.py``'s values and tolerances;
- each subcommand and option that is not ported exits naming its ROADMAP
  item, and a run asked for the card where there is none names
  ``--platform cpu``.
"""
import glob
import os

import h5py
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu.experiments.__main__ import main as jmain  # noqa: E402
from juliaraytracingsw_tpu_torch.experiments import __main__ as tcli  # noqa: E402
from test_golden_run import (GOLDEN_KE, GOLDEN_KE_GEO, GOLDEN_KE_WAVE,  # noqa: E402
                             GOLDEN_PE, GOLDEN_T)

SMALL = ["--nx", "32", "--sqrt-npackets", "2", "--seed", "3", "--spinup-T", "0.03",
         "--T", "0.15", "--output-dt", "0.03", "--max-writes", "3"]


def _quiet(_line):
    pass


def _datasets(run_dir):
    """{file name: {dataset path: array}} of a run directory."""
    out = {}
    for path in sorted(glob.glob(os.path.join(run_dir, "*.h5"))):
        data = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda n, o: data.__setitem__(n, o[()])
                         if isinstance(o, h5py.Dataset) else None)
        out[os.path.basename(path)] = data
    return out


# id: (argv, the snapshot files' base)
COUPLED = {
    "rsw-band": (["rsw", "--ic", "band"], "rsw"),
    "rsw-front": (["rsw", "--ic", "front"], "rsw"),
    "swqg": (["swqg"], "swqg"),
    "rsw-linborg": (["rsw", "--model", "linborg"], "linborg"),
    "rsw-modified": (["rsw", "--model", "modified"], "modified"),
    "rsw-quadheight": (["rsw", "--model", "quadheight"], "quadheight"),
    "twolayer": (["twolayer"], "2Lqg"),
    "twolayer-baroclinic": (["twolayer", "--baroclinic"], "2Lqg"),
    "twolayer-3layers": (["twolayer", "--nlayers", "3"], "3Lqg"),
    "single-wave": (["single-wave"], "single_wave"),
}


@pytest.mark.parametrize("argv,base", list(COUPLED.values()), ids=list(COUPLED))
def test_cli_matches_jax(tmp_path, argv, base):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmain(argv + SMALL + ["--out-dir", jdir])
    drv = tcli.run(argv + SMALL + ["--out-dir", tdir, "--platform", "cpu"], log_fn=_quiet)
    assert drv.rp.gather == "taps"      # auto: 8 x 4 packets < 32^2 cells
    assert drv.sim.sol.device.type == "cpu"
    jd, td = _datasets(jdir), _datasets(tdir)
    assert sorted(td) == sorted(jd) == sorted(
        ["diagnostics.h5"] + [f"{b}.{i:06d}.h5" for b in (base, "packets") for i in range(2)])
    for name in jd:
        assert sorted(td[name]) == sorted(jd[name]), name
        for key, want in jd[name].items():
            assert np.asarray(td[name][key]).dtype == np.asarray(want).dtype, (name, key)
    for key, want in jd["diagnostics.h5"].items():
        np.testing.assert_allclose(td["diagnostics.h5"][key], want, rtol=1e-5, err_msg=key)
    last = max(int(k.rsplit("/", 1)[1]) for f in jd.values() for k in f
               if k.startswith("snapshots/sol/"))
    for name, data in jd.items():
        for key, want in data.items():
            got = td[name][key]
            if key == f"snapshots/sol/{last}":
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err < 1e-5, err
            elif key.startswith("p/") and key.split("/")[1] in "xkug":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=key)
            elif key.startswith(("grid/", "params/", "clock/", "p/t/", "snapshots/t/")):
                np.testing.assert_array_equal(got, want, err_msg=key)


def test_cli_checkpoint_restores_in_the_jax_cli(tmp_path):
    """``--checkpoint`` from the port's command line, ``--restore`` in the
    JAX package's: the run goes on."""
    ck = str(tmp_path / "ck.npz")
    tcli.run(["rsw"] + SMALL + ["--out-dir", str(tmp_path / "a"), "--platform", "cpu",
                                "--checkpoint", ck], log_fn=_quiet)
    jmain(["rsw"] + SMALL + ["--out-dir", str(tmp_path / "b"), "--restore", ck])
    with h5py.File(tmp_path / "b" / "diagnostics.h5", "r") as f:
        assert np.isfinite(f["kinetic_energy"][()]).all()
        # restored at t = 15 dt = 0.147, then spun up 3 steps and one frame
        # of 3 (a fresh run's first frame ends at t = 6 dt = 0.059)
        np.testing.assert_allclose(f["t"][0], 21 * 0.1 / 2 * (2 * np.pi / 32), rtol=1e-6)


def test_golden_run_and_analysis(tmp_path):
    """``tests/test_golden_run.py`` through the port's command line."""
    run = tmp_path / "run"
    tcli.run(["rsw", "--nx", "128", "--seed", "42", "--ag", "0.5",
              "--aw", "0.05", "--spinup-T", "0.05", "--T", "0.3",
              "--output-dt", "0.05", "--out-dir", str(run),
              "--sqrt-npackets", "8", "--platform", "cpu"], log_fn=_quiet)
    tcli.run(["analyze", str(run), "--platform", "cpu"], log_fn=_quiet)

    figs = run / "figures"
    with h5py.File(figs / "plot_data.h5", "r") as f:
        np.testing.assert_allclose(f["t"][()], GOLDEN_T, rtol=1e-5)
        np.testing.assert_allclose(f["e/KE"][()], GOLDEN_KE, rtol=2e-3)
        np.testing.assert_allclose(f["e/PE"][()], GOLDEN_PE, rtol=5e-3)
        np.testing.assert_allclose(f["e/KE_geo"][()], GOLDEN_KE_GEO, rtol=2e-3)
        np.testing.assert_allclose(f["e/KE_wave"][()], GOLDEN_KE_WAVE, rtol=5e-3)
    for name in ("energy_series.png", "radial_spectra.png",
                 "flux_integrals.png", "snapshots.png",
                 "packet_frequency_pdfs.png", "run.html"):
        assert (figs / name).exists(), name
    html = (figs / "run.html").read_text()
    assert "Ro" in html and "cdn" not in html.lower()


def test_analyze_many_runs(tmp_path):
    """Two run directories: one page each and the master index."""
    for name in ("a", "b"):
        tcli.run(["rsw"] + SMALL + ["--out-dir", str(tmp_path / name), "--platform", "cpu"],
                 log_fn=_quiet)
    lines = []
    reports = tcli.run(["analyze", str(tmp_path / "a"), str(tmp_path / "b"), "--platform",
                        "cpu", "--figures-dir", str(tmp_path / "figs")], log_fn=lines.append)
    assert [r.run_id for r in reports] == ["a", "b"]
    assert (tmp_path / "figs" / "index.html").exists()
    assert (tmp_path / "figs" / "a" / "a.html").exists()
    assert lines[-1].startswith("index: ")


@pytest.mark.parametrize("argv,item", [
    (["steady-raytracing"], "item 12"),
    (["sweep", "rsw", "table.csv"], "item 12"),
    (["omega-k", "run"], "item 12"),
    (["omega-k-plot", "run"], "item 12"),
    (["b-parameter", "run"], "item 12"),
    (["rsw", "--birth-death"], "item 5"),
    (["swqg", "--live", "2"], "item 12"),
    (["rsw", "--sharded"], "item 13"),
    (["swqg", "--distributed"], "item 13"),
    (["twolayer", "--sharded"], "item 13"),
    (["thomasyamada", "--sharded"], "item 13"),
    (["single-wave", "--birth-death"], "item 5"),
])
def test_unported_pieces_exit_naming_their_item(tmp_path, argv, item):
    with pytest.raises(SystemExit, match=f"not ported.*{item}") as exc:
        tcli.run(argv + (["--platform", "cpu", "--out-dir", str(tmp_path)]
                         if argv[0] not in tcli._UNPORTED_COMMANDS else []), log_fn=_quiet)
    assert exc.value.code not in (0, None)
    assert not os.listdir(tmp_path)


def test_no_card_names_platform_cpu(tmp_path, monkeypatch):
    """No fall-back to the CPU: without a card the run fails."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["rsw", "--out-dir", str(tmp_path)], ["analyze", str(tmp_path)]):
        with pytest.raises(SystemExit, match="--platform cpu"):
            tcli.run(argv, log_fn=_quiet)


TY_SMALL = ["thomasyamada", "--nx", "32", "--ty-dt", "0.01", "--startup-T", "0.2", "--T", "0.2",
            "--output-dt", "0.05", "--seed", "4"]


def test_thomasyamada_matches_jax(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmain(TY_SMALL + ["--out-dir", jdir])
    lines = []
    sol, clock, diags = tcli.run(TY_SMALL + ["--out-dir", tdir, "--platform", "cpu"],
                                 log_fn=lines.append)
    assert sol.device.type == "cpu" and clock.step == 24 and len(diags["t"]) == 8
    assert lines[-1].startswith("done: t=0.400 baroclinic KE=")
    jd, td = _datasets(jdir), _datasets(tdir)
    assert sorted(td) == sorted(jd) == ["diagnostics.h5", "startup.000000.h5", "ty.000000.h5"]
    for name, data in jd.items():
        assert sorted(td[name]) == sorted(data), name
        for key, want in data.items():
            got = td[name][key]
            assert np.asarray(got).dtype == np.asarray(want).dtype, (name, key)
            if key.startswith("snapshots/sol/") or name == "diagnostics.h5":
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err < 1e-5, (name, key, err)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{name} {key}")


def test_twolayer_simulation_to_ic_file_chain(tmp_path):
    """Each package's ``twolayer-simulation`` writes the same file; each
    package's ``twolayer --ic-file`` reads the other's, adopts its dt, t0,
    U and mu, and the two runs agree."""
    sim = ["twolayer-simulation", "--nx", "32", "--T", "0.2", "--seed", "5"]
    jmain(sim + ["--out-dir", str(tmp_path / "sj")])
    lines = []
    path = tcli.run(sim + ["--out-dir", str(tmp_path / "st"), "--platform", "cpu"],
                    log_fn=lines.append)
    assert lines[-1] == f"wrote {path}"
    jpath = str(tmp_path / "sj" / os.path.basename(path))
    fj, ft = _datasets(str(tmp_path / "sj")), _datasets(str(tmp_path / "st"))
    name = os.path.basename(path)
    assert sorted(ft[name]) == sorted(fj[name])
    for key, want in fj[name].items():
        got = ft[name][key]
        if key.startswith(("ic/", "snapshots/ψh/")):
            got, want = (np.asarray(a) if a.dtype.names is None else a["re"] + 1j * a["im"]
                         for a in (np.asarray(got), np.asarray(want)))
            # 20 steps through two FFT libraries; psi = S^-1 q carries q's
            # error at the largest scales (measured: q 5.4e-7, psi 1.1e-5)
            tol = 1e-5 if key == "ic/qh" else 1e-4
            assert np.abs(got - want).max() < tol * np.abs(want).max(), key
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)
    jout, tout = str(tmp_path / "rj"), str(tmp_path / "rt")
    jmain(["twolayer", "--ic-file", path] + SMALL + ["--out-dir", jout])
    drv = tcli.run(["twolayer", "--ic-file", jpath] + SMALL + ["--out-dir", tout,
                                                               "--platform", "cpu"],
                   log_fn=_quiet)
    t0 = 20 * 0.1 / 2 * (2 * np.pi / 32)      # the simulation's 20 steps
    assert drv.dt == pytest.approx(0.1 / 2 * (2 * np.pi / 32))
    with h5py.File(os.path.join(jout, "diagnostics.h5"), "r") as fj_, \
            h5py.File(os.path.join(tout, "diagnostics.h5"), "r") as ft_:
        np.testing.assert_allclose(ft_["t"][()], fj_["t"][()], rtol=1e-6)
        assert ft_["t"][0] == pytest.approx(t0 + 6 * drv.dt, rel=1e-5)
        for key in ("kinetic_energy", "potential_energy"):
            assert ft_[key].shape == fj_[key].shape
            np.testing.assert_allclose(ft_[key][()], fj_[key][()], rtol=1e-5, err_msg=key)


def test_twolayer_checkpoint_restores_across_packages(tmp_path):
    """A two-layer run's checkpoint from the JAX command line restores in
    the port's and in the JAX one, and the two restored runs agree; the
    port's checkpoint restores in the JAX command line."""
    ck_j, ck_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jmain(["twolayer"] + SMALL + ["--out-dir", str(tmp_path / "a"), "--checkpoint", ck_j])
    tcli.run(["twolayer"] + SMALL + ["--out-dir", str(tmp_path / "b"), "--platform", "cpu",
                                     "--checkpoint", ck_t], log_fn=_quiet)
    jmain(["twolayer"] + SMALL + ["--out-dir", str(tmp_path / "c"), "--restore", ck_j])
    tcli.run(["twolayer"] + SMALL + ["--out-dir", str(tmp_path / "d"), "--platform", "cpu",
                                     "--restore", ck_j], log_fn=_quiet)
    jmain(["twolayer"] + SMALL + ["--out-dir", str(tmp_path / "e"), "--restore", ck_t])
    with h5py.File(tmp_path / "c" / "diagnostics.h5", "r") as fc, \
            h5py.File(tmp_path / "d" / "diagnostics.h5", "r") as fd, \
            h5py.File(tmp_path / "e" / "diagnostics.h5", "r") as fe:
        # restored at t = 15 dt, then 3 spinup steps and frames of 3
        np.testing.assert_allclose(fd["t"][0], 21 * 0.1 / 2 * (2 * np.pi / 32), rtol=1e-6)
        for key in ("t", "kinetic_energy", "potential_energy"):
            np.testing.assert_allclose(fd[key][()], fc[key][()], rtol=1e-5, err_msg=key)
            np.testing.assert_allclose(fe[key][()], fc[key][()], rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("flag", [["--baroclinic"], ["--ic-file", "ic.h5"]])
def test_nlayers_refuses_two_layer_options(tmp_path, flag):
    with pytest.raises(SystemExit, match="two-layer-only"):
        tcli.run(["twolayer", "--nlayers", "3", "--nx", "16", "--platform", "cpu",
                  "--out-dir", str(tmp_path)] + flag, log_fn=_quiet)
