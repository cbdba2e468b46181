"""The port's command line on the CPU (``--platform cpu``), against the JAX
package's command line:

- ``rsw`` (``--ic band`` and ``--ic front``) and ``swqg`` at 32^2 with 4
  packets, the same seed through both: the same HDF5 files and keys,
  ``diagnostics.h5`` within rtol 1e-5, the last snapshot within 1e-5 of its
  largest mode, the packets within 1e-4 (two FFT libraries, float32);
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


@pytest.mark.parametrize("argv", [["rsw", "--ic", "band"], ["rsw", "--ic", "front"],
                                  ["swqg"]], ids=["rsw-band", "rsw-front", "swqg"])
def test_cli_matches_jax(tmp_path, argv):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmain(argv + SMALL + ["--out-dir", jdir])
    drv = tcli.run(argv + SMALL + ["--out-dir", tdir, "--platform", "cpu"], log_fn=_quiet)
    assert drv.rp.gather == "taps"      # auto: 8 x 4 packets < 32^2 cells
    assert drv.sim.sol.device.type == "cpu"
    jd, td = _datasets(jdir), _datasets(tdir)
    base = argv[0]
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
    (["twolayer"], "item 8"),
    (["thomasyamada", "--nx", "32"], "item 9"),
    (["single-wave"], "item 9"),
    (["steady-raytracing"], "item 12"),
    (["twolayer-simulation"], "item 8"),
    (["sweep", "rsw", "table.csv"], "item 12"),
    (["omega-k", "run"], "item 12"),
    (["omega-k-plot", "run"], "item 12"),
    (["b-parameter", "run"], "item 12"),
    (["rsw", "--model", "linborg"], "item 8"),
    (["rsw", "--model", "modified"], "item 8"),
    (["rsw", "--model", "quadheight"], "item 8"),
    (["rsw", "--birth-death"], "item 5"),
    (["swqg", "--live", "2"], "item 12"),
    (["rsw", "--sharded"], "item 13"),
    (["swqg", "--distributed"], "item 13"),
])
def test_unported_pieces_exit_naming_their_item(tmp_path, argv, item):
    with pytest.raises(SystemExit, match=f"not ported.*{item}") as exc:
        tcli.run(argv + (["--platform", "cpu", "--out-dir", str(tmp_path)]
                         if argv[0] in ("rsw", "swqg") else []), log_fn=_quiet)
    assert exc.value.code not in (0, None)
    assert not os.listdir(tmp_path)


def test_no_card_names_platform_cpu(tmp_path, monkeypatch):
    """No fall-back to the CPU: without a card the run fails."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["rsw", "--out-dir", str(tmp_path)], ["analyze", str(tmp_path)]):
        with pytest.raises(SystemExit, match="--platform cpu"):
            tcli.run(argv, log_fn=_quiet)
