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
- ``--birth-death`` (``rsw``, ``twolayer``): the population telemetry
  equal to the JAX command line's, and ``single-wave``'s (which the JAX
  command line drops); ``--live``: the dashboard's files;
- ``steady-raytracing`` (a band-limited snapshot and ``--snapshot-file``,
  ``--packet-velocity-scale``) against the JAX command line at 64^2, the
  packets within 1e-5; ``sweep`` with ``--task`` and with
  ``JRSW_SWEEP_INDEX``, each row's run equal to the JAX command line's;
- ``--sharded`` and ``--distributed`` exit naming their ROADMAP item, and a
  run asked for the card where there is none names ``--platform cpu``.
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
    # lifetimes of ~0.05 against the runs' t = 0.15: many rebirths
    "rsw-birth-death": (["rsw", "--birth-death", "--bd-lam", "0.05"], "rsw"),
    "twolayer-birth-death": (["twolayer", "--birth-death", "--bd-lam", "0.05",
                              "--bd-k-shape", "2.0"], "2Lqg"),
}


def _assert_outputs_match(jdir, tdir, base, frames=2):
    """The port's run directory against the JAX command line's: the same
    files, keys and dtypes; diagnostics to rtol 1e-5, the last snapshot to
    1e-5 of its largest mode, packets to 1e-4, the rest equal."""
    jd, td = _datasets(jdir), _datasets(tdir)
    assert sorted(td) == sorted(jd)
    if frames:
        assert sorted(jd) == sorted(["diagnostics.h5"] + [f"{b}.{i:06d}.h5"
                                                          for b in (base, "packets")
                                                          for i in range(frames)])
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
            if key.startswith("snapshots/sol/") and (key == f"snapshots/sol/{last}"
                                                     or frames is None):
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err < 1e-5, (name, key, err)
            elif key.startswith("p/") and key.split("/")[1] in "xkug":
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=key)
            elif key.startswith(("grid/", "params/", "clock/", "p/t/", "snapshots/t/",
                                 "p/births/")):
                np.testing.assert_array_equal(got, want, err_msg=key)
            elif key.startswith("p/mean_age/"):
                np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)
    return jd


@pytest.mark.parametrize("argv,base", list(COUPLED.values()), ids=list(COUPLED))
def test_cli_matches_jax(tmp_path, argv, base):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    jmain(argv + SMALL + ["--out-dir", jdir])
    drv = tcli.run(argv + SMALL + ["--out-dir", tdir, "--platform", "cpu"], log_fn=_quiet)
    assert drv.rp.gather == "taps"      # auto: 8 x 4 packets < 32^2 cells
    assert drv.sim.sol.device.type == "cpu"
    jd = _assert_outputs_match(jdir, tdir, base)
    if "--birth-death" in argv:
        births = [v for k, v in jd["packets.000001.h5"].items() if k.startswith("p/births/")]
        assert max(births) > 0 and drv.sim.bd is not None


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


@pytest.mark.parametrize("argv,base", [
    (["rsw", "--sharded"], "rsw"),
    (["swqg", "--distributed"], "swqg"),
    (["twolayer", "--sharded"], "2Lqg"),
    (["thomasyamada", "--sharded"], "ty"),
    (["twolayer", "--sharded", "--nlayers", "3"], "3Lqg"),
])
def test_unported_pieces_exit_naming_their_item(tmp_path, argv, base):
    """The pieces that waited for ROADMAP item 13, ported: ``--sharded``
    (a mesh of one process here, the JAX package's over its 8 virtual
    devices) and ``--distributed`` (a single process: no process group)
    write the JAX command line's files, held as a replicated run is."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    # 16 packets: the JAX package splits them over its 8 devices
    small = TY_SMALL[1:] if argv[0] == "thomasyamada" else SMALL + ["--sqrt-npackets", "4"]
    jmain(argv + small + ["--out-dir", jdir])
    lines = []
    tcli.run(argv + small + ["--out-dir", tdir, "--platform", "cpu"], log_fn=lines.append)
    if "--sharded" in argv:
        assert any("[sharded x1]" in line for line in lines)
    _assert_outputs_match(jdir, tdir, base, frames=2 if argv[0] != "thomasyamada" else None)


@pytest.mark.parametrize("argv,message", [
    (["rsw", "--sharded", "--birth-death"], "--sharded does not support --birth-death"),
    (["swqg", "--sharded", "--ray-method", "adaptive"], "--ray-method rk4|dopri5|midpoint"),
    (["single-wave", "--sharded"], "--sharded runs rsw, swqg, twolayer and thomasyamada"),
    (["rsw", "--stepper", "ETDRK4"], "ETDRK4 needs a diagonal linear operator"),
    (["twolayer", "--stepper", "ETDRK4"], "ETDRK4 needs a diagonal linear operator"),
])
def test_refused_configurations_exit_with_their_reason(tmp_path, argv, message):
    """What the port refuses exits with its reason (the reference's
    ``run`` raises on ETDRK4 with a block L)."""
    with pytest.raises(SystemExit, match=message.replace("|", "\\|")) as exc:
        tcli.run(argv + SMALL + ["--platform", "cpu", "--out-dir", str(tmp_path)],
                 log_fn=_quiet)
    assert exc.value.code not in (0, None)


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


def test_single_wave_birth_death(tmp_path):
    """``single-wave --birth-death``: the two packets live and die by the
    Weibull clock (the JAX command line's single-wave drops the option)."""
    drv = tcli.run(["single-wave"] + SMALL + ["--out-dir", str(tmp_path), "--platform", "cpu",
                                              "--birth-death", "--bd-lam", "0.02"],
                   log_fn=_quiet)
    births = {k: int(v) for name, data in _datasets(str(tmp_path)).items()
              for k, v in data.items() if k.startswith("p/births/")}
    assert len(births) == 4 and births[max(births, key=lambda k: int(k.split("/")[-1]))] \
        == int(drv.sim.bd.births) > 0
    assert drv.sim.bd.age.shape == (2,)


def test_live_dashboard_writes_its_page(tmp_path):
    """``--live 2``: the dashboard's page and image after frames 1 and 3."""
    drv = tcli.run(["swqg"] + SMALL + ["--out-dir", str(tmp_path), "--platform", "cpu",
                                       "--live", "2"], log_fn=_quiet)
    assert drv.live is not None and drv.live._count == 4
    assert (tmp_path / "live.png").stat().st_size > 0
    assert "live: swqg" in (tmp_path / "live.html").read_text()


STEADY = ["steady-raytracing", "--nx", "64", "--sqrt-npackets", "8", "--T", "0.06",
          "--output-dt", "0.03", "--seed", "3"]


def _packet_frames(run_dir):
    return _datasets(run_dir)["packets.000000.h5"]


@pytest.mark.parametrize("extra,atol", [
    ([], 1e-5),
    (["--packet-velocity-scale", "2.0", "--gather", "patch", "--table-dtype", "bfloat16"], 5e-4),
], ids=["taps", "patch"])
def test_steady_raytracing_matches_jax(tmp_path, extra, atol):
    """Packets through a frozen band-limited snapshot at 64^2, 2 frames.
    The bfloat16 table may flip a stored value by an ulp where the two
    packages' fields differ by one (``tests/test_torch_driver.py``: 5e-4)."""
    jmain(STEADY + extra + ["--out-dir", str(tmp_path / "jax")])
    lines = []
    packets, t = tcli.run(STEADY + extra + ["--out-dir", str(tmp_path / "torch"), "--platform",
                                            "cpu"], log_fn=lines.append)
    assert lines[-1] == "done: 2 packet frames, t=0.06" and packets.x.device.type == "cpu"
    jd, td = _packet_frames(str(tmp_path / "jax")), _packet_frames(str(tmp_path / "torch"))
    assert sorted(td) == sorted(jd) and "p/x/1" in td
    for key, want in jd.items():
        if key.startswith("p/") and key.split("/")[1] in ("x", "k", "u"):
            np.testing.assert_allclose(td[key], want, rtol=0, atol=atol, err_msg=key)
        else:
            np.testing.assert_array_equal(td[key], want, err_msg=key)
    assert np.abs(td["p/x/1"] - td["p/x/0"]).max() > 1e-3


def test_steady_raytracing_reads_a_snapshot_file(tmp_path):
    """``--snapshot-file``: a psih spectrum stored under
    ``--snapshot-key`` drives the packets, as in the JAX command line."""
    from juliaraytracingsw_tpu_torch.coupled.initial_conditions import random_band_psih
    from juliaraytracingsw_tpu_torch.core.grid import make_grid

    grid = make_grid(64, device="cpu")
    psih = random_band_psih(grid, np.random.default_rng(8), kband=(3, 5), amp=0.4).numpy()
    path = str(tmp_path / "snap.h5")
    with h5py.File(path, "w") as f:
        f["flow/psih"] = psih
    extra = ["--snapshot-file", path, "--snapshot-key", "flow/psih"]
    jmain(STEADY + extra + ["--out-dir", str(tmp_path / "jax")])
    tcli.run(STEADY + extra + ["--out-dir", str(tmp_path / "torch"), "--platform", "cpu"],
             log_fn=_quiet)
    jd, td = _packet_frames(str(tmp_path / "jax")), _packet_frames(str(tmp_path / "torch"))
    for key in ("p/x/1", "p/k/1", "p/u/1"):
        np.testing.assert_allclose(td[key], jd[key], rtol=0, atol=1e-5, err_msg=key)


SWEEP_RUN = ["--nx", "32", "--sqrt-npackets", "2", "--spinup-T", "0.03", "--T", "0.09",
             "--output-dt", "0.03", "--max-writes", "3", "--platform", "cpu"]


def _sweep_table(tmp_path):
    table = tmp_path / "table.txt"
    table.write_text("# reference-style whitespace table\nArrayTaskID seed ag\n"
                     "1 3 0.5\n2 4 0.8\n")
    return str(table)


def test_sweep_matches_jax(tmp_path, monkeypatch):
    """``sweep rsw table --task 2`` and the same row picked by
    ``JRSW_SWEEP_INDEX=1``: each runs the row's options through the port's
    command line, and the run equals the JAX command line's sweep of it."""
    table = _sweep_table(tmp_path)
    extra = ["--extra-args", " ".join(SWEEP_RUN)]
    jmain(["sweep", "rsw", table, "--task", "2", "--out-dir", str(tmp_path / "jax")] + extra)
    lines = []
    rows = tcli.run(["sweep", "rsw", table, "--task", "2", "--out-dir",
                     str(tmp_path / "torch")] + extra, log_fn=lines.append)
    assert rows == [{"ArrayTaskID": "2", "seed": "4", "ag": "0.8"}]
    assert "juliaraytracingsw_tpu_torch.experiments rsw" in lines[0]
    monkeypatch.setenv("JRSW_SWEEP_INDEX", "1")
    tcli.run(["sweep", "rsw", table, "--out-dir", str(tmp_path / "env")] + extra,
             log_fn=_quiet)
    jd = _datasets(str(tmp_path / "jax" / "task_2"))
    for run in ("torch", "env"):
        td = _datasets(str(tmp_path / run / "task_2"))
        assert sorted(td) == sorted(jd)
        for key, want in jd["diagnostics.h5"].items():
            np.testing.assert_allclose(td["diagnostics.h5"][key], want, rtol=1e-5, err_msg=key)
        xs = [(name, key) for name in jd for key in jd[name] if key.startswith("p/x/")]
        assert len(xs) == 2
        for name, key in xs:
            np.testing.assert_allclose(td[name][key], jd[name][key], rtol=0, atol=1e-4)


def test_sweep_reports_a_failed_task(tmp_path):
    table = _sweep_table(tmp_path)
    with pytest.raises(SystemExit, match="sweep task 1 failed"):
        tcli.run(["sweep", "rsw", table, "--task", "1", "--out-dir", str(tmp_path),
                  "--extra-args=--no-such-option"], log_fn=_quiet)


def test_sweep_launcher_rows_and_processes(tmp_path):
    """``parallel/launcher``: the row a job array's task picks, and
    ``launch_sweep`` running one process per row with its options, index
    and log; the cluster half resolves as the reference's does."""
    import sys

    from juliaraytracingsw_tpu.parallel import launcher as jl
    from juliaraytracingsw_tpu_torch.parallel import launcher as tl

    rows = [{"seed": "1"}, {"seed": "2"}, {"seed": "3"}]
    for env in ({"JRSW_SWEEP_INDEX": "2"}, {"SLURM_ARRAY_TASK_ID": "2"}):
        assert tl.sweep_row_from_env(rows, env) == jl.sweep_row_from_env(rows, env)
    with pytest.raises(RuntimeError, match="no sweep index"):
        tl.sweep_row_from_env(rows, {})
    # argv: --out <run dir> --seed <row's seed>
    code = ("import os, sys; os.makedirs(sys.argv[2]); open(os.path.join(sys.argv[2], 'seed'),"
            " 'w').write(sys.argv[4] + os.environ['JRSW_SWEEP_INDEX'])")
    rcs = tl.launch_sweep([sys.executable, "-c", code], rows[:2], str(tmp_path),
                          max_parallel=2, out_flag="--out")
    assert rcs == [0, 0]
    assert [(tmp_path / f"run00{i}" / "seed").read_text() for i in (0, 1)] == ["10", "21"]
    # without an --out directory: argv is --seed 1, and the exit code comes back
    rcs = tl.launch_sweep([sys.executable, "-c", "import sys; sys.exit(len(sys.argv))"],
                          rows[:1], str(tmp_path / "b"), out_flag=None)
    assert rcs == [3] and (tmp_path / "b" / "run000.log").exists()
    # the cluster half: the reference's spec for each scheduler, and a
    # single process brings up nothing
    for env in ({}, {"SLURM_PROCID": "1", "SLURM_NTASKS": "2", "SLURM_JOB_NODELIST": "n[1-2]"},
                {"JRSW_NUM_PROCESSES": "3", "JRSW_PROCESS_ID": "2", "JRSW_COORDINATOR": "h:1"}):
        assert vars(tl.resolve_cluster(env)) == vars(jl.resolve_cluster(env))
    assert tl.initialize_from_env({}).source == "single"
