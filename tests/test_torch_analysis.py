"""The port's analysis modules against the JAX package's on the same numpy
inputs (seeded with numpy), on the CPU.

The numpy copies (``radial``, ``slope``, ``report``, ``figures`` and the
numpy parts of ``packet_stats``) must give equal results. ``spectra``,
``transfer`` and ``models/wave_vortex`` run in float32 with torch's FFT
against JAX's and must agree within 1e-5 of the largest value: for the
triad transfers, of the largest over the five classes, since the classes
that vanish analytically (the wave part carries no linear PV, so ``gww``'s
and ``www``'s enstrophy transfers are ~1e-7 of ``total``'s) hold round-off
only.
"""
import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from juliaraytracingsw_tpu.analysis import figures as jfig  # noqa: E402
from juliaraytracingsw_tpu.analysis import packet_stats as jps  # noqa: E402
from juliaraytracingsw_tpu.analysis import radial as jrad  # noqa: E402
from juliaraytracingsw_tpu.analysis import report as jrep  # noqa: E402
from juliaraytracingsw_tpu.analysis import slope as jslope  # noqa: E402
from juliaraytracingsw_tpu.analysis import spectra as jspec  # noqa: E402
from juliaraytracingsw_tpu.analysis import suite as jsuite  # noqa: E402
from juliaraytracingsw_tpu.analysis import transfer as jtr  # noqa: E402
from juliaraytracingsw_tpu.core.grid import make_grid as jmake_grid  # noqa: E402
from juliaraytracingsw_tpu.coupled.initial_conditions import (  # noqa: E402
    band_geo_wave_ic as jic)
from juliaraytracingsw_tpu.io.output import SequencedReader as JReader  # noqa: E402
from juliaraytracingsw_tpu.models import rsw as jrsw  # noqa: E402
from juliaraytracingsw_tpu.models import wave_vortex as jwv  # noqa: E402
from juliaraytracingsw_tpu_torch.analysis import figures as tfig  # noqa: E402
from juliaraytracingsw_tpu_torch.analysis import packet_stats as tps  # noqa: E402
from juliaraytracingsw_tpu_torch.analysis import radial as trad  # noqa: E402
from juliaraytracingsw_tpu_torch.analysis import report as trep  # noqa: E402
from juliaraytracingsw_tpu_torch.analysis import slope as tslope  # noqa: E402
from juliaraytracingsw_tpu_torch.analysis import spectra as tspec  # noqa: E402
from juliaraytracingsw_tpu_torch.analysis import suite as tsuite  # noqa: E402
from juliaraytracingsw_tpu_torch.analysis import transfer as ttr  # noqa: E402
from juliaraytracingsw_tpu_torch.core.grid import make_grid as tmake_grid  # noqa: E402
from juliaraytracingsw_tpu_torch.experiments.__main__ import run as trun  # noqa: E402
from juliaraytracingsw_tpu_torch.io.output import SequencedReader as TReader  # noqa: E402
from juliaraytracingsw_tpu_torch.models import rsw as trsw  # noqa: E402
from juliaraytracingsw_tpu_torch.models import wave_vortex as twv  # noqa: E402

NX = 32
REL = 1e-5      # float32 against float32, two FFT libraries: of the largest value


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _close(got, want, rel=REL, what="", scale=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max() if scale is None else scale, 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= rel, f"{what}: {err:.3e} of the largest value"


@pytest.fixture(scope="module")
def case():
    """(JAX grid, port grid, JAX params, port params, snapshot numpy)."""
    jg, tg = jmake_grid(NX), tmake_grid(NX, device="cpu")
    jp = jrsw.make_model(jg, nu=1e-9, nnu=4, f=3.0, Cg=1.0).params
    tp = trsw.make_model(tg, nu=1e-9, nnu=4, f=3.0, Cg=1.0).params
    sol = np.array(jic(jg, np.random.default_rng(11), Kg=(3, 6), Kw=(1, 5), ag=0.4,
                       aw=0.2, f=3.0, Cg=1.0))
    return jg, tg, jp, tp, sol


def test_radial_weights_and_spectrum_equal(case):
    jg, tg, *_ = case
    (rj, Wj), (rt, Wt) = jrad.radial_weights(jg), trad.radial_weights(tg)
    np.testing.assert_array_equal(rt, rj)
    assert (Wt != Wj).nnz == 0 and Wt.shape == Wj.shape
    np.testing.assert_array_equal(trad.radial_bins(tg, 3), jrad.radial_bins(jg, 3))
    data = np.random.default_rng(2).random((NX, NX // 2 + 1))
    np.testing.assert_array_equal(trad.radial_spectrum(data, Wt), jrad.radial_spectrum(data, Wj))


def test_slope_equal():
    rng = np.random.default_rng(4)
    om = np.linspace(0.5, 8.0, 64)
    obs = 3.0 * om ** -2.5 * rng.exponential(1.0, om.size)
    for name in ("power_law", "matern"):
        args = (om, 2.0, 1.5) if name == "power_law" else (om, 2.0, 1.2, 3.0)
        np.testing.assert_array_equal(getattr(tslope, name)(*args), getattr(jslope, name)(*args))
    samples = rng.standard_normal(500)
    for a, b in zip(tslope.estimate_pdf(samples), jslope.estimate_pdf(samples)):
        np.testing.assert_array_equal(a, b)
    assert (tslope.log_likelihood(tslope.power_law, om, obs, (3.0, 2.5))
            == jslope.log_likelihood(jslope.power_law, om, obs, (3.0, 2.5)))
    for fit in ("fit_power_law", "fit_matern"):
        (xt, llt), (xj, llj) = getattr(tslope, fit)(om, obs), getattr(jslope, fit)(om, obs)
        np.testing.assert_array_equal(xt, xj)
        assert llt == llj


def test_report_pages_equal(tmp_path):
    pages = []
    for mod, d in ((trep, tmp_path / "t"), (jrep, tmp_path / "j")):
        reps = [mod.RunReport("runA", 128, 0.31, 0.12, 1e-2, 3e-4),
                mod.RunReport("runB", 64, 0.5, 0.2)]
        reps[0].add_section("energy", ["energy_series.png"])
        mod.write_run_page(reps[0], str(d), index_href="../index.html")
        mod.write_index(reps, str(d))
        pages.append([(d / n).read_text() for n in ("runA.html", "index.html")])
    assert pages[0] == pages[1]


def test_figures_equal(case, tmp_path):
    """The same data give the same PNG bytes."""
    jg, tg, *_ = case
    rng = np.random.default_rng(6)
    t = np.linspace(0, 1, 5)
    radii = np.arange(1, 20, dtype=float)
    calls = [
        ("plot_energy_series", (t, {"KE": rng.random(5), "PE": rng.random(5)})),
        ("plot_radial_spectra", (radii, {"total_KE": rng.random(19) + 0.1})),
        ("plot_flux_integrals", (radii, {"total": rng.standard_normal(19)})),
        ("plot_omega_k_heatmap", (np.linspace(-3, 3, 7), radii, rng.random((7, 19)))),
        ("plot_packet_pdfs", (t[:3], np.linspace(0, 5, 20), rng.random((3, 20)))),
    ]
    for name, args in calls:
        paths = [getattr(mod, name)(*args, str(tmp_path / tag))
                 for mod, tag in ((tfig, "t"), (jfig, "j"))]
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read(), name
    fields = {"PV": rng.standard_normal((NX, NX))}
    paths = [tfig.plot_snapshot_heatmaps(fields, tg, str(tmp_path / "t")),
             jfig.plot_snapshot_heatmaps(fields, jg, str(tmp_path / "j"))]
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_wave_vortex_matches_jax(case):
    jg, tg, jp, tp, sol = case
    st = torch.as_tensor(sol.copy())
    for a, b in zip(twv.wave_balanced_decomposition(st, tg, tp),
                    jwv.wave_balanced_decomposition(jnp.asarray(sol), jg, jp)):
        _close(a, b, what="decomposition")
    bt, bj = twv.balanced_wave_bases(tg, tp), jwv.balanced_wave_bases(jg, jp)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(_np(a), b)
    ct = twv.project_balanced_wave(st, bt, tp)
    cj = jwv.project_balanced_wave(jnp.asarray(sol), bj, jp)
    for a, b in zip(ct, cj):
        _close(a, b, what="projection")
    _close(twv.reconstruct(*ct, bt, tp), jwv.reconstruct(*cj, bj, jp), what="reconstruct")
    _close(twv.reconstruct(*ct, bt, tp), st, rel=1e-5, what="round trip")


def test_spectra_match_jax(case):
    jg, tg, jp, tp, sol = case
    et = tspec.snapshot_energetics(torch.as_tensor(sol.copy()), tg, tp)
    ej = jspec.snapshot_energetics(jnp.asarray(sol), jg, jp)
    assert sorted(et) == sorted(ej)
    for key in ej:
        assert abs(et[key] - ej[key]) <= REL * max(abs(ej[key]), 1e-30), key
    st, sj = tspec.derived_scales(et, tg, tp), jspec.derived_scales(ej, jg, jp)
    for key in sj:
        assert abs(st[key] - sj[key]) <= 1e-4 * abs(sj[key]), key
    tt, tj = tspec.TimeMeanSpectra(tg, tp), jspec.TimeMeanSpectra(jg, jp)
    for scale in (1.0, 0.5, 2.0):
        tt.add(torch.as_tensor(sol * scale))
        tj.add(jnp.asarray(sol * scale))
    mt, mj = tt.mean(), tj.mean()
    assert sorted(mt) == sorted(mj)
    for key in mj:
        assert mt[key].dtype == mj[key].dtype == np.float32
        _close(mt[key], mj[key], what=key)


def test_transfer_matches_jax(case):
    jg, tg, jp, tp, sol = case
    ot = ttr.triad_transfer(torch.as_tensor(sol.copy()), tg, tp)
    oj = jtr.triad_transfer(jnp.asarray(sol), jg, jp)
    assert sorted(ot) == sorted(oj)
    snaps = [sol, 0.5 * sol]
    mt = ttr.time_mean_transfer([torch.as_tensor(s) for s in snaps], tg, tp)
    mj = jtr.time_mean_transfer([jnp.asarray(s) for s in snaps], jg, jp)
    for got, want, tag in ((ot, oj, ""), (mt, mj, "time mean ")):
        for i in range(2):   # E, then Z
            scale = max(float(np.abs(np.asarray(v[i])).max()) for v in want.values())
            for key in want:
                _close(got[key][i], want[key][i], what=f"{tag}{key}[{i}]", scale=scale)
    assert all(v[i].dtype == np.float64 for v in mt.values() for i in range(2))


def test_packet_stats_match_jax(tmp_path):
    """The numpy parts equal; the float32 frequencies within 1e-6 of their
    largest (XLA may contract omega + k u + l v into fused multiply-adds)."""
    rng = np.random.default_rng(8)
    path = tmp_path / "packets.000000.h5"
    with h5py.File(path, "w") as f:
        for s in (5, 10, 15):
            f[f"p/t/{s}"] = 0.1 * s
            for name, w in (("x", 2), ("k", 2), ("u", 2), ("g", 4)):
                f[f"p/{name}/{s}"] = rng.standard_normal((40, w)).astype(np.float32) * 3
    base = str(tmp_path / "packets")
    st, sj = tps.load_packet_series(TReader(base)), jps.load_packet_series(JReader(base))
    assert sorted(st) == sorted(sj) == ["g", "k", "step", "t", "u", "x"]
    for key in sj:
        np.testing.assert_array_equal(st[key], sj[key])
    for key, val in jps.wavenumber_spread(sj).items():
        np.testing.assert_array_equal(tps.wavenumber_spread(st)[key], val)
    sign = np.where(np.arange(40) % 2 == 0, -1.0, 1.0).astype(np.float32)
    for fn in ("intrinsic_frequencies", "absolute_frequencies"):
        got, want = getattr(tps, fn)(st, 3.0, 1.0, sign), getattr(jps, fn)(sj, 3.0, 1.0, sign)
        assert got.dtype == want.dtype == np.float32
        _close(got, want, rel=1e-6, what=fn)
    for a, b in zip(tps.frequency_pdf_evolution(st, 3.0, 1.0),
                    jps.frequency_pdf_evolution(sj, 3.0, 1.0)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_analyze_run_matches_jax(tmp_path):
    """One short 32^2 run of the port's command line, analysed by both
    packages: the same cached series and spectra, the same figure files."""
    run = tmp_path / "run"
    trun(["rsw", "--nx", "32", "--sqrt-npackets", "4", "--seed", "5", "--spinup-T", "0.02",
          "--T", "0.1", "--output-dt", "0.02", "--out-dir", str(run), "--platform", "cpu"],
         log_fn=lambda s: None)
    rt, ft = tsuite.analyze_run(str(run), out_dir=str(tmp_path / "t"), device="cpu")
    rj, fj = jsuite.analyze_run(str(run), out_dir=str(tmp_path / "j"))
    assert sorted(ft) == sorted(fj) == ["energy", "flux", "packets", "snapshots", "spectra"]
    assert [os.path.basename(p) for p in ft.values()] == [os.path.basename(p) for p in fj.values()]
    dt_, dj = ({}, {})
    for d, sub in ((dt_, "t"), (dj, "j")):
        with h5py.File(tmp_path / sub / "plot_data.h5", "r") as f:
            f.visititems(lambda n, o: d.__setitem__(n, o[()]) if isinstance(o, h5py.Dataset)
                         else None)
    assert sorted(dt_) == sorted(dj)
    np.testing.assert_array_equal(dt_["t"], dj["t"])
    for key in dj:
        _close(dt_[key], dj[key], what=key)
    assert abs(rt.rossby - rj.rossby) <= 1e-4 * rj.rossby
    assert abs(rt.froude - rj.froude) <= 1e-4 * rj.froude
    assert (tmp_path / "t" / "run.html").exists()
