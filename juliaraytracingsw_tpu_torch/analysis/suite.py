"""Run-analysis suite (port of ``analysis/suite.py``): compute once, cache,
render figures, emit an HTML page.

Walks a run directory's rolling snapshot/packet files, computes energetics
series, time-mean radial spectra, flux integrals and final-snapshot
heatmaps on ``device``, caches the derived data (``plot_data.h5``), renders
the canonical figures and writes the per-run HTML report.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..core.grid import make_grid
from ..models.rsw import RSWParams, updatevars
from .figures import (
    plot_energy_series,
    plot_flux_integrals,
    plot_packet_pdfs,
    plot_radial_spectra,
    plot_snapshot_heatmaps,
)
from .packet_stats import frequency_pdf_evolution, load_packet_series
from .radial import radial_spectrum, radial_weights
from .report import RunReport, write_run_page
from .spectra import TimeMeanSpectra, derived_scales, snapshot_energetics
from .transfer import time_mean_transfer

__all__ = ["analyze_run", "analyze_runs"]


def analyze_run(run_dir: str, base: str = "rsw", packet_base: str = "packets",
                out_dir: str | None = None, run_id: str | None = None,
                max_transfer_snapshots: int = 50, use_cache: bool = True,
                index_href: str = "index.html", *, device: torch.device | str = "cuda"):
    """Full offline analysis of one RSW run directory, its snapshots on
    ``device``; returns (report, {figure name: path})."""
    import h5py

    from ..io.output import SequencedReader

    out_dir = out_dir or os.path.join(run_dir, "figures")
    run_id = run_id or os.path.basename(os.path.abspath(run_dir))
    os.makedirs(out_dir, exist_ok=True)
    cache_path = os.path.join(out_dir, "plot_data.h5")

    reader = SequencedReader(os.path.join(run_dir, base))
    nx = int(reader.read("grid/nx"))
    Lx = float(reader.read("grid/Lx"))
    f = float(reader.read("params/f"))
    Cg2 = float(reader.read("params/Cg2"))
    grid = make_grid(nx, Lx=Lx, device=device)
    params = RSWParams(nu=0.0, nnu=4, f=f, Cg2=Cg2)
    steps = reader.steps()

    def snapshot(step):
        return torch.as_tensor(reader.read(f"snapshots/sol/{step}"), device=grid.device)

    if use_cache and os.path.exists(cache_path):
        data = {}
        with h5py.File(cache_path, "r") as c:
            c.visititems(lambda name, obj: data.__setitem__(name, obj[()])
                         if isinstance(obj, h5py.Dataset) else None)
    else:
        times, rows = [], []
        tms = TimeMeanSpectra(grid, params)
        for s in steps:
            sol = snapshot(s)
            times.append(float(reader.read(f"snapshots/t/{s}")))
            rows.append(snapshot_energetics(sol, grid, params))
            tms.add(sol)
        data = {"t": np.asarray(times)}
        for key in rows[0]:
            data[f"e/{key}"] = np.asarray([r[key] for r in rows])
        for key, val in tms.mean().items():
            data[f"spec2d/{key}"] = val
        with h5py.File(cache_path, "w") as c:
            for k, v in data.items():
                c[k] = v

    figures = {}
    # 1. energy series
    figures["energy"] = plot_energy_series(
        data["t"],
        {k.split("/", 1)[1]: v for k, v in data.items()
         if k.startswith("e/") and k.split("/")[1] in
         ("KE", "PE", "KE_geo", "KE_wave")},
        out_dir,
    )

    # 2. radial spectra of the time-mean 2-D spectra
    radii, W = radial_weights(grid)
    spectra = {
        name: radial_spectrum(data[f"spec2d/{name}"], W)
        for name in ("total_KE", "geo_KE", "wave_KE", "total_PE")
        if f"spec2d/{name}" in data
    }
    figures["spectra"] = plot_radial_spectra(radii, spectra, out_dir)

    # 3. flux integrals from time-mean triad transfers
    nsnap = min(len(steps), max_transfer_snapshots)
    sel = steps[:: max(len(steps) // nsnap, 1)][:nsnap]
    tm = time_mean_transfer((snapshot(s) for s in sel), grid, params)
    flux = {k: radial_spectrum(v[0], W) for k, v in tm.items()}
    figures["flux"] = plot_flux_integrals(radii, flux, out_dir)

    # 4. final snapshot heatmaps (PV + divergence)
    sol_last = snapshot(steps[-1])
    _, _, _, zeta = updatevars(sol_last, grid, params)
    div = torch.fft.irfft2(grid.ik * sol_last[0] + grid.il * sol_last[1],
                           s=(grid.ny, grid.nx), dim=(-2, -1))
    figures["snapshots"] = plot_snapshot_heatmaps(
        {"linearised PV": zeta.cpu().numpy(), "divergence": div.cpu().numpy()}, grid, out_dir
    )

    # 5. packet statistics (if packet files exist)
    preader = SequencedReader(os.path.join(run_dir, packet_base))
    if preader.paths:
        try:
            series = load_packet_series(preader)
            if "k" in series:
                Cg = float(np.sqrt(Cg2))
                tt, gp, pdfs = frequency_pdf_evolution(series, f, Cg)
                figures["packets"] = plot_packet_pdfs(tt, gp, pdfs, out_dir, f0=f)
        except (KeyError, ValueError) as exc:  # packet telemetry is optional
            print(f"packet analysis skipped: {exc}")

    # 6. report page
    e_last = {k.split("/", 1)[1]: v[-1] for k, v in data.items()
              if k.startswith("e/")}
    sc = derived_scales(e_last, grid, params)
    rep = RunReport(run_id, nx, sc["Ro"], sc["Fr"],
                    float(data["e/KE_geo"][0]), float(data["e/KE_wave"][0]))
    for title, fig in figures.items():
        rep.add_section(title, [os.path.basename(fig)])
    write_run_page(rep, out_dir, index_href=index_href)
    return rep, figures


def analyze_runs(run_dirs, base: str = "rsw", out_dir: str | None = None,
                 max_workers: int = 4, **kwargs):
    """Analyse many run directories concurrently and build the master
    ``index.html`` table over them; ``kwargs`` (``device=`` among them) go
    to ``analyze_run``."""
    from concurrent.futures import ThreadPoolExecutor

    from .report import write_index

    run_dirs = list(run_dirs)
    out_dir = out_dir or "figures"
    os.makedirs(out_dir, exist_ok=True)

    # disambiguate duplicate basenames (e.g. /a/run1 and /b/run1) so
    # concurrent workers never share an out_dir subdirectory
    rids, seen = [], {}
    for rd in run_dirs:
        rid = os.path.basename(os.path.abspath(rd))
        n = seen.get(rid, 0)
        seen[rid] = n + 1
        rids.append(rid if n == 0 else f"{rid}-{n + 1}")

    def one(rd, rid):
        # pages live in out/<rid>/<rid>.html; the master index is one up
        return analyze_run(rd, base=base, out_dir=os.path.join(out_dir, rid),
                           run_id=rid, index_href="../index.html",
                           **kwargs)[0]

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        reports = list(ex.map(one, run_dirs, rids))
    # the per-run pages live in subdirectories; link them from the index
    for rep in reports:
        rep.run_id = f"{rep.run_id}/{rep.run_id}"
    idx = write_index(reports, out_dir)
    for rep in reports:
        rep.run_id = rep.run_id.split("/", 1)[1]
    return reports, idx
