"""Static HTML report database for simulation runs (a copy of
``analysis/report.py``).

Equivalent of the reference's visualization/ layer: a per-run figure page
generated from a template with run metadata placeholders
(visualization/figure_template.html:13-19) plus a master index table
(visualization/raytracing/index.html). Self-contained HTML (no CDN).
"""
from __future__ import annotations

import html
import os
from dataclasses import dataclass, field

__all__ = ["RunReport", "write_run_page", "write_index"]


_PAGE = """<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<title>Run {run_id}</title>
<style>
body {{ font-family: sans-serif; margin: 2em; }}
.grid {{ display: grid; grid-template-columns: 1fr 1fr; gap: 1em; }}
img {{ max-width: 100%; }}
table {{ border-collapse: collapse; }} td, th {{ border: 1px solid #ccc; padding: 4px 10px; }}
</style></head><body>
<p><a href="{index_href}">&larr; Main table</a></p>
<h1>Run {run_id}</h1>
<h3>{grid_dim}&times;{grid_dim} grid &nbsp; Ro = {rossby} &nbsp; Fr = {froude}</h3>
<p>Initial geostrophic energy = {geo_energy} &nbsp; Initial wave energy = {wave_energy}</p>
<hr>
{sections}
</body></html>
"""

_INDEX = """<!doctype html>
<html lang="en"><head><meta charset="utf-8"><title>Run database</title>
<style>body {{ font-family: sans-serif; margin: 2em; }}
table {{ border-collapse: collapse; }} td, th {{ border: 1px solid #ccc; padding: 4px 10px; }}</style>
</head><body><h1>Run database</h1>
<table><tr>{header}</tr>
{rows}
</table></body></html>
"""


@dataclass
class RunReport:
    run_id: str
    grid_dim: int
    rossby: float
    froude: float
    geo_energy: float = 0.0
    wave_energy: float = 0.0
    sections: list = field(default_factory=list)  # (title, [figure paths])
    extra: dict = field(default_factory=dict)

    def add_section(self, title: str, figures: list[str]):
        self.sections.append((title, list(figures)))


def write_run_page(report: RunReport, out_dir: str,
                   index_href: str = "index.html") -> str:
    """``index_href`` points the back-link at the master index — pass
    '../index.html' when the page lives in a per-run subdirectory of the
    multi-run layout (analyze_runs)."""
    os.makedirs(out_dir, exist_ok=True)
    sections_html = []
    for title, figs in report.sections:
        imgs = "\n".join(
            f'<img src="{html.escape(f)}" alt="{html.escape(title)}">'
            for f in figs
        )
        sections_html.append(
            f"<h2>{html.escape(title)}</h2>\n<div class='grid'>{imgs}</div><hr>"
        )
    page = _PAGE.format(
        run_id=html.escape(report.run_id),
        grid_dim=report.grid_dim,
        rossby=f"{report.rossby:.3g}",
        froude=f"{report.froude:.3g}",
        geo_energy=f"{report.geo_energy:.4g}",
        wave_energy=f"{report.wave_energy:.4g}",
        sections="\n".join(sections_html),
        index_href=html.escape(index_href),
    )
    path = os.path.join(out_dir, f"{report.run_id}.html")
    with open(path, "w") as fh:
        fh.write(page)
    return path


def write_index(reports: list[RunReport], out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    cols = ["run", "grid", "Ro", "Fr", "E_geo", "E_wave"]
    header = "".join(f"<th>{c}</th>" for c in cols)
    rows = []
    for r in sorted(reports, key=lambda r: r.run_id):
        cells = [
            f'<a href="{html.escape(r.run_id)}.html">{html.escape(r.run_id)}</a>',
            f"{r.grid_dim}&sup2;", f"{r.rossby:.3g}", f"{r.froude:.3g}",
            f"{r.geo_energy:.3g}", f"{r.wave_energy:.3g}",
        ]
        rows.append("<tr>" + "".join(f"<td>{c}</td>" for c in cells) + "</tr>")
    path = os.path.join(out_dir, "index.html")
    with open(path, "w") as fh:
        fh.write(_INDEX.format(header=header, rows="\n".join(rows)))
    return path
