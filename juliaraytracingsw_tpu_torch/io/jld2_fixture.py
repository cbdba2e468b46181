"""JLD2-shaped HDF5 writer (port of ``io/jld2_fixture.py``; numpy and
h5py only, the same code). The two-layer simulation writes its
initial-condition files with it.

JLD2.jl implements its own HDF5-subset writer; real files produced by it
have, beyond plain HDF5 (all per the published JLD2 format docs and the
reference's own files):

- HDF5 superblock version >= 2 (h5py ``libver='v108'`` and later);
- a ``/_types`` group of COMMITTED datatypes, one per Julia type written,
  each carrying a ``julia_type`` attribute (JLD2 stores a serialized type
  reference; we store the Julia type name string, which is what parity
  tooling needs);
- complex arrays as compound ``{re, im}`` element types referencing those
  committed datatypes;
- Julia column-major arrays written with REVERSED dims (a Julia
  ``(nkr, nl)`` matrix reads back through h5py as ``(nl, nkr)``);
- unicode dataset names (``snapshots/ψh``) and unicode struct fieldnames
  (``params`` with ``f₀``), e.g. the two-layer IC files consumed at
  raytracing/TwoLayerRaytracing.jl:162-182.

``write_twolayer_ic`` mirrors that IC layout key-for-key so the reader and
the steady/two-layer drivers exercise the exact production convention
(initial_conditions/README.txt; TwoLayerSimulation.jl:137-143 writes
``snapshots/ψh/<step>`` + ``params`` + ``clock/dt``).
"""
from __future__ import annotations

import h5py
import numpy as np

__all__ = ["write_jld2_fixture", "write_twolayer_ic"]

_COMPLEX64 = np.dtype([("re", "<f4"), ("im", "<f4")])
_COMPLEX128 = np.dtype([("re", "<f8"), ("im", "<f8")])


def _julia_reversed(arr: np.ndarray) -> np.ndarray:
    """Store with reversed dims: JLD2 writes the column-major buffer with
    Julia dims, which h5py (row-major) sees transposed."""
    return np.ascontiguousarray(arr.T)


def _as_compound_complex(arr: np.ndarray) -> np.ndarray:
    comp = _COMPLEX64 if arr.dtype == np.complex64 else _COMPLEX128
    rec = np.empty(arr.shape, comp)
    rec["re"] = arr.real
    rec["im"] = arr.imag
    return rec


def _commit_type(f: h5py.File, index: int, dtype, julia_name: str) -> str:
    """Commit a datatype under /_types/%08d with a julia_type attribute —
    the JLD2 committed-datatype convention."""
    name = f"_types/{index:08d}"
    if name not in f:
        f[name] = np.dtype(dtype)
        f[name].attrs["julia_type"] = julia_name
    return name


def write_jld2_fixture(path: str, datasets: dict, julia_order: bool = True):
    """Write ``{key: array-or-scalar}`` with JLD2 structural metadata.

    Complex arrays become {re, im} compound datasets typed by a committed
    datatype in /_types; arrays are stored with reversed (Julia) dims when
    ``julia_order``.
    """
    with h5py.File(path, "w", libver=("v108", "latest")) as f:
        f.require_group("_types")
        tidx = 1
        for key, val in datasets.items():
            arr = np.asarray(val)
            if np.iscomplexobj(arr):
                _commit_type(
                    f, tidx, _COMPLEX64 if arr.dtype == np.complex64
                    else _COMPLEX128,
                    "Core.Complex{Core.Float32}"
                    if arr.dtype == np.complex64
                    else "Core.Complex{Core.Float64}")
                tidx += 1
                arr = _as_compound_complex(
                    _julia_reversed(arr) if julia_order and arr.ndim > 1
                    else arr)
            elif julia_order and arr.ndim > 1:
                arr = _julia_reversed(arr)
            f[key] = arr


def write_twolayer_ic(path: str, psih: np.ndarray, *, dt: float, t: float,
                      step: int = 0, f0: float = 1.0, beta: float = 0.0,
                      b=(1.0, 1.0), H=(0.5, 0.5), U=(0.1, -0.1),
                      mu: float = 1e-2):
    """Reference two-layer IC file layout (TwoLayerRaytracing.jl:162-182):

        snapshots/ψh/<step>   (nkr, nl, 2) complex, Julia dims
        snapshots/t/<step>
        params                struct with fields f₀, β, b, H, U, μ
        clock/dt

    ``psih`` here is OUR layout (2, nl, nkr); stored Julia-style.
    """
    with h5py.File(path, "w", libver=("v108", "latest")) as f:
        f.require_group("_types")
        comp = _COMPLEX64 if psih.dtype == np.complex64 else _COMPLEX128
        _commit_type(f, 1, comp,
                     "Core.Complex{Core.Float32}" if comp is _COMPLEX64
                     else "Core.Complex{Core.Float64}")
        # our (2, nl, nkr) row-major buffer == Julia (nkr, nl, 2)
        # column-major buffer; h5py dims are already the reversed Julia dims
        f[f"snapshots/ψh/{step}"] = _as_compound_complex(psih)
        f[f"snapshots/t/{step}"] = np.float64(t)
        b = np.asarray(b, np.float64)
        H = np.asarray(H, np.float64)
        U2 = np.asarray(U, np.float64)
        params_dt = np.dtype([
            ("f₀", "<f8"), ("β", "<f8"), ("b", "<f8", b.shape),
            ("H", "<f8", H.shape), ("U", "<f8", U2.shape), ("μ", "<f8"),
        ])
        _commit_type(f, 2, params_dt, "Main.Params")
        rec = np.zeros((), params_dt)
        rec["f₀"], rec["β"], rec["μ"] = f0, beta, mu
        rec["b"], rec["H"], rec["U"] = b, H, U2
        ds = f.create_dataset("params", data=rec)
        ds.attrs["julia_type"] = "Main.Params"
        f["clock/dt"] = np.float64(dt)
