"""Collated rolling outputs keyed by entry count (port of
``io/collated.py``; h5py, no torch).

``CollatedWriter`` appends one dataset per entry and rolls to the next
``<base>_%08d.h5`` after ``max_lines`` entries; ``map_input`` maps a
function over every entry of every file of the sequence, in order (the
reference's utils/Collated.jl, used for per-step packet rows).
"""
from __future__ import annotations

import os
from typing import Callable

import h5py
import numpy as np

__all__ = ["CollatedWriter", "map_input"]


class CollatedWriter:
    def __init__(self, base: str, max_lines: int = 1000):
        parent = os.path.dirname(base)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self.base = base
        self.max_lines = int(max_lines)
        self.idx = 0
        self.lines = 0
        self._file = None

    def _path(self, idx):
        return f"{self.base}_{idx:08d}.h5"

    @property
    def file(self):
        if self._file is None:
            self._file = h5py.File(self._path(self.idx), "w")
        return self._file

    def append(self, key: str, value):
        """Append one entry; rolls to the next file after max_lines."""
        if self.lines >= self.max_lines:
            self.close()
            self.idx += 1
            self.lines = 0
        self.file[key] = np.asarray(value)
        self.lines += 1

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def map_input(base: str, fn: Callable[[str, np.ndarray], object]):
    """Apply ``fn(key, value)`` to every entry of every file in the sequence
    (Collated.jl map_input, :74-93). Returns the list of results."""
    out = []
    idx = 0
    while True:
        path = f"{base}_{idx:08d}.h5"
        if not os.path.exists(path):
            break
        with h5py.File(path, "r") as f:
            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    out.append(fn(name, obj[()]))
            f.visititems(visit)
        idx += 1
    return out
