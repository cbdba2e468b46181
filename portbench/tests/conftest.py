"""Shared fixtures of the benchmark's tests: tiny copies of the cells that
run on the CPU in a second or two each."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench.spec import Cell, load_benchmark, load_cell


def tiny_cell(name: str, nx: int = 32, sqrt_n: int = 16) -> Cell:
    """``name`` at nx^2 with sqrt_n^2 packets, a short spin-up and the
    checked frames early; everything else as committed."""
    cell = load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["nx"], cfg["packets"]["sqrt_n"] = nx, sqrt_n
    tr = copy.deepcopy(cell.traffic)
    tr["spinup_steps"] = min(tr.get("spinup_steps", 0), 20)
    tr["check_frames"], tr["trace_frames"] = [1, 4], 6
    return Cell(cell.entry, cell.workload, cfg, tr)


@pytest.fixture
def bench():
    return load_benchmark()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is false")
    return "cuda"


@pytest.fixture
def tiny():
    return tiny_cell
