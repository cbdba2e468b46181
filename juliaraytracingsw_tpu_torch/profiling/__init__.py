"""Copy and gather probes on the card (port of the JAX package's Pallas
probe scripts in ``benchmarks/profiling/``).

One module per probe script, with the script's name; each runs the
script's probes at the script's own shapes through the port's hand
kernels (``ops/probes.py``, and ``ops/ray_step.py`` for the fused substep),
holds every kernel bit-equal to its plain version, and prints for each
probe its time, ns per row, the least time device memory allows, and the
time of the PyTorch call that computes the same function where there is
one. Run them all with

    python -m juliaraytracingsw_tpu_torch.profiling [module ...]

It needs a CUDA device, and raises (exits non-zero) on a failed build, a
refused launch or a mismatch.
"""
from __future__ import annotations

import importlib

__all__ = ["MODULES", "load", "run_all"]

# in the order the scripts were written
MODULES = ("prof_pallas_probe", "prof_pallas_gather", "prof_pallas2", "prof_pallas3",
           "prof_r5_dma_probe", "prof_r5_dma2", "prof_r5_dma_bisect", "prof_r5_dma_bisect2")


def load(name: str):
    if name not in MODULES:
        raise ValueError(f"unknown probe module {name!r}; available: {list(MODULES)}")
    return importlib.import_module(f"{__name__}.{name}")


def run_all(device, names=MODULES) -> dict:
    """Run the probe modules ``names`` on ``device``: {module: [Result]}."""
    from ._timing import card_line

    card = card_line()
    return {name: load(name).run(device, card) for name in names}
