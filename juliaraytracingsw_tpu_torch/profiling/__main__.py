"""Run the probe modules on the card:

    python -m juliaraytracingsw_tpu_torch.profiling [module ...]

(all eight when none is named). Exits non-zero on a failed build, a refused
launch or a kernel that disagrees with its plain version.
"""
from __future__ import annotations

import sys

from . import MODULES, run_all
from ._timing import require_cuda


def main(argv: list[str]) -> int:
    results = run_all(require_cuda(), tuple(argv) or MODULES)
    print(f"{sum(map(len, results.values()))} probes in {len(results)} modules done")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
