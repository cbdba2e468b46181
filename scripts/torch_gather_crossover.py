"""Where the patch gather and the taps gather cross over on an NVIDIA GPU.

    python3 scripts/torch_gather_crossover.py [--json PATH] [--frames 3]

Times coupled steps/s of the ``rsw`` command line's path (RSW stepped by
IF-AB3, RK4 rays, bilinear, bfloat16 pair tables, the IC of seed 1 with ag
0.5 and aw 0.05, the command line's CFL dt; the case and the driver built by
``experiments.__main__``'s parser, ``SETUPS`` and ``make_driver``, without
writers) with ``--gather patch`` (one pair-table build per flow step, then
one table kernel launch per substep) against ``--gather taps`` (no table,
every stage's taps gathered from the time-blended field stacks) at 512^2 x
{16,384; 65,536; 262,144; 1,048,576} packets and 2048^2 x {262,144;
1,048,576} packets. Each reading is frames of 5 coupled steps through
``CoupledDriver.run`` (each frame ends in the driver's NaN guard; from the
second on a frame replays as one CUDA graph) between two CUDA events after
two warm-up frames; the two paths run in turns (patch, taps, taps, patch)
and each row reports both readings of each. Beside each row: the rule
``resolve_gather`` (patch iff 8 N >= ny nx, measured on a TPU) and which
path was faster here. The last line is the table as JSON, with the card's
name and power limit.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

# the package of this checkout, as the other scripts find theirs
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from juliaraytracingsw_tpu_torch.experiments import __main__ as cli  # noqa: E402
from juliaraytracingsw_tpu_torch.profiling._timing import card_line  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.raytrace import (  # noqa: E402
    PATCH_TAPS_CROSSOVER, resolve_gather)

# (nx, sqrt of the packet counts)
SIZES = ((512, (128, 256, 512, 1024)), (2048, (512, 1024)))
FLOW_STEPS = 5
CASE = ("--interp", "bilinear", "--table-dtype", "bfloat16", "--ray-method", "rk4",
        "--seed", "1", "--ag", "0.5", "--aw", "0.05", "--platform", "cuda")


def driver(nx: int, sqrtp: int, gather: str):
    """The command line's driver of the case at nx^2 x sqrtp^2 packets,
    started from its initial state."""
    args = cli.build_parser().parse_args(["rsw", "--nx", str(nx), "--sqrt-npackets",
                                          str(sqrtp), "--gather", gather, *CASE])
    case = cli.SETUPS["rsw"](args, lambda line: None)
    drv = cli.make_driver(args, case, log_fn=lambda line: None)
    drv.init(case.sol0, case.packets)
    return drv


def steps_per_s(drv, frames: int) -> float:
    """Coupled steps/s over ``frames`` frames after two warm-up frames."""
    drv.run(2, FLOW_STEPS)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    drv.run(frames, FLOW_STEPS)
    end.record()
    torch.cuda.synchronize()
    return FLOW_STEPS * frames / (start.elapsed_time(end) / 1e3)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="also write the table here")
    ap.add_argument("--frames", type=int, default=3, help="timed frames a reading")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}; RK4, bilinear, bf16 tables, {FLOW_STEPS} coupled steps a frame, "
          f"{args.frames} timed frames a reading")
    rows = []
    for nx, sqrts in SIZES:
        for sq in sqrts:
            drivers = {g: driver(nx, sq, g) for g in ("patch", "taps")}
            rates = {"patch": [], "taps": []}
            for g in ("patch", "taps", "taps", "patch"):
                rates[g].append(steps_per_s(drivers[g], args.frames))
            rp, n = drivers["patch"].rp, sq * sq
            rule = resolve_gather(rp._replace(gather="auto"), n, nx, nx).gather
            faster = max(rates, key=lambda g: min(rates[g]))
            if min(rates["patch"]) < max(rates["taps"]) and min(rates["taps"]) < max(
                    rates["patch"]):
                faster = "neither (the readings overlap)"
            row = dict(nx=nx, packets=n, ratio=PATCH_TAPS_CROSSOVER * n / (nx * nx),
                       patch_steps_per_s=rates["patch"], taps_steps_per_s=rates["taps"],
                       rule=rule, faster=faster)
            rows.append(row)
            print(f"{nx}^2 x {n:>9,} packets ({PATCH_TAPS_CROSSOVER} N / cells "
                  f"{row['ratio']:.3g}): patch {', '.join(f'{r:.2f}' for r in rates['patch'])}"
                  f", taps {', '.join(f'{r:.2f}' for r in rates['taps'])} coupled steps/s; "
                  f"resolve_gather -> {rule}; faster here: {faster}", flush=True)
            del drivers
            torch.cuda.empty_cache()
    out = {"card": card, "rows": rows}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
