"""Where the patch gather and the taps gather cross over on an NVIDIA GPU.

    python3 scripts/torch_gather_crossover.py [--json PATH] [--frames 3]

Times coupled steps/s of the hero's path (RSW stepped by IF-AB3, RK4 rays,
bilinear, bfloat16 pair tables; ``chip_smoke.make_case``) with
``gather='patch'`` (one pair-table build per flow step, then one table
kernel launch per substep) against ``gather='taps'`` (no table, every
stage's taps gathered from the time-blended field stacks) at 512^2 x
{16,384; 65,536; 262,144; 1,048,576} packets and 2048^2 x {262,144;
1,048,576} packets. Each reading is frames of 5 coupled steps through
``make_coupled_frame`` between two CUDA events after one warm-up frame,
with the driver's one wait on the device per frame; the two paths run in
turns (patch, taps, taps, patch) and each row reports both readings of
each. Beside each row: the JAX package's rule ``resolve_gather`` (patch iff
8 N >= ny nx, measured on a TPU) and which path was faster here. The last
line is the table as JSON, with the card's name and power limit.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import DT, K0, K_CUTOFF, make_case  # noqa: E402
from juliaraytracingsw_tpu_torch.core.steppers import zero_clock  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled.driver import (  # noqa: E402
    SimState, make_coupled_frame)
from juliaraytracingsw_tpu_torch.models.base import build_stepper  # noqa: E402
from juliaraytracingsw_tpu_torch.profiling._timing import card_line  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.raytrace import (  # noqa: E402
    PATCH_TAPS_CROSSOVER, fields_from_psih, resolve_gather)

# (nx, sqrt of the packet counts)
SIZES = ((512, (128, 256, 512, 1024)), (2048, (512, 1024)))
FLOW_STEPS = 5


def steps_per_s(frame, sim: SimState, frames: int) -> float:
    """Coupled steps/s over ``frames`` frames after one warm-up frame, each
    frame ended by the driver's NaN check (one wait on the device)."""
    sim = frame(sim)
    float(sim.sol.abs().max())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        sim = frame(sim)
        float(sim.sol.abs().max())
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
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; RK4, bilinear, bf16 tables, {FLOW_STEPS} coupled steps a frame, "
          f"{args.frames} timed frames a reading")
    rows = []
    for nx, sqrts in SIZES:
        grid, model, sol0, rp, psih_fn = make_case(nx, "bilinear", "bfloat16", device)
        init, step = build_stepper(model, "IFMAB3", DT)
        fields = fields_from_psih(psih_fn(sol0), grid, rp.interp)
        frames = {g: make_coupled_frame(model, step, psih_fn, rp._replace(gather=g), FLOW_STEPS,
                                        k_cutoff=K_CUTOFF, k0=K0)
                  for g in ("patch", "taps")}
        for sq in sqrts:
            packets = lattice_packets(sq, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)
            sim = SimState(sol0, zero_clock(device=device), init(sol0), packets, fields)
            rates = {"patch": [], "taps": []}
            for g in ("patch", "taps", "taps", "patch"):
                rates[g].append(steps_per_s(frames[g], sim, args.frames))
            n = packets.n
            rule = resolve_gather(rp._replace(gather="auto"), n, grid.ny, grid.nx).gather
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
            del sim, packets
        del frames, fields, grid, model, sol0, init, step
        torch.cuda.empty_cache()
    out = {"card": card, "rows": rows}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
