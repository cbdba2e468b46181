"""Where the time of one hero coupled step goes on an NVIDIA GPU.

    python3 scripts/torch_hero_profile.py [--interp bilinear]
        [--ray-method rk4|adaptive] [--trace DIR]

Builds the hero of ``chip_smoke.py`` (512^2 RSW + 1,048,576 packets,
bfloat16 patch tables) with the PyTorch port and prints:

1. the time of each stage of one coupled step, taken apart by hand and
   timed with CUDA events (``_timing.time_ms``: the median of 3 timings of
   10 calls each, called from Python, host work included), among them the
   fused RK4 substep and the fused DP5(4) attempt, and one whole adaptive
   interval (``raytrace_adaptive`` at the adaptive hero's options, its
   pair-table build and its wait on the device included);
2. one frame of 5 coupled steps through ``make_coupled_frame`` with the
   RK4 or the adaptive ray method under ``torch.profiler``: device time by
   kernel name, and the device's busy share of the frame's wall time
   (``--trace DIR`` also writes the Chrome trace there).

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import DT, HERO_ADAPTIVE, K0, K_CUTOFF, make_case  # noqa: E402
from juliaraytracingsw_tpu_torch.core.steppers import zero_clock  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled.driver import (  # noqa: E402
    SimState, make_coupled_frame)
from juliaraytracingsw_tpu_torch.models.base import build_stepper  # noqa: E402
from juliaraytracingsw_tpu_torch.ops.ray_step import fused_attempt, fused_substep  # noqa: E402
from juliaraytracingsw_tpu_torch.profiling._timing import card_line, time_ms  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.patch import build_patch_table  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.raytrace import (  # noqa: E402
    _gather_patch_rows, fields_from_psih, make_pair_table, raytrace_adaptive)
from juliaraytracingsw_tpu_torch.rays.resample import k_cutoff_reset  # noqa: E402


def stages(interp: str, device) -> None:
    grid, model, sol0, rp, psih_fn = make_case(512, interp, "bfloat16", device)
    init, step = build_stepper(model, "IFMAB3", DT)
    p = lattice_packets(1024, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)
    sol, clock, ss = sol0, zero_clock(device=device), init(sol0)
    for _ in range(4):                      # past the Euler bootstrap
        sol, clock, ss = step(sol, clock, ss)
    fields = fields_from_psih(psih_fn(sol), grid, interp)
    T_old = T_new = build_patch_table(fields, interp)
    T_pair = make_pair_table(T_old, T_new, rp.table_dtype)
    rows, bx, by = _gather_patch_rows(T_pair, p, rp, grid.ny, grid.nx)
    rows_T = rows.t().contiguous()
    st = torch.stack([p.x, p.y, p.k, p.l, p.sign, bx, by])
    scal = torch.tensor([0.0, DT], device=device)
    scal5 = torch.tensor([0.0, 1.0, DT, HERO_ADAPTIVE["rtol"], HERO_ADAPTIVE["atol"]],
                         device=device)
    parts = {
        "flow step (IF-AB3 + RSW calcN)": lambda: step(sol, clock, ss),
        "fields_from_psih": lambda: fields_from_psih(psih_fn(sol), grid, interp),
        "build_patch_table": lambda: build_patch_table(fields, interp),
        "make_pair_table (cat + bf16)": lambda: make_pair_table(T_old, T_new,
                                                                rp.table_dtype),
        "row gather (floor, index_select, .float())":
            lambda: _gather_patch_rows(T_pair, p, rp, grid.ny, grid.nx),
        "transpose rows -> rows_T": lambda: rows.t().contiguous(),
        "stack st": lambda: torch.stack([p.x, p.y, p.k, p.l, p.sign, bx, by]),
        "fused RK4 substep kernel": lambda: fused_substep(rows_T, st, scal, rp=rp,
                                                          interp=interp, da=1.0),
        "fused DP5(4) attempt kernel": lambda: fused_attempt(rows_T, st, scal5, rp=rp,
                                                             interp=interp),
        "k_cutoff_reset": lambda: k_cutoff_reset(p, K_CUTOFF, K0),
    }
    whole = ("raytrace_adaptive, one interval",
             lambda: raytrace_adaptive(p, fields, fields, clock.t, clock.t + DT, rp,
                                       **HERO_ADAPTIVE))
    total = 0.0
    for name, fn in parts.items():
        ms = time_ms(fn)
        total += ms
        print(f"  {name:45s} {ms:8.3f} ms")
    print(f"  {'sum of the stages':45s} {total:8.3f} ms")
    print(f"  {whole[0]:45s} {time_ms(whole[1]):8.3f} ms")


def profiled_frame(interp: str, ray_method: str, device, trace_dir: str | None) -> None:
    from torch.profiler import ProfilerActivity, profile

    grid, model, sol0, rp, psih_fn = make_case(512, interp, "bfloat16", device)
    init, step = build_stepper(model, "IFMAB3", DT)
    frame = make_coupled_frame(model, step, psih_fn, rp, 5, k_cutoff=K_CUTOFF, k0=K0,
                               ray_method=ray_method, ray_opts=HERO_ADAPTIVE
                               if ray_method == "adaptive" else None)
    p = lattice_packets(1024, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)
    sim = SimState(sol0, zero_clock(device=device), init(sol0), p,
                   fields_from_psih(psih_fn(sol0), grid, interp))
    sim = frame(sim)                        # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim = frame(sim)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"  profiled frame: wall {wall_ms:.2f} ms, device busy {dev_us / 1e3:.2f} ms "
          f"({100 * dev_us / 1e3 / wall_ms:.1f}%), {sum(e.count for e in events)} kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"hero_{interp}_{ray_method}_frame.json")
        prof.export_chrome_trace(path)
        print(f"  chrome trace: {path}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--interp", default="bilinear",
                    choices=["bilinear", "bspline", "bicubic"])
    ap.add_argument("--ray-method", default="rk4", choices=["rk4", "adaptive"],
                    help="ray method of the profiled frame")
    ap.add_argument("--trace", default=None, help="directory for the Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(f"card: {card_line()}; torch {torch.__version__}")
    print(f"hero {args.interp}, one coupled step by stage (CUDA events):")
    stages(args.interp, device)
    print(f"hero {args.interp}, one {args.ray_method} frame of 5 coupled steps "
          f"(torch.profiler):")
    profiled_frame(args.interp, args.ray_method, device, args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
