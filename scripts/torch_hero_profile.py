"""Where the time of one hero coupled step goes on an NVIDIA GPU.

    python3 scripts/torch_hero_profile.py [--interp bilinear]
        [--ray-method rk4|adaptive] [--trace DIR]

Builds the hero of ``chip_smoke.py`` (512^2 RSW + 1,048,576 packets,
bfloat16 patch tables) with the PyTorch port and prints:

1. the time of each stage of one coupled step as the card runs it, taken
   apart by hand and timed with CUDA events (``_timing.time_ms``: the
   median of 3 timings of 10 calls each, called from Python, host work
   included), among them the pair-table kernel that builds the table from
   both field stacks, and the RK4 table kernel and the DP5(4) table
   attempt kernel, which read the pair table themselves; the sum of the
   stages of an RK4 step and of an adaptive step of one attempt; one whole
   adaptive interval (``raytrace_adaptive`` at the adaptive hero's
   options, its pair-table build and its wait on the device included); and, for
   comparison, the paths the kernels replaced: the roll path of the pair
   table (two patch tables, their concatenation and cast) and the first-cut
   path (row gather and upcast, transpose, first-cut kernel);
2. what a frame's outputs cost the ``CoupledDriver`` of the command line,
   host wall time (median of 5, the device idle before each): the packet
   telemetry taken apart (sampling u, v and the gradients at the packets,
   stacking 10 rows, one copy to the host, cutting the (N, 2|4) arrays)
   and whole (``_write_packet_frame`` into a writer that keeps nothing),
   one snapshot's copy to the host and the two RSW diagnostics; no HDF5
   write;
3. one frame of 5 coupled steps through ``make_coupled_frame`` with the
   RK4 or the adaptive ray method under ``torch.profiler``: device time by
   kernel name, and the device's busy share of the frame's wall time
   (``--trace DIR`` also writes the Chrome trace there);
4. the RK4 frame through the sharded flow on a mesh of one process over
   NCCL (``parallel/sharded_rsw.ShardedRSW``, hero_sharded1) under
   ``torch.profiler``: the same, and the host's time in the operators that
   cost the most of it (the collectives' and the transposes' among them).

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (DT, HERO_ADAPTIVE, K0, K_CUTOFF, DiscardingWriter,  # noqa: E402
                        make_case)
from juliaraytracingsw_tpu_torch.core.steppers import zero_clock  # noqa: E402
from juliaraytracingsw_tpu_torch.coupled.driver import (  # noqa: E402
    CoupledDriver, SimState, make_coupled_frame)
from juliaraytracingsw_tpu_torch.models import rsw  # noqa: E402
from juliaraytracingsw_tpu_torch.models.base import build_stepper  # noqa: E402
from juliaraytracingsw_tpu_torch.ops.pair_table import pair_table_torch  # noqa: E402
from juliaraytracingsw_tpu_torch.ops.ray_step import (  # noqa: E402
    first_cut_inputs, fused_attempt, fused_substep, table_attempt, table_substep)
from juliaraytracingsw_tpu_torch.profiling._timing import card_line, time_ms  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.packets import lattice_packets  # noqa: E402
from juliaraytracingsw_tpu_torch.rays.raytrace import (  # noqa: E402
    _gather_patch_rows, build_pair, fields_from_psih, raytrace_adaptive, sample_gradients,
    sample_velocity)
from juliaraytracingsw_tpu_torch.rays.resample import k_cutoff_reset  # noqa: E402


def stages(interp: str, device) -> None:
    grid, model, sol0, rp, psih_fn = make_case(512, interp, "bfloat16", device)
    init, step = build_stepper(model, "IFMAB3", DT)
    p = lattice_packets(1024, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)
    sol, clock, ss = sol0, zero_clock(device=device), init(sol0)
    for _ in range(4):                      # past the Euler bootstrap
        sol, clock, ss = step(sol, clock, ss)
    fields = fields_from_psih(psih_fn(sol), grid, interp)
    T_pair = build_pair(fields, fields, rp)
    geo = dict(ny=grid.ny, nx=grid.nx)
    st = torch.stack([p.x, p.y, p.k, p.l, p.sign])
    scal = torch.tensor([0.0, DT], device=device)
    scal5 = torch.tensor([0.0, 1.0, DT, HERO_ADAPTIVE["rtol"], HERO_ADAPTIVE["atol"]],
                         device=device)
    # (name, fn, in the RK4 step, in an adaptive step of one attempt)
    parts = [
        ("flow step (IF-AB3 + RSW calcN)", lambda: step(sol, clock, ss), 1, 1),
        ("fields_from_psih", lambda: fields_from_psih(psih_fn(sol), grid, interp), 1, 1),
        ("pair table kernel (build_pair)", lambda: build_pair(fields, fields, rp), 1, 1),
        ("stack st (5, N)", lambda: torch.stack([p.x, p.y, p.k, p.l, p.sign]), 1, 1),
        ("RK4 table kernel (reads T_pair)",
         lambda: table_substep(T_pair, st, scal, rp=rp, interp=interp, da=1.0, **geo), 1, 0),
        ("DP5(4) table attempt kernel (reads T_pair)",
         lambda: table_attempt(T_pair, st, scal5, rp=rp, interp=interp, **geo), 0, 1),
        ("k_cutoff_reset", lambda: k_cutoff_reset(p, K_CUTOFF, K0), 1, 1),
    ]
    sums = [0.0, 0.0]
    for name, fn, in_rk4, in_adaptive in parts:
        ms = time_ms(fn)
        sums[0] += in_rk4 * ms
        sums[1] += in_adaptive * ms
        print(f"  {name:45s} {ms:8.3f} ms")
    print(f"  {'sum of the stages, RK4 step':45s} {sums[0]:8.3f} ms")
    print(f"  {'sum of the stages, adaptive step (1 attempt)':45s} {sums[1]:8.3f} ms")
    interval_ms = time_ms(lambda: raytrace_adaptive(p, fields, fields, clock.t, clock.t + DT,
                                                    rp, **HERO_ADAPTIVE))
    print(f"  {'raytrace_adaptive, one interval':45s} {interval_ms:8.3f} ms")

    # the paths the kernels replaced, for comparison
    rows, _, _ = _gather_patch_rows(T_pair, p, rp, grid.ny, grid.nx)
    rows_T, st7 = first_cut_inputs(T_pair, st, rp, **geo)
    print("  replaced by the pair-table and the table kernels:")
    for name, fn in (
            ("roll path (2 patch tables, cat, cast)",
             lambda: pair_table_torch(fields, fields, interp, rp.table_dtype)),
            ("row gather (floor, index_select, .float())",
             lambda: _gather_patch_rows(T_pair, p, rp, grid.ny, grid.nx)),
            ("transpose rows -> rows_T", lambda: rows.t().contiguous()),
            ("first-cut RK4 kernel (rows_T)",
             lambda: fused_substep(rows_T, st7, scal, rp=rp, interp=interp, da=1.0)),
            ("first-cut DP5(4) attempt kernel (rows_T)",
             lambda: fused_attempt(rows_T, st7, scal5, rp=rp, interp=interp)),
            ("first-cut RK4 path (gather to kernel)",
             lambda: fused_substep(*first_cut_inputs(T_pair, st, rp, **geo), scal, rp=rp,
                                   interp=interp, da=1.0))):
        print(f"    {name:43s} {time_ms(fn):8.3f} ms")


def host_ms(fn, reps: int = 5) -> float:
    """Median host wall milliseconds of ``fn()`` ended by a synchronize,
    the device idle before each call, after one warm-up call."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def outputs(interp: str, device) -> None:
    """The cost of a frame's outputs in the command line's driver."""
    grid, model, sol0, rp, psih_fn = make_case(512, interp, "bfloat16", device)
    p = lattice_packets(1024, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)
    drv = CoupledDriver(model=model, psih_fn=psih_fn, rp=rp, dt=DT, k_cutoff=K_CUTOFF, k0=K0,
                        packet_writer=DiscardingWriter(), log_fn=lambda line: None,
                        diagnostics={"kinetic_energy": lambda s, g, q: rsw.kinetic_energy(s, g),
                                     "potential_energy": rsw.potential_energy})
    drv.init(sol0, p)
    fields = drv.sim.fields

    def sample():
        return [p.x, p.y, p.k, p.l, *sample_velocity(p, fields, rp),
                *sample_gradients(p, fields, rp)]

    rows = sample()
    stacked = torch.stack(rows)
    host = stacked.cpu().numpy()
    parts = [
        ("sample u, v and 4 gradients at the packets", sample),
        ("stack 10 rows (10, N) float32", lambda: torch.stack(rows)),
        ("copy (10, N) float32 to the host (40 MB)", lambda: stacked.cpu()),
        ("cut 4 contiguous (N, 2|4) arrays on the host",
         lambda: [np.ascontiguousarray(host[a:b].T) for a, b in ((0, 2), (2, 4), (4, 6),
                                                                  (6, 10))]),
        ("whole packet telemetry (_write_packet_frame)", drv._write_packet_frame),
        ("snapshot: copy sol (3, 512, 257) complex64", lambda: drv.sim.sol.cpu().numpy()),
        ("two RSW diagnostics (_record_diagnostics)", lambda: drv._record_diagnostics(0)),
    ]
    for name, fn in parts:
        print(f"  {name:45s} {host_ms(fn):8.3f} ms")


def _profile(run_frame, name: str, trace_dir: str | None, host_ops: int = 0) -> None:
    """One warm-up call of ``run_frame``, then one under ``torch.profiler``:
    wall and device-busy time, device time by kernel, and (``host_ops``)
    the operators with the most host time of their own."""
    from torch.profiler import ProfilerActivity, profile

    run_frame()                             # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in events)
    print(f"  profiled frame: wall {wall_ms:.2f} ms, device busy {dev_us / 1e3:.2f} ms "
          f"({100 * dev_us / 1e3 / wall_ms:.1f}%), {sum(e.count for e in events)} kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    if host_ops:
        cpu = [e for e in averages if e.device_type.name == "CPU"]
        print(f"  host: {sum(e.self_cpu_time_total for e in cpu) / 1e3:.2f} ms of operator "
              f"time of their own; the most:")
        for e in sorted(cpu, key=lambda e: -e.self_cpu_time_total)[:host_ops]:
            print(f"  {e.self_cpu_time_total / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:90]}")
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, f"{name}.json")
        prof.export_chrome_trace(path)
        print(f"  chrome trace: {path}")


def profiled_frame(interp: str, ray_method: str, device, trace_dir: str | None) -> None:
    grid, model, sol0, rp, psih_fn = make_case(512, interp, "bfloat16", device)
    init, step = build_stepper(model, "IFMAB3", DT)
    frame = make_coupled_frame(model, step, psih_fn, rp, 5, k_cutoff=K_CUTOFF, k0=K0,
                               ray_method=ray_method, ray_opts=HERO_ADAPTIVE
                               if ray_method == "adaptive" else None)
    p = lattice_packets(1024, grid.Lx, grid.Ly, k0=K0, k_ring=True, device=device)
    sim = [SimState(sol0, zero_clock(device=device), init(sol0), p,
                    fields_from_psih(psih_fn(sol0), grid, interp))]

    def run_frame():
        sim[0] = frame(sim[0])

    _profile(run_frame, f"hero_{interp}_{ray_method}_frame", trace_dir,
             host_ops=12 if ray_method == "rk4" else 0)


def profiled_sharded_frame(interp: str, device, trace_dir: str | None) -> None:
    from juliaraytracingsw_tpu_torch.parallel.mesh import make_mesh, shard_packets
    from juliaraytracingsw_tpu_torch.parallel.sharded_rsw import ShardedRSW

    grid, model, sol0, rp, _ = make_case(512, interp, "bfloat16", device)
    mesh = make_mesh(device=device)
    sh = ShardedRSW(grid, model.params, mesh, dt=DT, interp=interp)
    init, _ = sh.stepper()
    frame = sh.make_coupled_frame(rp, 5, k_cutoff=K_CUTOFF, k0=K0)
    sol = sh.shard_solution(sol0)
    state = [(sol, zero_clock(device=device), init(sol),
              shard_packets(lattice_packets(1024, grid.Lx, grid.Ly, k0=K0, k_ring=True,
                                            device=device), mesh))]

    def run_frame():
        state[0] = frame(*state[0])

    calls = dict(mesh.counts)
    _profile(run_frame, f"hero_sharded1_{interp}_frame", trace_dir, host_ops=12)
    per_frame = {k: (v - calls.get(k, 0)) // 2 for k, v in mesh.counts.items()}
    print(f"  collectives a frame of 5 steps: {per_frame}")
    torch.distributed.destroy_process_group()


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
    print(f"hero {args.interp}, a frame's outputs in the command line's driver (host wall, "
          f"median of 5, no HDF5 write):")
    outputs(args.interp, device)
    print(f"hero {args.interp}, one {args.ray_method} frame of 5 coupled steps "
          f"(torch.profiler):")
    profiled_frame(args.interp, args.ray_method, device, args.trace)
    print(f"hero_sharded1 {args.interp}, one RK4 frame of 5 coupled steps on a mesh of one "
          f"over NCCL (torch.profiler):")
    profiled_sharded_frame(args.interp, device, args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
