"""Run one cell of the benchmark once, in this process, and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (from the process's start): the program's set-up through its
command line, the benchmark's inputs made on the card from the seed, the
cell's spin-up and warm-up frames. Then the window: frames back to back
for ``--seconds`` (``--trace 1``: the traffic mix's ``trace_frames``
frames under ``torch.profiler``). Then the device's peak memory is read,
the program's state freed, and the reference decides ``correct``
(``portbench/check``). The last line of standard output is the result;
the last lines of standard error are the numbers compared, each beside its
limit. Without CUDA, or with fewer cards than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, it prints no
result and exits with a code other than 0.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import random
import statistics
import sys
import time
from pathlib import Path

__all__ = ["main", "run_cell", "set_up", "attempts_of", "births_of", "FORBIDDEN"]

# top-level module names the run may not hold (the JAX package is the
# reference of the port, never measured)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "juliaraytracingsw_tpu"})
ROOT = Path(__file__).resolve().parent.parent
# the run's own files: the driver's log and PyTorch's kernel cache, at
# fixed paths inside the checkout
OUT_DIR = ROOT / ".portbench"


def _process_start() -> float:
    """``time.perf_counter()``'s reading at this process's start."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & FORBIDDEN)


def _sync(device: str):
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def _held_rows(st, cfg) -> int:
    """Cells of the grid that hold a packet."""
    import torch

    n, dx = cfg["nx"], cfg["L"] / cfg["nx"]
    step = torch.full((), dx, dtype=st.dtype, device=st.device)
    bx = torch.remainder(torch.floor((st[0] + cfg["L"] / 2) / step).to(torch.int64), n)
    by = torch.remainder(torch.floor((st[1] + cfg["L"] / 2) / step).to(torch.int64), n)
    return int(torch.unique(by * n + bx).numel())


def attempts_of(infos) -> tuple[int, int]:
    """(accepted, rejected) attempts over the adaptive steps' infos."""
    acc = sum(int(i["n_accepted"]) for i in infos)
    rej = sum(int(i["n_rejected"]) for i in infos)
    return acc, rej


def births_of(sim) -> int:
    """The program's running count of rebirths (0 without birth/death); a
    read waits for the device."""
    return 0 if sim.bd is None else int(sim.bd.births)


def set_up(prog, seed: int):
    """The program from the seed's inputs through the traffic mix's spin-up
    and warm-up frames -> (the initial flow, a copy of the state after)."""
    from .cells import snapshot

    tr = prog.traffic
    sol0, _ = prog.init(seed)
    prog.spinup(tr.get("spinup_steps", 0))
    for _ in range(tr["warmup_frames"]):
        prog.frame()
    return sol0, snapshot(prog.sim)


def run_cell(cell, bench: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, log_fn=None) -> tuple[dict, dict]:
    """One run of ``cell`` -> (result, {gap: (value, limit)})."""
    import torch

    from .cells import Program, copy_into, snapshot
    from .check import (Follower, packet_rows, gaps_events, gaps_start, gaps_window, judge,
                        observed_events, prec_of, reference_parts)
    from .spec import metrics_for, reader

    t_start = _process_start() if t_start is None else t_start
    cfg, tr = cell.config, cell.traffic
    e2e, per_layer = metrics_for(bench, cell.name)
    # the reference's interpolant and events, found before any work: a
    # part with no file stops the run here
    reference_parts(cfg)

    # --- set-up ----------------------------------------------------------------
    prog = Program(cfg, tr, seed, device, log_fn=log_fn or (lambda line: None))
    sol0, start_snap = set_up(prog, seed)
    _sync(device)
    # the checked frames' copies, allocated here so that the window
    # allocates nothing of the benchmark's
    bufs = {"in": snapshot(prog.sim), "out": snapshot(prog.sim)}
    setup_steps = tr.get("spinup_steps", 0) + tr["warmup_frames"] * tr["steps_per_frame"]
    lo, hi = tr["check_frames"]
    j = random.Random(seed).randrange(lo, hi)
    snaps: dict = {}

    def frames(count: int | None, until: float | None, marks: list, keep_infos=False):
        """Frames back to back; frame ``j``'s input and frame ``j + 1``'s
        output are copied for the check."""
        i = 0
        while True:
            if i == j:
                snaps["in"], snaps["infos0"] = copy_into(bufs["in"], prog.sim), len(prog.infos)
            prog.frame(keep_infos or i in (j, j + 1))
            if i == j + 1:
                snaps["out"], snaps["infos1"] = copy_into(bufs["out"], prog.sim), len(prog.infos)
            i += 1
            marks.append(time.perf_counter())
            if count is not None and i >= count:
                return
            if until is not None and marks[-1] - marks[0] >= until and i >= j + 2:
                return

    metrics, breakdown, device_info = {}, None, {}
    units = {m["name"]: m["unit"] for m in e2e + per_layer}
    n_frames = 0
    if not trace:
        births0 = births_of(prog.sim)
        marks = [time.perf_counter()]
        setup_s = marks[0] - t_start
        frames(None, seconds, marks)
        n_frames = len(marks) - 1
        steps = n_frames * tr["steps_per_frame"]
        frame_ms = [1e3 * (b - a) for a, b in zip(marks[:-1], marks[1:])]
        window = marks[-1] - marks[0]
        q = statistics.quantiles(frame_ms, n=20) if len(frame_ms) > 1 else frame_ms * 19
        values = {"setup_s": setup_s, "steps_per_s": steps / window, "frame_ms_p95": q[18]}
        quarters = [sum(1 for m in marks[1:] if a < m - marks[0] <= a + window / 4)
                    * tr["steps_per_frame"] / (window / 4)
                    for a in (0, window / 4, window / 2, 3 * window / 4)]
        print(f"window: {n_frames} frames, {steps} steps in {window!r} s; set-up {setup_s!r} s; "
              f"frame ms p5 {q[0]!r} median {statistics.median(frame_ms)!r} p95 {q[18]!r} "
              f"max {max(frame_ms)!r}; steps/s by quarter {[round(v, 1) for v in quarters]}; "
              f"births {births_of(prog.sim) - births0}", file=sys.stderr)
    else:
        from juliaraytracingsw_tpu_torch.ops import ray_step

        from .trace import profile_frames

        if tr["trace_frames"] < hi + 1:
            raise ValueError("trace_frames must cover the checked frames")
        rows0 = _held_rows(packet_rows(prog.sim.packets), cfg)
        launches0 = (sum(ray_step.table_launches.values()),
                     sum(ray_step.table_attempt_launches.values()))
        infos0, births0 = len(prog.infos), births_of(prog.sim)
        summary = profile_frames(lambda n: frames(n, None, [time.perf_counter()], True),
                                 tr["trace_frames"])
        n_frames = tr["trace_frames"]
        acc, rej = attempts_of(prog.infos[infos0:])
        summary.update(
            frames=n_frames, steps=n_frames * tr["steps_per_frame"],
            held_rows=0.5 * (rows0 + _held_rows(packet_rows(prog.sim.packets), cfg)),
            n_packets=int(prog.sim.packets.x.shape[0]), coupled=cell.coupled,
            nx=cfg["nx"], interp=cfg["rays"]["interp"],
            table_dtype=cfg["rays"]["table_dtype"], ray_method=tr.get("ray_method"),
            counters=dict(table_launches=sum(ray_step.table_launches.values()) - launches0[0],
                          table_attempt_launches=sum(ray_step.table_attempt_launches.values())
                          - launches0[1],
                          attempts_accepted=acc, attempts_rejected=rej,
                          births=births_of(prog.sim) - births0))
        values = {}
        for m in per_layer:
            v = reader(m["name"])(summary, cell)
            if v is not None:
                values[m["name"]] = v
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        top = sorted(summary["device_ops"].items(), key=lambda kv: -kv[1][1])[:10]
        breakdown = {"device_ops": [[name[:200], s] for name, (_, s) in top],
                     "idle_gaps": [[name[:200], s] for name, s in summary["idle_gaps"][:10]]}
        print(f"traced window: {n_frames} frames, {summary['window_s']!r} s (host clock "
              f"{summary['host_window_s']!r} s), device busy {summary['busy_s']!r} s, "
              f"{summary['launch_calls']} launch calls, counters {summary['counters']}",
              file=sys.stderr)
        for name, (count, s) in top:
            print(f"device op {s!r} s x{count} {name[:160]}", file=sys.stderr)

    is_cuda = device.startswith("cuda")
    peak = int(torch.cuda.max_memory_allocated()) if is_cuda else 0
    if not trace:
        values["peak_mem_gib"] = peak / 2**30
    for name, v in values.items():
        if name in units:
            metrics[name] = {"value": v, "unit": units[name]}
    attempts = None
    if tr.get("ray_method", "rk4") != "rk4" and cell.coupled:
        attempts = attempts_of(prog.infos[snaps["infos0"]:snaps["infos1"]])
    dt, nu = prog.dt, prog.nu
    prog.free()
    del prog
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()

    # --- correct -----------------------------------------------------------------
    ref = Follower(cfg, tr, device, dt, nu, prec_of(cfg))
    gaps = gaps_start(start_snap.sol, ref.setup(sol0, setup_steps), sol0)
    snap_in, snap_out = snaps["in"], snaps["out"]
    ref_w = ref.frames(snap_in, 2)
    out_st = packet_rows(snap_out.packets)
    gaps.update(gaps_window(snap_out.sol, out_st, ref_w, snap_in.sol, cfg["L"] / cfg["nx"],
                            cell.coupled, attempts))
    gaps.update(gaps_events(ref, ref_w, observed_events(ref, snap_out), out_st))
    if ref.marked:
        print(f"left out as ambiguous, by event: {ref.marked}", file=sys.stderr)
    limits = cell.limits
    correct = judge(gaps, limits)
    device_info = dict(platform="gpu" if is_cuda else "cpu",
                       kind=torch.cuda.get_device_name() if is_cuda else "cpu",
                       count=cell.entry["chips"], memory_peak_bytes=peak, **device_info)
    result = {"correct": correct, "attempted": n_frames, "failed": 0, "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    checks = {name: (g, limits.get(name)) for name, g in gaps.items()}
    result["checks"] = {name: {"value": g, "limit": lim} for name, (g, lim) in checks.items()}
    return result, checks


def main(argv=None) -> int:
    t_start = _process_start()
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    kernels = OUT_DIR / "torch_kernels"
    kernels.mkdir(parents=True, exist_ok=True)
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(kernels)

    import torch

    from .spec import load_benchmark, load_cell

    bench = load_benchmark(ROOT)
    cell = load_cell(args.workload, bench)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: {cell.name} needs {cell.entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    with open(OUT_DIR / f"{cell.name}.log", "w") as log:
        result, checks = run_cell(cell, bench, args.seed, args.seconds, bool(args.trace),
                                  "cuda", t_start, lambda line: print(line, file=log))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
