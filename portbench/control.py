"""Readings for the limits of ``correct``, on the card, in one process:
for each seed the program's gaps (set-up, then the window's frames up to
the checked pair, as ``run`` drives them), and for the control seeds the
control's: the reference put in the program's place one precision below
the configuration's (bfloat16 arithmetic, float8 e4m3 tables), each held
against the reference at the stated precisions.

    python3 -m portbench.control --workload <cell> --seeds <n> ... \\
        --control-seeds <n> ... --out <file.jsonl>
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time

__all__ = ["readings", "main"]


def readings(cell, seeds, control_seeds, device: str = "cuda", out=None):
    """Yield {seed, program: gaps, control: gaps | None} per seed."""
    import torch

    from .cells import Program, snapshot
    from .check import (Follower, audit_events, gaps_events, gaps_start, gaps_window,
                        observed_events, packet_rows, prec_of)
    from .run import attempts_of, births_of, set_up

    cfg, tr = cell.config, cell.traffic
    prog = Program(cfg, tr, seeds[0], device, log_fn=lambda line: None)
    ref = Follower(cfg, tr, device, prog.dt, prog.nu, prec_of(cfg))
    ctl = Follower(cfg, tr, device, prog.dt, prog.nu, prec_of(cfg).lower())
    setup_steps = tr.get("spinup_steps", 0) + tr["warmup_frames"] * tr["steps_per_frame"]
    dx = cfg["L"] / cfg["nx"]
    adaptive = cell.coupled and tr.get("ray_method", "rk4") != "rk4"
    for seed in seeds:
        t0 = time.perf_counter()
        sol0, start = set_up(prog, seed)
        j = random.Random(seed).randrange(*tr["check_frames"])
        for i in range(j + 2):
            if i == j:
                snap_in, n0 = snapshot(prog.sim), len(prog.infos)
            prog.frame()
        snap_out, n1 = snapshot(prog.sim), len(prog.infos)
        attempts = attempts_of(prog.infos[n0:n1]) if adaptive else None
        ref_start = ref.setup(sol0, setup_steps)
        ref_w = ref.frames(snap_in, 2)
        out_st, observed = packet_rows(snap_out.packets), observed_events(ref, snap_out)
        row = {"seed": seed, "frame": j,
               "program": {**gaps_start(start.sol, ref_start, sol0),
                           **gaps_window(snap_out.sol, out_st, ref_w, snap_in.sol, dx,
                                         cell.coupled, attempts),
                           **gaps_events(ref, ref_w, observed, out_st)},
               "excluded": int(ref_w[2].sum()), "marked": dict(ref.marked),
               "audit": audit_events(ref, ref_w, observed),
               "births": births_of(snap_out) - births_of(snap_in), "control": None}
        if seed in control_seeds:
            c_sol, c_st, _, c_acc, c_rej = ctl.frames(snap_in, 2)
            row["control"] = {**gaps_start(ctl.setup(sol0, setup_steps), ref_start, sol0),
                              **gaps_window(c_sol, c_st, ref_w, snap_in.sol, dx, cell.coupled,
                                            (c_acc, c_rej) if adaptive else None),
                              **gaps_events(ref, ref_w, ctl.states, c_st)}
        row["seconds"] = time.perf_counter() - t0
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from .spec import load_cell

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    seeds = list(dict.fromkeys(args.seeds + args.control_seeds))
    out = open(args.out, "a") if args.out else None
    try:
        for row in readings(cell, seeds, set(args.control_seeds)):
            line = json.dumps({"workload": cell.name, **row})
            print(line, flush=True)
            if out:
                print(line, file=out, flush=True)
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
