"""Sweep orchestration (port of the sweep half of ``parallel/launcher.py``).

Embarrassingly parallel parameter sweeps: independent runs, one per row
of a parameter table (the reference's SLURM job arrays over
parameters.txt). ``launch_sweep`` runs them as local subprocesses with
bounded concurrency; under SLURM each array task picks its row with
``sweep_row_from_env`` (``SLURM_ARRAY_TASK_ID``, 1-based) or an explicit
``JRSW_SWEEP_INDEX`` (0-based).

The cluster half (``resolve_cluster``, ``initialize_from_env``: one job
over many processes through ``torch.distributed``) is not ported yet and
raises ``NotImplementedError`` naming ROADMAP queue 1, item 13.
"""
from __future__ import annotations

import os
import subprocess
import sys

__all__ = ["resolve_cluster", "initialize_from_env", "sweep_row_from_env", "launch_sweep"]


def _cluster_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} (one job over many processes) is not ported to "
        "juliaraytracingsw_tpu_torch yet (ROADMAP queue 1, item 13)")


def resolve_cluster(env: dict | None = None):
    raise _cluster_not_ported("resolve_cluster")


def initialize_from_env(env: dict | None = None):
    raise _cluster_not_ported("initialize_from_env")


# --- parameter sweeps (job-array replacement) --------------------------------

def sweep_row_from_env(rows: list[dict], env: dict | None = None) -> dict:
    """Pick this task's sweep row under a SLURM job array
    (``SLURM_ARRAY_TASK_ID``, 1-based like the reference's parameters.txt
    lookup) or an explicit ``JRSW_SWEEP_INDEX`` (0-based)."""
    env = os.environ if env is None else env
    if "JRSW_SWEEP_INDEX" in env:
        return rows[int(env["JRSW_SWEEP_INDEX"])]
    if "SLURM_ARRAY_TASK_ID" in env:
        return rows[int(env["SLURM_ARRAY_TASK_ID"]) - 1]
    raise RuntimeError("no sweep index in environment "
                       "(JRSW_SWEEP_INDEX or SLURM_ARRAY_TASK_ID)")


def launch_sweep(base_cmd: list[str], rows: list[dict], out_root: str,
                 max_parallel: int = 1, env_extra: dict | None = None,
                 dry_run: bool = False, out_flag: str | None = "--out") -> list[int]:
    """Run one subprocess per sweep row with bounded concurrency.

    Each child gets ``JRSW_SWEEP_INDEX=i``, a per-row ``<out_flag>``
    directory (omitted when ``out_flag=None`` for tasks that share one
    output dir, e.g. omega-k k-range fan-out), and the row's key/values
    appended as ``--key value`` CLI overrides — the local stand-in for a
    SLURM array over parameters.txt. Returns the list of return codes
    (ordered by row)."""
    os.makedirs(out_root, exist_ok=True)
    cmds, envs = [], []
    for i, row in enumerate(rows):
        cmd = list(base_cmd)
        if out_flag is not None:
            cmd += [out_flag, os.path.join(out_root, f"run{i:03d}")]
        for k, v in row.items():
            cmd += [f"--{k.replace('_', '-')}", str(v)]
        e = dict(os.environ, JRSW_SWEEP_INDEX=str(i), **(env_extra or {}))
        cmds.append(cmd)
        envs.append(e)
    if dry_run:
        for c in cmds:
            print(" ".join(c))
        return [0] * len(cmds)
    rcs: list[int | None] = [None] * len(cmds)
    running: list[tuple[int, subprocess.Popen]] = []
    nxt = 0
    while nxt < len(cmds) or running:
        while nxt < len(cmds) and len(running) < max_parallel:
            with open(os.path.join(out_root, f"run{nxt:03d}.log"), "w") as log:
                p = subprocess.Popen(cmds[nxt], env=envs[nxt],
                                     stdout=log, stderr=subprocess.STDOUT)
            running.append((nxt, p))
            nxt += 1
        idx, p = running.pop(0)
        rcs[idx] = p.wait()
        if rcs[idx] != 0:
            print(f"sweep run{idx:03d} exited rc={rcs[idx]}", file=sys.stderr)
    return [rc if rc is not None else -1 for rc in rcs]
