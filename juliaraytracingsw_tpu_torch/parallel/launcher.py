"""Multi-process launch and sweep orchestration (port of
``parallel/launcher.py``).

Two independent layers, as in the reference:

1. **One job over many processes**, one per GPU: every process runs the
   same program and ``torch.distributed`` joins them into one process
   group (NCCL on the card, gloo on the CPU), whose collectives carry the
   sharded flow's transposes and gathers (``parallel/sharded``).
   ``resolve_cluster`` derives (coordinator, number of processes, rank)
   from the scheduler's environment, in the reference's order:

   - explicit ``JRSW_COORDINATOR`` / ``JRSW_NUM_PROCESSES`` /
     ``JRSW_PROCESS_ID``;
   - TPU pod metadata (``TPU_WORKER_HOSTNAMES``, ``CLOUD_TPU_TASK_ID``),
     resolved as the reference resolves it; ``initialize_from_env``
     refuses a multi-host TPU slice, which has no counterpart here;
   - SLURM (``SLURM_STEP_NODELIST``/``SLURM_JOB_NODELIST``,
     ``SLURM_NTASKS``, ``SLURM_PROCID``), the coordinator the first host
     of the node list at ``JRSW_PORT`` (8476);
   - OpenMPI (``OMPI_COMM_WORLD_SIZE``/``RANK``) under ``mpirun``, with
     ``JRSW_COORDINATOR`` set on every rank.

   ``python -m juliaraytracingsw_tpu_torch.experiments <cmd> --sharded
   --distributed`` under ``srun`` or ``mpirun`` runs one such job.

2. **Embarrassingly parallel parameter sweeps**: independent runs, one
   per row of a parameter table (the reference's SLURM job arrays over
   parameters.txt). ``launch_sweep`` runs them as local subprocesses with
   bounded concurrency; under SLURM each array task picks its row with
   ``sweep_row_from_env`` (``SLURM_ARRAY_TASK_ID``, 1-based) or an
   explicit ``JRSW_SWEEP_INDEX`` (0-based).
"""
from __future__ import annotations

import os
import re
import subprocess
import sys
from dataclasses import dataclass

import torch

__all__ = ["ClusterSpec", "resolve_cluster", "initialize_from_env",
           "sweep_row_from_env", "launch_sweep"]


@dataclass(frozen=True)
class ClusterSpec:
    """Resolved multi-process topology. ``coordinator`` is None where
    nothing names one (a single process, a TPU pod's own discovery)."""

    coordinator: str | None
    num_processes: int
    process_id: int
    source: str   # 'explicit' | 'slurm' | 'mpi' | 'single' | 'tpu-auto'


def _first_slurm_host(nodelist: str) -> str:
    """First hostname of a SLURM nodelist, expanding one bracket group:
    ``gpu-[003-010,12]`` -> ``gpu-003``. Pure string logic (no
    ``scontrol``), so it is testable off a cluster."""
    first = nodelist.split(",")[0] if "[" not in nodelist else nodelist
    m = re.match(r"([^\[,]+)\[([^\]]+)\]", first)
    if not m:
        return first.split(",")[0]
    prefix, body = m.groups()
    tok = body.split(",")[0].split("-")[0]
    return prefix + tok


def resolve_cluster(env: dict | None = None) -> ClusterSpec:
    """Derive the process topology from the environment (pure; testable)."""
    env = os.environ if env is None else env
    if "JRSW_NUM_PROCESSES" in env:
        n = int(env["JRSW_NUM_PROCESSES"])
        return ClusterSpec(
            coordinator=env.get("JRSW_COORDINATOR"),
            num_processes=n,
            process_id=int(env.get("JRSW_PROCESS_ID", "0")),
            source="explicit",
        )
    if "TPU_WORKER_HOSTNAMES" in env or "CLOUD_TPU_TASK_ID" in env:
        # a TPU pod configures itself, but only a multi-host slice: a
        # single-entry hostname list is one process
        hosts = [h for h in env.get("TPU_WORKER_HOSTNAMES", "").split(",") if h]
        if len(hosts) <= 1 and "CLOUD_TPU_TASK_ID" not in env:
            return ClusterSpec(None, 1, 0, source="single")
        return ClusterSpec(None, -1, -1, source="tpu-auto")
    if "SLURM_PROCID" in env and int(env.get("SLURM_NTASKS", "1")) > 1:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_JOB_NODELIST", ""))
        port = env.get("JRSW_PORT", "8476")
        return ClusterSpec(
            coordinator=f"{_first_slurm_host(nodelist)}:{port}",
            num_processes=int(env["SLURM_NTASKS"]),
            process_id=int(env["SLURM_PROCID"]),
            source="slurm",
        )
    if int(env.get("OMPI_COMM_WORLD_SIZE", "1")) > 1:
        coord = env.get("JRSW_COORDINATOR")
        if coord is None:
            raise RuntimeError(
                "mpirun detected but no coordinator address; set "
                "JRSW_COORDINATOR=host:port on every rank"
            )
        return ClusterSpec(
            coordinator=coord,
            num_processes=int(env["OMPI_COMM_WORLD_SIZE"]),
            process_id=int(env["OMPI_COMM_WORLD_RANK"]),
            source="mpi",
        )
    return ClusterSpec(None, 1, 0, source="single")


def initialize_from_env(env: dict | None = None, *,
                        device: torch.device | str = "cuda") -> ClusterSpec:
    """Resolve the topology and bring up the default process group:
    ``init_process_group(init_method='tcp://<coordinator>', world_size,
    rank)`` (``env://`` where no coordinator is named), NCCL for
    ``device='cuda'`` (each rank on ``cuda:<rank % device_count>``), gloo
    for the CPU. A single process is a no-op; a TPU pod raises. Returns
    the resolved spec."""
    from .mesh import init_distributed

    spec = resolve_cluster(env)
    if spec.source == "single":
        return spec
    if spec.source == "tpu-auto":
        raise RuntimeError("a multi-host TPU slice has no counterpart in the PyTorch "
                           "port: launch one process per GPU under SLURM or mpirun, or "
                           "set JRSW_COORDINATOR/JRSW_NUM_PROCESSES/JRSW_PROCESS_ID")
    init_distributed(spec.coordinator, spec.num_processes, spec.process_id, device=device)
    return spec


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
