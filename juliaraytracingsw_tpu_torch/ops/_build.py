"""Build and load the package's CUDA kernels.

The sources are ``csrc/*.cu`` of this package and nothing else. They are
compiled at first use by ``nvcc`` into one shared library with a plain C
interface (loaded with ``ctypes``), under ``_build/`` beside the package,
keyed by a hash of the sources and flags, so a fresh checkout builds once
and later processes reuse the library.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "BuildInfo", "build_info", "find_nvcc", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# IEEE sqrt and division (no --use_fast_math): the kernel matches its
# plain PyTorch twin up to FMA contraction
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildInfo:
    """What :func:`load_library` did in this process: the library path, the
    nvcc command and its ``-Xptxas -v`` report, and the seconds the compile
    took (command None when a library built earlier was reused)."""

    path: Path | None = None
    command: list | None = None
    seconds: float = 0.0
    ptxas_report: str = ""


build_info = BuildInfo()
_LIB: ctypes.CDLL | None = None


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of "
        "juliaraytracingsw_tpu_torch are compiled at first use and need the "
        "CUDA toolkit")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernels' shared library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    srcs = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    lib_path = BUILD_DIR / f"libjrsw_kernels_{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a temporary name and rename, so a concurrent or
        # interrupted build never leaves a half-written library behind
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, srcs)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info.seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}")
        os.replace(tmp, lib_path)
        build_info.command = cmd
        build_info.ptxas_report = proc.stderr
    build_info.path = lib_path
    _LIB = ctypes.CDLL(str(lib_path))
    return _LIB
