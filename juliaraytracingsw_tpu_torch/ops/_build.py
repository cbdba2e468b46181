"""Build and load the package's CUDA kernels.

The sources are ``csrc/*.cu`` (and the ``csrc/*.cuh`` they include) of this
package and nothing else. At first use ``nvcc`` compiles every ``.cu`` at
once, one process each, and links the objects into one shared library with
a plain C interface (loaded with ``ctypes``), under ``_build/`` beside the
package, keyed by a hash of the sources and flags, so a fresh checkout
builds once and later processes reuse the library.
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

__all__ = ["ARCH", "NVCC_FLAGS", "BuildInfo", "build_info", "find_nvcc", "load_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# IEEE sqrt and division (no --use_fast_math): a kernel matches its plain
# PyTorch twin up to FMA contraction
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass
class BuildInfo:
    """What :func:`load_library` did in this process: the library path, the
    nvcc commands (one compile per source, then the link) and their
    ``-Xptxas -v`` reports, and the seconds the build took (commands None
    when a library built earlier was reused)."""

    path: Path | None = None
    commands: list | None = None
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
        # build in a temporary directory and rename the library into place,
        # so a concurrent or interrupted build never leaves a half-written
        # library behind. The compiles run side by side, so the build takes
        # about the longest one (on an 8-core H100 host: 37.8-43.1 s, against
        # 46.2-60.2 s for one nvcc over all sources)
        work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
        try:
            nvcc = find_nvcc()
            objs = [work / f"{s.stem}.o" for s in srcs]
            compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                        for s, o in zip(srcs, objs)]
            link = [nvcc, *ARCH, "-shared", "-o", str(work / "lib.so"), *map(str, objs)]
            t0 = time.perf_counter()
            procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True) for cmd in compiles]
            reports = []
            for cmd, proc in zip(compiles, procs):
                _, err = proc.communicate()
                reports.append((cmd, proc.returncode, err))
            if all(rc == 0 for _, rc, _ in reports):
                proc = subprocess.run(link, capture_output=True, text=True)
                reports.append((link, proc.returncode, proc.stderr))
            build_info.seconds = time.perf_counter() - t0
            for cmd, rc, err in reports:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(cmd)}\n{err}")
            os.replace(work / "lib.so", lib_path)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        build_info.commands = compiles + [link]
        build_info.ptxas_report = "".join(err for _, _, err in reports)
    build_info.path = lib_path
    _LIB = ctypes.CDLL(str(lib_path))
    return _LIB
