"""Build and load the package's CUDA kernels (plain-C shared libraries).

Each `csrc/*.cu` file compiles with nvcc for sm_90a into its own shared
library under `build/kernels/` at the repository root, at first use, and
loads with ctypes.  A library is rebuilt when its source, or a shared
`csrc/*.cuh` header, is newer.  All sources compile in parallel (one nvcc
each).  ptxas reports each kernel's registers, shared memory and spills
(-Xptxas -v); build_all returns that report.  Nothing here runs at import
time: the CPU tests import every module of the package and have no nvcc.

Never add --use_fast_math or -prec-div=false: the kernels divide to find
voxel coordinates, and a reciprocal multiply flips voxel boundaries.
SOURCE_FLAGS adds a source's own flags (imu_stage: -fmad=false).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["build_all", "load", "BUILD_DIR", "SOURCES"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = sorted(p.stem for p in CSRC.glob("*.cu"))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per source: imu_stage rounds where its plain PyTorch version does, whose
# elementwise products and sums are separate kernels (no contraction into
# fused multiply-adds); its matrix products call fma themselves
SOURCE_FLAGS = {"imu_stage": ["-fmad=false"]}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if not cand.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(cand)


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """The library is missing or older than its source or a shared
    csrc/*.cuh header."""
    lib = _lib_path(name)
    srcs = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return (not lib.exists()
            or lib.stat().st_mtime < max(p.stat().st_mtime for p in srcs))


def build_all(names=None, force: bool = False) -> dict[str, str]:
    """Compile the named sources (default: all; only the stale ones unless
    `force`), one nvcc per source, all started together.  Returns the
    compiler's output (the ptxas report) of each source compiled; raises
    with it on failure."""
    names = [n for n in (names or SOURCES) if force or _stale(n)]
    if not names:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors, reports = [], {}
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {name}.cu:\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
            reports[name] = out
    if errors:
        raise RuntimeError("\n".join(errors))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib
