"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exports a plain C interface and is compiled on its own
with `nvcc` for `sm_90a` into a shared library under `build/kernels/` at the
repository root (git-ignored).  The library's file name carries a digest of
the sources and flags, so a stale build is never loaded.  Sources come only
from `csrc/` in this package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "build_logs", "load"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # kernels are first called from several threads
build_logs: dict[str, str] = {}  # kernel name -> nvcc/ptxas output of its build


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "at first use and need the CUDA toolkit"
    )


def _library(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no kernel source {src}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(SRC_DIR.iterdir()):  # headers are shared by every source
        digest.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names) -> dict[str, float]:
    """Compile the named kernels that are not built yet, all nvcc processes
    started together.  Returns the seconds each build took (0.0 if cached)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    secs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = _library(name)
        secs[name] = 0.0
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, lib)
    for name, (proc, tmp, lib) in jobs.items():
        out, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        build_logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{out}")
        os.replace(tmp, lib)
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                build([name])
                lib = _loaded[name] = ctypes.CDLL(str(_library(name)))
    return lib
