"""Builds the port's CUDA kernels from the sources in ``ray_tpu_torch/csrc``
and loads them with ctypes.

The build runs at first use, never at import: ``nvcc`` compiles each source
for ``sm_90a`` into a shared library with a plain C interface, under
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``),
named by a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_locks: Dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# what each build printed (ptxas registers and spills)
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc was not found: the port's CUDA kernels are "
                       "built on the machine with the card")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process.
    Each source has its own lock, so two sources build at the same time."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        so = library_path(name)
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                capture_output=True, text=True)
            build_log[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {name}.cu "
                    f"(exit {proc.returncode}):\n{build_log[name]}")
            os.replace(tmp, so)  # atomic: a concurrent build loses nothing
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib
