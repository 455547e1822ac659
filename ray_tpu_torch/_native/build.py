"""On-demand compile + ctypes load for the native components.

No pybind11/setuptools in the loop: `g++ -O2 -shared -fPIC` into a
content-addressed cache, one compile per source hash per machine. A
failed/missing toolchain returns None and callers use their Python
fallbacks (the build must never take down a daemon).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_lock = threading.Lock()
_cache: dict = {}


def _cache_dir() -> str:
    d = os.environ.get("RAY_TPU_TORCH_NATIVE_CACHE", "")
    if not d:
        d = os.path.join(os.path.expanduser("~"), ".cache",
                         "ray_tpu_torch_native")
    os.makedirs(d, exist_ok=True)
    return d


def load_library(name: str) -> Optional[ctypes.CDLL]:
    """Compile (if needed) and dlopen ray_tpu_torch/_native/<name>.cpp."""
    with _lock:
        if name in _cache:
            return _cache[name]
        lib = _build_and_load(name)
        _cache[name] = lib
        return lib


def _build_and_load(name: str) -> Optional[ctypes.CDLL]:
    src = os.path.join(_HERE, f"{name}.cpp")
    if not os.path.exists(src):
        return None
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_cache_dir(), f"{name}-{digest}.so")
    if not os.path.exists(so_path):
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
               "-o", tmp, src]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=120)
        except (OSError, subprocess.TimeoutExpired) as e:
            logger.warning("native %s build unavailable: %s", name, e)
            return None
        if proc.returncode != 0:
            logger.warning("native %s build failed:\n%s", name,
                           proc.stderr[-2000:])
            return None
        os.replace(tmp, so_path)
    try:
        return ctypes.CDLL(so_path)
    except OSError as e:
        logger.warning("native %s load failed: %s", name, e)
        return None


def native_available(name: str) -> bool:
    return load_library(name) is not None
