"""Build-on-demand loader for the native calibration kernels.

Compiles `histogram.cpp` with g++ into a cached shared object (keyed by a
source hash, so edits rebuild automatically) and binds it with ctypes —
no pybind11 dependency. Falls back silently to None when no compiler is
available; callers keep a pure-numpy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "histogram.cpp")
_lib = None
_tried = False


def _cache_dir() -> str:
    d = os.environ.get("TEAL_NATIVE_CACHE") or os.path.join(
        tempfile.gettempdir(), f"teal_jax_native_{os.getuid()}"
    )
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"histogram_{tag}.so")
    if os.path.exists(out):
        return out
    tmp = out + f".tmp{os.getpid()}"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    for flags in (["-march=native", "-fopenmp"], ["-fopenmp"], []):
        cmd = base[:1] + flags + base[1:]
        try:
            r = subprocess.run(cmd, capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if r.returncode == 0:
            os.replace(tmp, out)
            return out
    return None


def get_lib():
    """The loaded native library, or None (no compiler / build failure)."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("TEAL_NO_NATIVE"):
        return None
    path = _build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.teal_order_stats.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
    ]
    lib.teal_order_stats.restype = None
    lib.teal_histogram_count.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.teal_histogram_count.restype = None
    _lib = lib
    return _lib
