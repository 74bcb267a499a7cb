"""ctypes binding of the native portal A* (``native/pf_native.cpp``).

The port's own copy of the A* half of ``permafrost_engine_tpu/utils/native.py``.
At first use it builds the repository's ``native/pf_native.cpp`` with g++
into the port's ``_build/`` (listed in ``.gitignore``), keyed by a hash of
the source, the flags and what ``-march=native`` means on this host (g++'s
predefined macros for it), so a build directory copied to a host with
another CPU is rebuilt there rather than loaded; it never writes
``native/libpf_native.so``. The library is an accelerator, not a
dependency: if it cannot be built or loaded, ``astar_csr`` returns None and
the caller runs its pure-Python A*.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "pf_native.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib = None
_failed = False


def _native_target() -> bytes:
    """g++'s predefined macros under ``-march=native`` on this host: the
    instruction-set extensions and tuning the build is specialised to."""
    return subprocess.run(["g++", *_FLAGS[:2], "-dM", "-E", "-x", "c++", "-"],
                          input=b"", check=True, capture_output=True,
                          timeout=60).stdout


def _build() -> str:
    """Path of the built library, compiling it if it is not there yet."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()
                                + _native_target()).hexdigest()[:16]
    so = os.path.join(_BUILD_DIR, f"libpf_native-{digest}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL | None:
    global _lib, _failed
    if _lib is not None or _failed:
        return _lib
    try:
        _lib = ctypes.CDLL(_build())
    except (OSError, subprocess.SubprocessError):
        _failed = True
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    _lib.astar_portals.restype = ctypes.c_int64
    _lib.astar_portals.argtypes = [
        ctypes.c_int64, i64p, i64p, f32p, f32p, f32p,
        i64p, f32p, ctypes.c_int64,
        i64p, f32p, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float, i64p, ctypes.c_int64]
    return _lib


def astar_csr(adj_off, adj_dst, adj_cost, node_r, node_c,
              start_ids, start_costs, goal_ids, goal_costs, goal_rc):
    """Native A* over a CSR portal graph; returns node path list or None
    (None also when the lib is unavailable — caller falls back)."""
    L = lib()
    if L is None:
        return None
    out = np.zeros(max(16, len(adj_off)), np.int64)
    n = L.astar_portals(
        len(adj_off) - 1,
        np.ascontiguousarray(adj_off, np.int64),
        np.ascontiguousarray(adj_dst, np.int64),
        np.ascontiguousarray(adj_cost, np.float32),
        np.ascontiguousarray(node_r, np.float32),
        np.ascontiguousarray(node_c, np.float32),
        np.ascontiguousarray(start_ids, np.int64),
        np.ascontiguousarray(start_costs, np.float32), len(start_ids),
        np.ascontiguousarray(goal_ids, np.int64),
        np.ascontiguousarray(goal_costs, np.float32), len(goal_ids),
        float(goal_rc[0]), float(goal_rc[1]), out, len(out))
    if n < 0:
        return "unreachable"
    return [int(x) for x in out[:n]]
