"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ctypes.
The build runs at first use, into ``_build/`` inside the package (listed in
``.gitignore``), and is keyed by a hash of the source and flags, so an edited
source rebuilds and an unchanged one loads at once. Nothing here runs when
the module is imported.

Every kernel is built with ``-fmad=false``: no multiply-add is contracted
into an FMA, so each float expression rounds where the plain PyTorch
versions round (see the notes at the top of each source).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# name -> loaded library; name -> (build seconds, ptxas report)
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict[str, tuple[float, str]] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        res = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
        os.replace(tmp, so)
        BUILD_INFO[name] = (time.perf_counter() - t0, res.stderr)
    lib = ctypes.CDLL(so)
    lib.pf_cuda_error_string.restype = ctypes.c_char_p
    lib.pf_cuda_error_string.argtypes = [ctypes.c_int]
    _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib.pf_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
