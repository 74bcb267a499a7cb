"""Kernel K2: batched flow-field integration on the card, for 64x64 chunks
and whole maps.

Counterpart of ``permafrost_engine_tpu/ops/flowfield_pallas.py``
(``integrate_pallas``) and of the whole-map ``ff.integrate`` the JAX
package runs on XLA for its chase fields. The kernel is
``csrc/integrate.cu`` (one thread-block cluster per field); its plain
PyTorch version is ``ops/flowfield.integrate_plain``. ``integrate`` is the
port's single integration entry (path requests, field installs,
portal-graph builds, chase fields): CPU tensors take the plain version,
CUDA tensors launch the kernel, and anything else raises. A shape no
cluster can hold raises on every device.
"""

from __future__ import annotations

import ctypes

import torch

from permafrost_engine_tpu_torch.core.config import FIELD_RES
from permafrost_engine_tpu_torch.ops import cuda_build
from permafrost_engine_tpu_torch.ops.flowfield import integrate_plain

# launches of the CUDA kernel (not of the plain version), by shape class:
# 64x64 chunks (path requests, installs, portal graphs) and whole maps
launches_chunk = 0
launches_map = 0

MAX_CLUSTER = 16            # blocks per cluster (above 8: non-portable)
MAX_THREADS = 1024
SMEM_BYTES = 232448         # shared memory one block may use (227 KB)

_bound = None


def plan(h: int, w: int) -> tuple[int, int, int, int]:
    """How K2 cuts an h x w field: (blocks per cluster P, rows per thread
    M, threads per block, shared bytes per block). Each block holds H/P
    rows, double-buffered in f32 with a one-tile halo; each thread owns M
    rows of one column. P gives 16-row strips (4 blocks for a chunk, 16 for
    a 256x256 map, at most 16), and M is the first of 4, 8, 16 that keeps a
    block at 512 threads or fewer (else at 1,024): the fastest cuts measured
    on the H100 (PERF.md, ``tools/profile_k2.py``). Raises ValueError if the
    field is not a multiple of 64 on each side or no block can hold its
    strip."""
    if h <= 0 or w <= 0 or h % 64 or w % 64:
        raise ValueError(f"integrate: H and W must be multiples of 64, "
                         f"got {h}x{w}")
    p = min(h // 16, MAX_CLUSTER)
    rows = h // p
    smem = 2 * (rows + 2) * (w + 2) * 4
    for limit in (512, MAX_THREADS):
        for m in (4, 8, 16):
            if (smem <= SMEM_BYTES and rows % m == 0
                    and (rows // m) * w <= limit):
                return p, m, (rows // m) * w, smem
    raise ValueError(f"integrate: no cluster of {p} blocks (at most "
                     f"{MAX_CLUSTER}) holds a {h}x{w} field")


def _lib():
    global _bound
    if _bound is None:
        lib = cuda_build.load("integrate")
        lib.pf_integrate.restype = ctypes.c_int
        lib.pf_integrate.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 6 + [ctypes.c_void_p]
        _bound = lib
    return _bound


def _check_inputs(cost, seed_mask, seed_cost):
    if cost.dtype != torch.uint8 or cost.dim() != 3:
        raise ValueError(f"cost must be u8[K, H, W], got "
                         f"{cost.dtype}{list(cost.shape)}")
    if seed_mask.dtype != torch.bool or seed_mask.shape != cost.shape:
        raise ValueError("seed_mask must be bool with cost's shape")
    if seed_cost is not None and (seed_cost.dtype != torch.float32
                                  or seed_cost.shape != cost.shape):
        raise ValueError("seed_cost must be f32 with cost's shape")


def integrate(cost: torch.Tensor, seed_mask: torch.Tensor,
              seed_cost: torch.Tensor | None = None, *,
              max_iters: int | None = None) -> torch.Tensor:
    """cost u8[K, H, W], seed_mask bool[K, H, W], seed_cost optional
    f32[K, H, W] -> f32[K, H, W] integration fields, with H and W
    multiples of 64. The sweep cap defaults to 4*max(H, W) (256 for a
    chunk)."""
    _check_inputs(cost, seed_mask, seed_cost)
    h, w = cost.shape[1], cost.shape[2]
    cut = plan(h, w)
    if max_iters is None:
        max_iters = 4 * max(h, w)
    if cost.device.type == "cpu":
        return integrate_plain(cost, seed_mask, seed_cost, max_iters=max_iters)
    if cost.device.type != "cuda":
        raise RuntimeError(f"integrate: no kernel for device {cost.device}")
    return integrate_cuda(cost, seed_mask, seed_cost, max_iters, cut)


def integrate_cuda(cost: torch.Tensor, seed_mask: torch.Tensor,
                   seed_cost: torch.Tensor | None, max_iters: int,
                   cut: tuple[int, int, int, int]) -> torch.Tensor:
    """Launch K2 on checked inputs with the cut ``plan`` gave; the tensors
    must be contiguous on one CUDA device."""
    global launches_chunk, launches_map
    k, h, w = cost.shape
    p, m = cut[0], cut[1]
    dev = cost.device
    tensors = [cost, seed_mask] + ([] if seed_cost is None else [seed_cost])
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("integrate: inputs must be contiguous on one "
                             "CUDA device")
    out = torch.empty((k, h, w), dtype=torch.float32, device=dev)
    if k == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.pf_integrate(
            cost.data_ptr(), seed_mask.data_ptr(),
            seed_cost.data_ptr() if seed_cost is not None else None,
            out.data_ptr(), k, h, w, p, m, int(max_iters), stream)
    cuda_build.check(lib, code, "integrate kernel")
    if (h, w) == (FIELD_RES, FIELD_RES):
        launches_chunk += 1
    else:
        launches_map += 1
    return out
