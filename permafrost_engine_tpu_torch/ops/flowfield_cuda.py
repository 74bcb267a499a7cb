"""Kernel K2: batched per-chunk flow-field integration on the card.

Counterpart of ``permafrost_engine_tpu/ops/flowfield_pallas.py``
(``integrate_pallas``). The kernel is ``csrc/integrate.cu``; its plain
PyTorch version is ``ops/flowfield.integrate_plain``. ``integrate`` is the
port's single per-chunk integration entry (path requests, field installs,
portal-graph builds): CPU tensors take the plain version, CUDA tensors
launch the kernel, and anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from permafrost_engine_tpu.core.config import FIELD_RES
from permafrost_engine_tpu_torch.ops import cuda_build
from permafrost_engine_tpu_torch.ops.flowfield import integrate_plain

# launches of the CUDA kernel (not of the plain version)
launches = 0

_bound = None


def _lib():
    global _bound
    if _bound is None:
        lib = cuda_build.load("integrate")
        lib.pf_integrate.restype = ctypes.c_int
        lib.pf_integrate.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int, ctypes.c_void_p]
        _bound = lib
    return _bound


def integrate(cost: torch.Tensor, seed_mask: torch.Tensor,
              seed_cost: torch.Tensor | None = None) -> torch.Tensor:
    """cost u8[K, 64, 64], seed_mask bool[K, 64, 64], seed_cost optional
    f32[K, 64, 64] -> f32[K, 64, 64] integration fields."""
    if cost.device.type == "cpu":
        return integrate_plain(cost, seed_mask, seed_cost)
    if cost.device.type != "cuda":
        raise RuntimeError(f"integrate: no kernel for device {cost.device}")
    return integrate_cuda(cost, seed_mask, seed_cost)


def integrate_cuda(cost: torch.Tensor, seed_mask: torch.Tensor,
                   seed_cost: torch.Tensor | None = None) -> torch.Tensor:
    """Launch K2 on CUDA tensors (checks device, dtype, shape, layout)."""
    global launches
    k = cost.shape[0]
    shape = (k, FIELD_RES, FIELD_RES)
    dev = cost.device
    if cost.dtype != torch.uint8 or tuple(cost.shape) != shape:
        raise ValueError(f"cost must be u8{list(shape)}, got "
                         f"{cost.dtype}{list(cost.shape)}")
    if seed_mask.dtype != torch.bool or tuple(seed_mask.shape) != shape:
        raise ValueError("seed_mask must be bool with cost's shape")
    tensors = [cost, seed_mask]
    if seed_cost is not None:
        if seed_cost.dtype != torch.float32 or tuple(seed_cost.shape) != shape:
            raise ValueError("seed_cost must be f32 with cost's shape")
        tensors.append(seed_cost)
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("integrate: inputs must be contiguous on one "
                             "CUDA device")
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if k == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.pf_integrate(
            cost.data_ptr(), seed_mask.data_ptr(),
            seed_cost.data_ptr() if seed_cost is not None else None,
            out.data_ptr(), k, stream)
    cuda_build.check(lib, code, "integrate kernel")
    launches += 1
    return out
