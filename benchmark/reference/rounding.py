"""f32 arithmetic rounded as the JAX reference rounds it on the CPU.

The benchmark's frozen copy of
``permafrost_engine_tpu_torch/ops/rounding.py``, taken when the benchmark
was defined and kept as it was: part of the plain reference that
``benchmark/check.py`` holds the program against. It imports nothing of the
program and nothing of JAX.

Two differences between XLA on the CPU and plain PyTorch ops flip
near-ties (a target, a hit, a pick) unless matched:

* XLA contracts a multiply feeding an add into one FMA inside a fusion, so
  it rounds ``a * b + c`` once where two PyTorch ops round twice. Where the
  parity tests showed such a flip, the port contracts the same expression
  with ``fma`` and nowhere else.
* PyTorch's vectorized f32 ``sqrt`` on the CPU is not always correctly
  rounded (0.7% of random inputs off by one ulp on AVX-512); XLA's is.
  ``sqrt`` goes through f64, which rounds correctly on every device (f64
  has more than twice f32's precision, so the second rounding is exact).
"""

from __future__ import annotations

import torch


def fma(a, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, like CUDA's ``__fmaf_rn``: the f64
    product of two f32 values is exact, so only the final add rounds (a
    double rounding through f64 is possible in principle and has never been
    observed to matter). Python-number operands must be f32 values."""

    def wide(x):
        return x.double() if isinstance(x, torch.Tensor) else float(x)

    return (wide(a) * wide(b) + wide(c)).to(torch.float32)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root."""
    return torch.sqrt(x.double()).to(torch.float32)
