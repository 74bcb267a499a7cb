"""The yardstick for the kernels' roofline shares: the card's peak rates,
the least time of a piece of work, and the work of kernels K1 and K2
counted from their inputs.

A frozen copy of ``chip_smoke.py``'s arithmetic (``HBM_BYTES_S``,
``F32_OPS_S``, ``bound``, ``K2_OPS_PER_TILE_SWEEP``,
``K1_OPS_PER_CONE_TEST`` and phase 2's and 3's counts). The counts are
functions of a launch's inputs alone: the operations these inputs need,
counted by the benchmark's own plain versions (``benchmark/reference``),
so the roofline reads the same work whatever implements the kernel.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: device memory bytes/s, and f32 operations/s
# outside the tensor cores for operations that are not FMAs (half the
# sheet's 67e12 flop/s, which counts an FMA as two; the kernels are built
# with -fmad=false)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 33.5e12
# K2: per tile per sweep, 8 candidate adds and 8 mins
K2_OPS_PER_TILE_SWEEP = 16
# K1: per (candidate, valid cone) pair, the operations every pair needs,
# more where the sign test lets it be inside, more where it is inside
K1_OPS_PER_CONE_TEST = {"exact": (10, 16, 3), "fan": (5, 11, 2)}


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The card's least time for the work (ms) and what sets it: each
    input read once and each output written once at the memory rate, or
    the operations at the f32 rate, whichever is longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / F32_OPS_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def k1_work(args, exact: bool) -> tuple[float, float]:
    """(operations, bytes) of one K1 launch on `args` (its ten positional
    inputs): every row's distances and 32 arg-min rounds over the window,
    then each candidate against each valid cone at the shares of pairs
    these inputs take past the sign test and inside."""
    from benchmark.reference.crowd import hrvo_select_plain

    stats: dict = {}
    hrvo_select_plain(*args, exact=exact, stats=stats)
    n, c2 = args[5].shape[0], args[5].shape[1]
    every, passed, inside = K1_OPS_PER_CONE_TEST["exact" if exact else "fan"]
    ops = (n * (5 * c2 + 32 * c2) + stats["pairs"] * every
           + stats["passed"] * passed + stats["inside"] * inside)
    nbytes = sum(a.numel() * a.element_size() for a in args) + n * 2 * 4
    return float(ops), float(nbytes)


def k2_work(cost: torch.Tensor, seed_mask: torch.Tensor,
            seed_cost: torch.Tensor | None, max_iters: int
            ) -> tuple[float, float]:
    """(operations, bytes) of one K2 launch: the sweeps these inputs need
    (the plain integrator's count) over every tile of the batch, and the
    cost, seeds, optional seed values and the f32 output once each."""
    from benchmark.reference.flowfield import integrate_plain

    stats: dict = {}
    integrate_plain(cost, seed_mask, seed_cost, max_iters=max_iters,
                    stats=stats)
    k, h, w = cost.shape
    nbytes = k * h * w * (1 + 1 + 4 + (0 if seed_cost is None else 4))
    return float(stats["sweeps"] * k * h * w * K2_OPS_PER_TILE_SWEEP), \
        float(nbytes)
