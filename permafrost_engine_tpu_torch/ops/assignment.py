"""Optimal entity->formation-cell assignment via the auction algorithm.

Port of ``permafrost_engine_tpu/ops/assignment.py`` (ref:
src/game/formation.c:1617-2050 solves it with the serial Hungarian
algorithm). The Jacobi auction (Bertsekas) reaches an assignment within
n*eps of optimal through rounds of parallel bidding: every unassigned bidder
takes its best and second-best net value over all objects at once, one
[N, M] tensor pass per round. It is not a Pallas kernel in the JAX package
(a ``lax.while_loop`` of ``jnp`` ops), so it is plain PyTorch here, on the
cost matrix's device.

The JAX loop tests convergence every round; here rounds run in blocks of
``ROUNDS_PER_SYNC`` with one test (one host sync) per block. A round after
convergence changes nothing (no bidder is unassigned, so no object gets a
bid), and the last block is cut so that no more than ``max_rounds`` rounds
run: the result is the JAX one, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e18
ROUNDS_PER_SYNC = 16


def auction_assign(cost: torch.Tensor, bidder_mask: torch.Tensor,
                   object_mask: torch.Tensor, *, eps: float | None = None,
                   max_rounds: int = 10000, stats: dict | None = None) -> torch.Tensor:
    """Jacobi parallel auction over cost f32[N, M] (bidder i taking object
    j), bool[N] real bidders and bool[M] real objects (M must hold every
    real bidder). Returns i32[N]: the object of each bidder, -1 for masked
    bidders and for bidders still unassigned after ``max_rounds``. Total
    cost is within (bidders * eps) of optimal. With ``stats`` the rounds
    that found a bidder unassigned are counted under ``"rounds"``."""
    n, m = cost.shape
    dev = cost.device
    idx_n = torch.arange(n, dtype=torch.int32, device=dev)
    valid = bidder_mask[:, None] & object_mask[None, :]
    value = torch.where(valid, -cost.to(torch.float32), -BIG)
    if eps is None:
        fin = torch.where(valid, cost, 0.0)
        spread = fin.max() - fin.min()
        # XLA compiles the division by the constant 2 n^2 as a multiply by
        # its f32 reciprocal; so does this
        recip = float(np.float32(1.0) / np.float32(2.0 * max(n, 1) * max(n, 1)))
        eps_v = torch.clamp(spread, min=1e-3) * recip
    else:
        eps_v = torch.tensor(eps, dtype=torch.float32, device=dev)

    price = torch.zeros(m, dtype=torch.float32, device=dev)
    owner = torch.full((m,), -1, dtype=torch.int32, device=dev)
    assign = torch.full((n,), -1, dtype=torch.int32, device=dev)
    closed = ~object_mask[None, :]
    net = torch.empty((n, m), dtype=torch.float32, device=dev)
    bid_obj = torch.empty(m + 1, dtype=torch.float32, device=dev)
    winner_obj = torch.empty(m + 1, dtype=torch.int32, device=dev)
    evicted = torch.empty(n + 1, dtype=torch.bool, device=dev)
    rounds = torch.zeros((), dtype=torch.int64, device=dev)

    def one_round():
        nonlocal price, owner, assign
        unassigned = bidder_mask & (assign < 0)
        if stats is not None:
            rounds.add_(unassigned.any())
        # ---- bid phase: best and second-best net value per bidder ----------
        torch.sub(value, price[None, :], out=net)
        net.masked_fill_(closed, -BIG)
        best_j = torch.argmax(net, dim=1)           # the first maximum
        best_v = net.gather(1, best_j[:, None])[:, 0]
        net.scatter_(1, best_j[:, None], -BIG)      # in place of JAX's copy
        second_v = net.max(dim=1).values
        bid = price[best_j] + (best_v - second_v) + eps_v
        tgt = torch.where(unassigned, best_j, m)   # m: the dropped row

        # ---- resolve phase: per object, max bid then min bidder index -------
        bid_obj.fill_(-BIG)
        bid_obj.scatter_reduce_(0, tgt, bid, "amax")
        is_max = unassigned & (bid >= bid_obj[best_j])
        tgt_max = torch.where(is_max, best_j, m)
        winner_obj.fill_(n)
        winner_obj.scatter_reduce_(0, tgt_max, idx_n, "amin")
        win = winner_obj[:m]
        has_bid = win < n

        # ---- update: evict old owners, install winners, raise prices --------
        evicted.zero_()
        evicted[torch.where(has_bid & (owner >= 0), owner, n).long()] = True
        assign = torch.where(evicted[:n], -1, assign)
        won = is_max & (winner_obj[best_j] == idx_n)
        assign = torch.where(won, best_j.to(torch.int32), assign)
        owner = torch.where(has_bid, win, owner)
        price = torch.where(has_bid, bid_obj[:m], price)

    done = 0
    while done < max_rounds:
        if not bool((bidder_mask & (assign < 0)).any()):
            break
        block = min(ROUNDS_PER_SYNC, max_rounds - done)
        for _ in range(block):
            one_round()
        done += block
    if stats is not None:
        stats["rounds"] = int(rounds)
    return torch.where(bidder_mask, assign, -1)
