"""Row-banded whole-map flow-field integration with a one-row halo exchange.

Counterpart of ``permafrost_engine_tpu/parallel/fields.py``. Per-chunk
fields are independent integrations, but whole-map fields (enemy-seek and
surround over [H, W]) grow with the map. Here the map's rows are cut into
one band per rank: each rank relaxes its [H/R, W] band with the port's own
min-plus sweep (``ops/flowfield._relax_once``), padded before every sweep
with its neighbours' boundary rows (``Mesh.halo_exchange``; at the map
edges ``INF_COST`` for the integral and ``False`` for passable). Every
``check_every`` sweeps an all-reduce MIN of "this band did not change"
lets every rank leave the loop on the same sweep. The bands are gathered
at the end, since the caller's ``flow_dirs`` reads the whole grid.

Each sweep of a band equals that band of a whole-map sweep, so with the
default ``check_every=8`` the schedule and the result are those of
``ops/flowfield.integrate_plain``, bit for bit. As in JAX this is not a
Pallas kernel but array code, so it stays plain PyTorch.
"""

from __future__ import annotations

import time

import torch

from permafrost_engine_tpu_torch.core.config import COST_IMPASSABLE, INF_COST
from permafrost_engine_tpu_torch.ops.flowfield import (
    SQRT2,
    _neighbour_allowed_masks,
    _relax_once,
)

AXIS = "rows"


def make_sharded_integrate(mesh, h: int, w: int, *,
                           max_iters: int | None = None,
                           check_every: int = 8, axis: str = AXIS):
    """Build ``integrate(cost u8[H, W], seeds bool[H, W]) -> f32[H, W]``
    over the rank bands of `mesh` (a ``parallel.mesh.Mesh``); every rank
    calls it with the same whole inputs and gets the whole field. `axis`
    is JAX's name of the mesh axis the rows are cut over (the engine's mesh
    calls it "ents"); a rank mesh has one axis, so nothing reads it. The
    function's ``stats`` dict counts its calls, their sweeps and host
    milliseconds."""
    n = mesh.world
    if h % n:
        raise ValueError(f"rows {h} must divide over {n} ranks")
    max_iters = max_iters or 4 * max(h, w)
    lo, hi = mesh.rows(h)
    dev = mesh.device
    inf_row = torch.full((1, w), INF_COST, dtype=torch.float32, device=dev)
    off_row = torch.zeros((1, w), dtype=torch.uint8, device=dev)
    stats = {"calls": 0, "sweeps": 0, "ms": 0.0}

    def with_halo(x: torch.Tensor, fill: torch.Tensor) -> torch.Tensor:
        """The band padded with the neighbours' boundary rows (`fill`
        beyond the map)."""
        above, below = mesh.halo_exchange(x[:1].contiguous(),
                                          x[-1:].contiguous())
        return torch.cat([fill if above is None else above, x,
                          fill if below is None else below])

    def integrate(cost: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
        t0 = time.perf_counter()
        cost, seeds = cost[lo:hi].to(dev), seeds[lo:hi].to(dev)
        passable = cost != COST_IMPASSABLE
        step = torch.where(passable, cost.to(torch.float32), INF_COST)
        step = torch.cat([inf_row, step, inf_row])
        step_diag = step * torch.tensor(SQRT2, dtype=torch.float32, device=dev)
        seeded = seeds & passable
        integ = torch.where(seeded, 0.0, INF_COST)
        # static, so exchanged once (as bytes: gloo has no bool messages)
        gp = with_halo(passable.to(torch.uint8), off_row).bool()
        allowed = _neighbour_allowed_masks(gp)
        i = 0
        while i < max_iters:
            new = integ
            for _ in range(check_every):
                new = _relax_once(with_halo(new, inf_row), step, step_diag,
                                  gp, allowed)[1:-1]
            i += check_every
            same = torch.tensor([int(torch.equal(new, integ))],
                                dtype=torch.int32, device=dev)
            integ = new
            if int(mesh.all_reduce(same, "min")[0]):
                break
        integ = torch.where(seeded, 0.0, integ)
        out = mesh.all_gather_rows([integ], 0)[0]
        stats["calls"] += 1
        stats["sweeps"] += i
        stats["ms"] += (time.perf_counter() - t0) * 1e3
        return out

    integrate.stats = stats
    return integrate
