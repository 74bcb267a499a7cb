"""Connected-component island labeling over nav grids.

Port of ``permafrost_engine_tpu/ops/islands.py`` (ref: n_visit_island,
src/navigation/nav.c:856): iterative min-label propagation over the
8-neighbour stencil without corner cutting, batched over leading dims.
Every tile ends with the smallest linear id of its component, the same ids
the JAX version gives.

``label_islands_host`` gives the same ids from a host array in one pass
(``scipy.ndimage.label``), for the nav service, whose costs and readers
both live on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from permafrost_engine_tpu_torch.core.config import COST_IMPASSABLE
from permafrost_engine_tpu_torch.ops.flowfield import shift2d

_OFFS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def label_islands(cost: torch.Tensor, *, max_iters: int = 4096) -> torch.Tensor:
    """Island ids per tile: i32[..., H, W]; -1 on impassable tiles."""
    passable = cost != COST_IMPASSABLE
    h, w = cost.shape[-2], cost.shape[-1]
    big = h * w
    ids = torch.arange(h * w, dtype=torch.int32, device=cost.device
                       ).reshape(h, w)
    lab = torch.where(passable, ids, big)
    ortho = {(dr, dc): shift2d(passable, dr, dc, False)
             for dr, dc in ((-1, 0), (1, 0), (0, -1), (0, 1))}
    diag_ok = {(dr, dc): ortho[(dr, 0)] & ortho[(0, dc)]
               for dr, dc in _OFFS if dr and dc}

    def sweep(x):
        best = x
        for dr, dc in _OFFS:
            cand = shift2d(x, dr, dc, big)
            if dr and dc:
                cand = torch.where(diag_ok[(dr, dc)], cand, big)
            best = torch.minimum(best, cand)
        return torch.where(passable, best, big)

    i = 0
    while i < max_iters:
        new = lab
        for _ in range(16):
            new = sweep(new)
        i += 16
        done = torch.equal(new, lab)
        lab = new
        if done:
            break
    return torch.where(passable, lab, -1)


def label_islands_host(cost: np.ndarray) -> np.ndarray:
    """Island ids per tile on the host: i32[..., H, W]; -1 on impassable
    tiles; the ids ``label_islands`` gives, batched over leading dims.

    Corner cutting is forbidden (a diagonal step needs both orthogonal
    tiles passable), so two tiles that touch only at a corner connect
    through a passable orthogonal tile or not at all: the islands are
    exactly the 4-connected components. Each is labelled by
    ``scipy.ndimage.label`` and given its smallest linear id, which is the
    first index of its label in raster order."""
    from scipy import ndimage

    cost = np.asarray(cost)
    h, w = cost.shape[-2], cost.shape[-1]
    passable = (cost != COST_IMPASSABLE).reshape(-1, h, w)
    out = np.empty(passable.shape, np.int32)
    for i, p in enumerate(passable):
        lab, n = ndimage.label(p)
        present, first = np.unique(lab, return_index=True)
        ids = np.empty(n + 1, np.int32)
        ids[present] = first
        ids[0] = -1
        out[i] = ids[lab]
    return out.reshape(cost.shape)


def label_local_islands(cost: torch.Tensor, blockers: torch.Tensor) -> torch.Tensor:
    """Per-chunk local island labels with live blockers stamped impassable:
    i32[K, F, F], -1 on blocked tiles (ref: nav_data.h:142-158)."""
    eff = torch.where(blockers > 0, COST_IMPASSABLE, cost.to(torch.int32)
                      ).to(torch.uint8)
    return label_islands(eff, max_iters=512)
