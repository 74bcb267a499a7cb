"""Formations: the cell layout, and the test of a unit->cell assignment.

The layout is the benchmark's frozen copy of
``permafrost_engine_tpu_torch/game/formation.layout_cells`` (host numpy;
ref: src/game/formation.c:450-980), taken when the benchmark was defined.

``swap_gain`` reads how far a unit->cell assignment is from the least
total squared distance (formation.c:1991-2050 solves it exactly with the
Hungarian algorithm; an auction reaches it to within n*eps): how much
two units would gain by trading cells, or one by moving to a free cell,
in units of an auction's 2 eps, eps = (largest - least cost) / (2 n^2)
(Bertsekas: each unit's cell within eps of its best at the prices).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.config import COST_IMPASSABLE, NAV_TILE_SIZE

COLUMN = 2   # FormationType.COLUMN; RANK (1) and NONE (0) lay a wide front


def layout_cells(n: int, goal: np.ndarray, direction: np.ndarray, ftype: int,
                 spacing: float, cost_layer: np.ndarray,
                 max_extra_rows: int = 16, occupancy: np.ndarray | None = None,
                 islands: np.ndarray | None = None,
                 island: int | None = None) -> np.ndarray:
    """>= n usable cell positions around `goal` (f32[M, 2]), oriented so
    RANK formations face `direction`. A cell is usable when its tile is
    pathable, unoccupied and on the required island; unusable cells nudge
    laterally up to 2 tiles before being skipped."""
    d = direction / max(np.linalg.norm(direction), 1e-6)
    right = np.array([-d[1], d[0]])

    if ftype == COLUMN:
        cols = max(1, int(np.ceil(np.sqrt(n / 4))))
    else:
        cols = max(1, int(np.ceil(np.sqrt(n * 4))))

    h, w = cost_layer.shape

    def usable(p: np.ndarray) -> bool:
        r_t = int(p[1] // NAV_TILE_SIZE)
        c_t = int(p[0] // NAV_TILE_SIZE)
        if not (0 <= r_t < h and 0 <= c_t < w):
            return False
        if cost_layer[r_t, c_t] == COST_IMPASSABLE:
            return False
        if occupancy is not None and occupancy[r_t, c_t] > 0:
            return False
        if islands is not None and island is not None \
                and islands[r_t, c_t] != island:
            return False
        return True

    cells = []
    row = 0
    while len(cells) < n and row < (n // cols + 1) + max_extra_rows:
        for col in range(cols):
            off_r = (col - (cols - 1) / 2.0) * spacing
            off_d = -row * spacing
            base = goal + right * off_r + d * off_d
            for nudge in (0.0, NAV_TILE_SIZE, -NAV_TILE_SIZE,
                          2 * NAV_TILE_SIZE, -2 * NAV_TILE_SIZE):
                p = base + right * nudge
                if usable(p):
                    cells.append(p)
                    break
        row += 1
    return np.asarray(cells, np.float32).reshape(-1, 2)


def sq_dist(units_pos: np.ndarray, cells: np.ndarray, device) -> torch.Tensor:
    """f64[n, m] squared distances from each unit to each cell."""
    u = torch.as_tensor(units_pos, dtype=torch.float64, device=device)
    c = torch.as_tensor(cells, dtype=torch.float64, device=device)
    return ((u[:, None, :] - c[None, :, :]) ** 2).sum(-1)


def swap_gain(cost: torch.Tensor, assign: np.ndarray) -> float:
    """The most that one trade of cells between two units, or one unit's
    move to a free cell, would lower the total of `cost` (f64[n, m]) under
    `assign` (a cell index per unit), in units of 2 eps (see the module
    docstring): at most 0 for an optimal assignment, at most 1 for an
    auction's. Infinite where a unit has no cell or two share one."""
    n, m = cost.shape
    a = torch.as_tensor(np.asarray(assign, np.int64), device=cost.device)
    if n == 0:
        return 0.0
    if bool(((a < 0) | (a >= m)).any()) or len(torch.unique(a)) != n:
        return float("inf")
    own = cost[torch.arange(n, device=cost.device), a]
    best = -float("inf")
    for lo in range(0, n, 1024):
        hi = min(lo + 1024, n)
        # gain[i, j] = c(i, a_i) + c(j, a_j) - c(i, a_j) - c(j, a_i)
        g = (own[lo:hi, None] + own[None, :] - cost[lo:hi][:, a]
             - cost[:, a[lo:hi]].T)
        best = max(best, float(g.max()))
    free = torch.ones(m, dtype=torch.bool, device=cost.device)
    free[a] = False
    if bool(free.any()):
        best = max(best, float((own - cost[:, free].min(1).values).max()))
    eps = max(float(cost.max() - cost.min()), 1e-3) / (2.0 * n * n)
    return best / (2.0 * eps)
