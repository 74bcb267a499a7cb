"""Formations: cell layout, terrain/occupancy-aware placement, optimal
assignment, subformations.

Port of ``permafrost_engine_tpu/game/formation.py`` (ref:
src/game/formation.c:354 cell fields, 450-980 placement, 1991-2050
assignment; types in src/game/public/game.h:120-125). The cell layout and
its terrain/occupancy/island checks are host numpy, copied as they are;
the unit->cell assignment is the auction of ``ops/assignment.py`` on the
engine's device, with a greedy fill for any bidder the round cap left
unassigned. Subformations (one block per nav layer and unit type) and the
cell-seeded arrival fields are ``game/engine.Engine.move_in_formation``
and ``nav/service.NavService.install_formation_field``.
"""

from __future__ import annotations

from enum import IntEnum

import numpy as np
import torch

from permafrost_engine_tpu_torch.core.config import COST_IMPASSABLE, NAV_TILE_SIZE
from permafrost_engine_tpu_torch.ops.assignment import auction_assign


class FormationType(IntEnum):
    NONE = 0
    RANK = 1
    COLUMN = 2


def layout_cells(
    n: int,
    goal: np.ndarray,          # (2,) world
    direction: np.ndarray,     # (2,) facing (from units toward goal)
    ftype: FormationType,
    spacing: float,
    cost_layer: np.ndarray,    # u8[H, W] for pathability checks
    max_extra_rows: int = 16,
    occupancy: np.ndarray | None = None,   # i32[H, W] blocker refcounts
    islands: np.ndarray | None = None,     # i32[H, W] island labels
    island: int | None = None,             # required island
) -> np.ndarray:
    """Compute >= n usable cell positions around `goal`, oriented so RANK
    formations face `direction`. A cell is usable when its tile is
    pathable, unoccupied, and on the required island; unusable cells nudge
    laterally up to 2 tiles before being skipped. Returns f32[M, 2], M >= n
    (or all found)."""
    d = direction / max(np.linalg.norm(direction), 1e-6)
    right = np.array([-d[1], d[0]])

    if ftype == FormationType.COLUMN:
        cols = max(1, int(np.ceil(np.sqrt(n / 4))))
    else:  # RANK (and NONE fallback): wide front
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


def block_depth(cells: np.ndarray, direction: np.ndarray) -> float:
    """Extent of a cell block along -direction (for stacking
    subformations behind each other)."""
    if len(cells) == 0:
        return 0.0
    d = direction / max(np.linalg.norm(direction), 1e-6)
    proj = cells @ d
    return float(proj.max() - proj.min())


def assign_cells(units_pos: np.ndarray, cells: np.ndarray, *, device,
                 stats: dict | None = None) -> np.ndarray:
    """Unit->cell mapping by squared distance: the auction on `device`,
    then a greedy fill for stragglers. Returns a writable i32[n] cell index
    per unit. With ``stats``: the auction's ``rounds``, and ``greedy`` (the
    number of units the greedy fill placed)."""
    n, m = len(units_pos), len(cells)
    diff = units_pos[:, None, :] - cells[None, :, :]
    cost = (diff ** 2).sum(-1).astype(np.float32)
    dev = torch.device(device)
    assign = auction_assign(
        torch.from_numpy(cost).to(dev),
        torch.ones(n, dtype=torch.bool, device=dev),
        torch.ones(m, dtype=torch.bool, device=dev),
        stats=stats).cpu().numpy().copy()
    # fallback for any unassigned stragglers (auction round cap): greedy
    unfilled = np.nonzero(assign < 0)[0]
    if stats is not None:
        stats["greedy"] = int(unfilled.size)
    if unfilled.size:
        taken = set(int(a) for a in assign if a >= 0)
        for i in unfilled:
            order = np.argsort(cost[i])
            for j in order:
                if int(j) not in taken:
                    assign[i] = j
                    taken.add(int(j))
                    break
    return assign
