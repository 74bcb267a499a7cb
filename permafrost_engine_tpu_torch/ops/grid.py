"""Spatial indexing: cell binning into fixed-capacity buckets.

Port of ``permafrost_engine_tpu/ops/grid.py`` (ref:
src/lib/public/bitmap_grid.h:36-120): a dense rebuild every movement tick —
one stable sort by a composite cell key, within-cell ranks from
``searchsorted``, and scatters into ``[cells, cap]`` buckets. The stable
sort and the ranks fix which entities overflow a full bucket, and the
buckets match the JAX version's exactly. Window queries gather the 3x3
neighbourhood's bucket rows per query.

``nearest_match`` is combat's exact nearest-target query. ``build_grid``
(one grid, slot order within a cell), ``central_block_cols`` and
``knn_query`` (the K nearest indexed entities of a window) are the JAX
module's public helpers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from permafrost_engine_tpu_torch.core.config import SPATIAL_CELL_SIZE
from permafrost_engine_tpu_torch.ops.rounding import fma, sqrt


@dataclasses.dataclass(eq=False)
class SpatialGrid:
    """Cell buckets of entity slots; -1 marks empty entries."""

    buckets: torch.Tensor          # i32[cells, cap] entity slots or -1
    bucket_xy: torch.Tensor        # f32[cells, cap, 2] positions (1e30 empty)
    cell_of: torch.Tensor          # i32[N] flat cell per entity (dead: cells)
    bucket_payload: torch.Tensor | None   # f32[cells, cap, P]
    cells_r: int
    cells_c: int
    cell_size: float = SPATIAL_CELL_SIZE


@dataclasses.dataclass(eq=False)
class ContactGrid:
    """Fine contact grid packed as f32[cells, cap, 2+Q+1] with channels
    (x, z, payload..., slot); slot -1 marks empty entries."""

    packed: torch.Tensor
    cell_of: torch.Tensor
    cells_r: int
    cells_c: int
    cell_size: float


def cell_coords(pos: torch.Tensor, cells_r: int, cells_c: int,
                cell_size: float = SPATIAL_CELL_SIZE):
    """Clamped (row, col) cell coordinates (truncation toward zero, as the
    JAX ``astype(int32)``)."""
    c = torch.clamp((pos[..., 0] / cell_size).to(torch.int32), 0, cells_c - 1)
    r = torch.clamp((pos[..., 1] / cell_size).to(torch.int32), 0, cells_r - 1)
    return r, c


def build_grid(pos, alive, *, cells_r: int, cells_c: int, cap: int,
               payload=None, cell_size: float = SPATIAL_CELL_SIZE
               ) -> SpatialGrid:
    """Bin alive entities into fixed-capacity cell buckets, in slot order
    within a cell (one stable sort by cell). Entities past `cap` in a cell
    are dropped from the index (ref: src/game/clearpath.c:390's bounded
    query outputs). `payload` f32[N, P] rides along in ``bucket_payload``
    (None without one)."""
    n = pos.shape[0]
    num_cells = cells_r * cells_c
    r, c = cell_coords(pos, cells_r, cells_c, cell_size)
    cell = torch.where(alive, r * cells_c + c, num_cells)
    sorted_cell, order = torch.sort(cell, stable=True)
    rank = (torch.arange(n, device=pos.device)
            - torch.searchsorted(sorted_cell, sorted_cell))
    valid = (sorted_cell < num_cells) & (rank < cap)
    slot = torch.where(valid, sorted_cell * cap + rank, num_cells * cap)
    total = num_cells * cap
    pay = None
    if payload is not None:
        pay = _scatter(slot, total, payload[order].to(torch.float32), 0.0
                       ).reshape(num_cells, cap, payload.shape[1])
    return SpatialGrid(
        buckets=_scatter(slot, total, order.to(torch.int32), -1
                         ).reshape(num_cells, cap),
        bucket_xy=_scatter(slot, total, pos[order], 1e30
                           ).reshape(num_cells, cap, 2),
        cell_of=cell.to(torch.int32), bucket_payload=pay,
        cells_r=cells_r, cells_c=cells_c, cell_size=cell_size)


def central_block_cols(window: int, sub: int, cap: int) -> np.ndarray:
    """Static column indices selecting the central (sub x sub)-cell blocks
    out of a (window x window) candidate row from ``window_candidates``,
    each block's `cap` columns in order."""
    if sub > window or (window - sub) % 2:
        raise ValueError(f"no central {sub}x{sub} block in a {window}x"
                         f"{window} window")
    off = (window - sub) // 2
    cols = []
    for dr in range(off, off + sub):
        for dc in range(off, off + sub):
            b = dr * window + dc
            cols.extend(range(b * cap, (b + 1) * cap))
    return np.asarray(cols, np.int32)


def _scatter(slot: torch.Tensor, total: int, val: torch.Tensor, fill):
    """out[slot] = val with slot == total dropped (JAX mode="drop");
    valid slots are unique."""
    out = torch.full((total + 1,) + tuple(val.shape[1:]), fill,
                     dtype=val.dtype, device=val.device)
    out[slot.long()] = val
    return out[:total]


def build_grid_pair(pos, alive, *, cells_r, cells_c, cap, payload, fine_r,
                    fine_c, fine_cap, fine_payload,
                    cell_size: float = SPATIAL_CELL_SIZE,
                    fine_cell_size: float):
    """The coarse avoidance grid and the fine contact grid from ONE stable
    sort of the composite key ``coarse * sub2 + sub`` (see the JAX
    docstring). Returns (SpatialGrid, ContactGrid)."""
    ratio = int(round(cell_size / fine_cell_size))
    if abs(ratio * fine_cell_size - cell_size) >= 1e-6:
        raise ValueError("fine_cell_size must divide cell_size")
    n = pos.shape[0]
    dev = pos.device
    num_coarse = cells_r * cells_c
    num_fine = fine_r * fine_c
    sub2 = ratio * ratio

    fr, fc = cell_coords(pos, fine_r, fine_c, fine_cell_size)
    cr = torch.clamp(fr // ratio, max=cells_r - 1)
    cc = torch.clamp(fc // ratio, max=cells_c - 1)
    coarse = cr * cells_c + cc
    fine_flat = fr * fine_c + fc
    sub = (fr - cr * ratio) * ratio + (fc - cc * ratio)
    key = torch.where(alive, coarse * sub2 + sub, num_coarse * sub2)

    skey, order = torch.sort(key, stable=True)
    spos = pos[order]
    sorder = order.to(torch.int32)
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    rank_f = ar - torch.searchsorted(skey, skey)
    scoarse = skey // sub2
    rank_c = ar - torch.searchsorted(scoarse, scoarse)

    valid_c = (scoarse < num_coarse) & (rank_c < cap)
    slot_c = torch.where(valid_c, scoarse * cap + rank_c, num_coarse * cap)
    sfine = fine_flat[order]
    valid_f = (skey < num_coarse * sub2) & (rank_f < fine_cap)
    slot_f = torch.where(valid_f, sfine * fine_cap + rank_f,
                         num_fine * fine_cap)

    cg = SpatialGrid(
        buckets=_scatter(slot_c, num_coarse * cap, sorder, -1
                         ).reshape(num_coarse, cap),
        bucket_xy=_scatter(slot_c, num_coarse * cap, spos, 1e30
                           ).reshape(num_coarse, cap, 2),
        cell_of=torch.where(alive, coarse, num_coarse).to(torch.int32),
        bucket_payload=_scatter(slot_c, num_coarse * cap,
                                payload[order].to(torch.float32), 0.0
                                ).reshape(num_coarse, cap, payload.shape[1]),
        cells_r=cells_r, cells_c=cells_c, cell_size=cell_size)
    q = fine_payload.shape[1]
    pvals = torch.cat([spos, fine_payload[order].to(torch.float32),
                       sorder.to(torch.float32)[:, None]], dim=1)
    fill_row = torch.cat([torch.full((2,), 1e30, device=dev),
                          torch.zeros(q, device=dev),
                          torch.full((1,), -1.0, device=dev)])
    packed = fill_row.repeat(num_fine * fine_cap + 1, 1)
    packed[slot_f.long()] = pvals
    fg = ContactGrid(
        packed=packed[:-1].reshape(num_fine, fine_cap, 2 + q + 1),
        cell_of=torch.where(alive, fine_flat, num_fine).to(torch.int32),
        cells_r=fine_r, cells_c=fine_c, cell_size=fine_cell_size)
    return cg, fg


def _window_rows(table: torch.Tensor, qr, qc, cells_r, cells_c, window,
                 fill):
    """[Q, W2*cap, ...]: the bucket rows of the (window x window) cells
    around each query cell, row-major over (dr, dc), `fill` outside."""
    half = window // 2
    rows = []
    for dr in range(window):
        for dc in range(window):
            rr, cc = qr + dr - half, qc + dc - half
            inb = (rr >= 0) & (rr < cells_r) & (cc >= 0) & (cc < cells_c)
            row = table[torch.where(inb, rr * cells_c + cc, 0).long()]
            shape = (-1,) + (1,) * (row.dim() - 1)
            rows.append(torch.where(inb.reshape(shape), row, fill))
    return torch.cat(rows, dim=1)


def window_candidates(grid: SpatialGrid, query_pos, query_slot, *,
                      window: int = 5):
    """All bucket candidates in a (window x window)-cell neighbourhood of
    each query point: (cand i32[Q, W2*cap], cpos f32[Q, W2*cap, 2],
    cpay f32[Q, W2*cap, P] or None without a payload, valid
    bool[Q, W2*cap]); `valid` excludes empty entries and the queryer
    itself."""
    cr, cc = grid.cells_r, grid.cells_c
    qr, qc = cell_coords(query_pos, cr, cc, grid.cell_size)
    cand = _window_rows(grid.buckets, qr, qc, cr, cc, window, -1)
    cpos = _window_rows(grid.bucket_xy, qr, qc, cr, cc, window, 1e30)
    cpay = None
    if grid.bucket_payload is not None:
        cpay = _window_rows(grid.bucket_payload, qr, qc, cr, cc, window, 0.0)
    valid = (cand >= 0) & (cand != query_slot[:, None])
    return cand, cpos, cpay, valid


def knn_query(grid: SpatialGrid, pos, query_pos, query_slot, *, k: int,
              window: int = 5):
    """The K nearest indexed entities around each query point, over the
    (window x window)-cell candidates of ``window_candidates``; `pos` is
    the f32[N, 2] the grid indexes (unused, as in JAX), `query_slot` i32[Q]
    each queryer's slot (excluded) or -1 for a point query.

    Returns (idx i32[Q, k] or -1, dist f32[Q, k], valid bool[Q, k],
    neigh_pos f32[Q, k, 2]) sorted by distance. JAX takes
    ``approx_max_k(-d2)``, which off the TPU is an exact top-k that breaks
    ties toward the lower candidate column; a stable ascending sort of
    `d2` gives the same order, invalid columns (d2 = inf) included, so all
    four outputs equal JAX's. In an invalid slot `neigh_pos` is whatever
    the window holds at that column. The squared distance is
    ``fma(dz, dz, dx * dx)``, the contraction XLA makes on the CPU, and its
    root is correctly rounded (``ops/rounding.py``)."""
    cand, cpos, _, cvalid = window_candidates(grid, query_pos, query_slot,
                                              window=window)
    dx = cpos[..., 0] - query_pos[:, None, 0]
    dz = cpos[..., 1] - query_pos[:, None, 1]
    d2 = torch.where(cvalid, fma(dz, dz, dx * dx), float("inf"))
    d2, top = torch.sort(d2, dim=1, stable=True)
    d2, top = d2[:, :k], top[:, :k]
    valid = torch.isfinite(d2)
    idx = torch.where(valid, torch.gather(cand, 1, top), -1)
    neigh_pos = torch.gather(cpos, 1, top[..., None].expand(-1, -1, 2))
    return idx, sqrt(d2), valid, neigh_pos


def contact_candidates(grid: ContactGrid, query_pos, query_slot):
    """All entries of the 3x3 fine cells around each query point:
    (cand, cpos, cpay, valid) as ``window_candidates``; out-of-map cells
    are invalid."""
    cr, cc = grid.cells_r, grid.cells_c
    qr, qc = cell_coords(query_pos, cr, cc, grid.cell_size)
    cap = grid.packed.shape[1]
    rows, inbs = [], []
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            rr, ccol = qr + dr, qc + dc
            inb = (rr >= 0) & (rr < cr) & (ccol >= 0) & (ccol < cc)
            rows.append(grid.packed[torch.where(inb, rr * cc + ccol, 0).long()])
            inbs.append(inb[:, None].expand(-1, cap))
    pk = torch.cat(rows, dim=1)
    inb = torch.cat(inbs, dim=1)
    cand = pk[..., -1].to(torch.int32)
    valid = inb & (cand >= 0) & (cand != query_slot[:, None])
    return cand, pk[..., 0:2], pk[..., 2:-1], valid


def nearest_match(query_pos, query_mask, target_pos, target_mask, pair_ok, *,
                  block: int = 1024):
    """Exact nearest target per queryer under a pair predicate, by brute
    force over blocks of targets (peak memory [Q, block]); ref: combat.c
    target acquisition. Port of JAX ``grid.nearest_match``.

    ``pair_ok = (q_code i32[Q], ok_matrix bool[C, C], t_code i32[N])``. The
    JAX code packs rows of the matrix into u32 bit masks to avoid a TPU
    gather and tests ``ok_matrix[t_code, q_code]`` (its docstring names the
    transpose; every caller passes the symmetric diplomacy table); here the
    same entry is a plain ``[C, C]`` table lookup. Each block keeps its first
    minimum and a later block must be strictly nearer, so the result is the
    global first-index argmin whatever ``block`` is. The squared distance
    is ``fma(dz, dz, dx * dx)``, the contraction XLA makes on the CPU,
    and its root is correctly rounded (``ops/rounding.py``).

    Returns (idx i32[Q] nearest valid target or -1, dist f32[Q], inf where
    there is none)."""
    q_code, ok_matrix, t_code = pair_ok
    c = ok_matrix.shape[0]
    dev = query_pos.device
    q, n = query_pos.shape[0], target_pos.shape[0]
    qc = torch.clamp(q_code, 0, c - 1).long()
    tc = torch.clamp(t_code, 0, c - 1).long()
    qx, qz = query_pos[:, 0:1], query_pos[:, 1:2]
    best_d2 = torch.full((q,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((q,), -1, dtype=torch.int64, device=dev)
    for s in range(0, n, block):
        bpos = target_pos[s:s + block]
        dx = qx - bpos[None, :, 0]
        dz = qz - bpos[None, :, 1]
        ok = target_mask[None, s:s + block] & ok_matrix[tc[None, s:s + block],
                                                        qc[:, None]]
        d2 = torch.where(ok, fma(dz, dz, dx * dx), float("inf"))
        bi = torch.argmin(d2, dim=1)
        bd2 = torch.gather(d2, 1, bi[:, None])[:, 0]
        better = bd2 < best_d2
        best_d2 = torch.where(better, bd2, best_d2)
        best_i = torch.where(better, bi + s, best_i)
    found = torch.isfinite(best_d2)
    idx = torch.where(query_mask & found, best_i, -1).to(torch.int32)
    return idx, sqrt(best_d2)
