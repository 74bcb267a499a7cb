"""Flow-field integration, direction quantization, and LOS fields.

Port of ``permafrost_engine_tpu/ops/flowfield.py`` (ref:
src/navigation/field.c:539-566 Dijkstra, field.c:734-828 directions,
field.c:435-537 LOS). Integration is batched min-plus relaxation over the
8-neighbour octile stencil; ``integrate_plain`` is the plain PyTorch version
of kernel K2 (``ops/flowfield_cuda.py``), and every caller, per chunk or
whole map, goes through ``flowfield_cuda.integrate``, which launches K2 on
CUDA tensors.

All functions are shape-polymorphic over leading batch dims.
"""

from __future__ import annotations

import torch

from permafrost_engine_tpu_torch.core.config import (
    COST_IMPASSABLE,
    FIELD_RES,
    FLOW_DIR_OFFSETS,
    INF_COST,
)

SQRT2 = 1.4142135623730951

# Neighbour offsets in FlowDir order (codes 1..8): NW N NE W E SW S SE
_OFFSETS = FLOW_DIR_OFFSETS[1:]


def shift2d(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """Value of the neighbour at (r+dr, c+dc) for every tile; `fill` where
    that neighbour lies outside. Any static offset with |dr| <= H,
    |dc| <= W; leading batch dims pass through."""
    h, w = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    r0, r1 = max(0, -dr), h - max(0, dr)
    c0, c1 = max(0, -dc), w - max(0, dc)
    if r1 > r0 and c1 > c0:
        out[..., r0:r1, c0:c1] = x[..., r0 + dr:r1 + dr, c0 + dc:c1 + dc]
    return out


def _neighbour_allowed_masks(passable: torch.Tensor) -> list:
    """Per-offset masks: can a step arrive from the neighbour at that
    offset? Diagonal moves need both orthogonal tiles passable (no corner
    cutting, ref: N_GridNeighbours nav.c:4881); None = always allowed."""
    masks = []
    for dr, dc in _OFFSETS:
        if dr != 0 and dc != 0:
            masks.append(shift2d(passable, dr, 0, False)
                         & shift2d(passable, 0, dc, False))
        else:
            masks.append(None)
    return masks


def _relax_once(integ, step, step_diag, passable, allowed):
    """One Jacobi min-plus sweep. The diagonal step cost is rounded to f32
    before the add (``step * f32(sqrt 2)``, then ``+``): the same two
    roundings as the JAX code and K2."""
    best = integ
    for (dr, dc), mask in zip(_OFFSETS, allowed):
        nb = shift2d(integ, dr, dc, INF_COST)
        if mask is None:
            cand = nb + step
        else:
            cand = torch.where(mask, nb + step_diag, INF_COST)
        best = torch.minimum(best, cand)
    return torch.where(passable, best, INF_COST)


def integrate_plain(cost: torch.Tensor, seed_mask: torch.Tensor,
                    seed_cost: torch.Tensor | None = None, *,
                    max_iters: int = 4 * FIELD_RES,
                    stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch integration (the version K2 is held against).

    cost u8[..., H, W] (COST_IMPASSABLE blocks), seed_mask bool[..., H, W],
    seed_cost optional f32[..., H, W] initial seed values. Sweeps run in
    bundles of 8 until a bundle changes nothing or `max_iters` sweeps ran —
    the JAX Pallas kernel's schedule (``flowfield_pallas._integrate_kernel``);
    since further sweeps leave a fixed point unchanged, the result also
    equals the XLA version's 16-sweep bundles. Returns f32[..., H, W],
    INF_COST where unreachable or blocked; a `stats` dict gets the number
    of sweeps run under "sweeps"."""
    passable = cost != COST_IMPASSABLE
    step = torch.where(passable, cost.to(torch.float32), INF_COST)
    step_diag = step * torch.tensor(SQRT2, dtype=torch.float32,
                                    device=cost.device)
    sc = (torch.zeros((), dtype=torch.float32, device=cost.device)
          if seed_cost is None else seed_cost.to(torch.float32))
    seeded = seed_mask & passable
    integ = torch.where(seeded, sc, INF_COST)
    allowed = _neighbour_allowed_masks(passable)
    i = 0
    while i < max_iters:
        new = integ
        for _ in range(8):
            new = _relax_once(new, step, step_diag, passable, allowed)
        i += 8
        done = torch.equal(new, integ)
        integ = new
        if done:
            break
    if stats is not None:
        stats["sweeps"] = i
    return torch.where(seeded, sc, integ)


def flow_dirs(integ: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """Quantize downhill directions (ref: field.c:734-828): each tile points
    at its lowest-integration allowed neighbour, with a 1e-3 penalty that
    breaks ties toward orthogonal steps. Returns u8[..., H, W] FlowDir."""
    passable = cost != COST_IMPASSABLE
    masks = _neighbour_allowed_masks(passable)
    neigh = []
    for (dr, dc), m in zip(_OFFSETS, masks):
        v = shift2d(integ, dr, dc, INF_COST)
        neigh.append(v if m is None else torch.where(m, v, INF_COST))
    neigh = torch.stack(neigh, dim=-1)
    penalty = torch.tensor([1e-3 if (dr and dc) else 0.0 for dr, dc in _OFFSETS],
                           dtype=torch.float32, device=integ.device)
    best_idx = torch.argmin(neigh + penalty, dim=-1)    # first minimum
    best_val = neigh.min(dim=-1).values
    have_dir = (passable & (best_val < INF_COST) & (integ > 0.0)
                & (integ < INF_COST))
    return torch.where(have_dir, best_idx + 1, 0).to(torch.uint8)


def los_field(passable: torch.Tensor, goal_r, goal_c) -> torch.Tensor:
    """Line-of-sight field from a goal tile, in closed form (ref:
    field.c:435-537; JAX ``flowfield.los_field``): los(t) is the AND of
    ok(u) along the octile sign-step path t -> goal, evaluated as 1-D
    prefix-ANDs on the goal row/column, sheared into crossing-point planes
    by log-doubling shifts, and four per-quadrant diagonal suffix-ANDs.
    `goal_r`/`goal_c` are scalars or match the leading batch dims.
    Returns u8[..., H, W], 1 where visible."""
    h, w = passable.shape[-2], passable.shape[-1]
    dev = passable.device
    p = passable.bool()
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    gr = torch.as_tensor(goal_r, dtype=torch.int32, device=dev)[..., None, None]
    gc = torch.as_tensor(goal_c, dtype=torch.int32, device=dev)[..., None, None]
    dr = gr - rows
    dc = gc - cols
    sr, sc = torch.sign(dr), torch.sign(dc)
    adr, adc = dr.abs(), dc.abs()
    nbits = max(h - 1, w - 1).bit_length()
    batch = p.shape[:-2]

    grow = torch.clamp(gr, 0, h - 1).expand(*batch, 1, w).long()
    prow = torch.take_along_dim(p, grow, dim=-2)[..., 0, :]       # [..., w]
    gcol = torch.clamp(gc, 0, w - 1).expand(*batch, h, 1).long()
    pcol = torch.take_along_dim(p, gcol, dim=-1)[..., 0]          # [..., h]

    def prefix_and_1d(v, gpos, n):
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        blk = (~v).to(torch.int32)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        right = torch.cumsum(torch.where(idx >= gpos, blk, zero), dim=-1)
        left = torch.flip(torch.cumsum(torch.flip(
            torch.where(idx <= gpos, blk, zero), (-1,)), dim=-1), (-1,))
        return torch.where(idx >= gpos, right == 0, left == 0)

    row_tab = prefix_and_1d(prow, gc[..., 0, :], w)               # [..., w]
    col_tab = prefix_and_1d(pcol, gr[..., :, 0], h)               # [..., h]

    def shear(x, amount, sgn, axis_dc):
        for k in range(nbits):
            s = 1 << k
            bit = ((amount >> k) & 1) == 1
            if axis_dc:
                xp, xm = shift2d(x, 0, s, False), shift2d(x, 0, -s, False)
            else:
                xp, xm = shift2d(x, s, 0, False), shift2d(x, -s, 0, False)
            x = torch.where(bit & (sgn > 0), xp,
                            torch.where(bit & (sgn < 0), xm, x))
        return x

    full = torch.broadcast_shapes(p.shape, sr.shape)
    c_row = shear(row_tab[..., None, :].expand(*row_tab.shape[:-1], h, w),
                  adr, sc, True)
    c_col = shear(col_tab[..., :, None].expand(*col_tab.shape[:-1], h, w),
                  adc, sr, False)
    c_sel = torch.where(adr <= adc, c_row, c_col)

    quad = torch.zeros(full, dtype=torch.bool, device=dev)
    for qr in (-1, 1):
        for qc in (-1, 1):
            ok = p & shift2d(p, qr, 0, False) & shift2d(p, 0, qc, False)
            mask = (sr == qr) & (sc == qc)
            d = torch.where(mask, ok, True)
            for k in range(nbits):
                s = 1 << k
                d = d & shift2d(d, qr * s, qc * s, True)
            quad = torch.where(mask, d & c_sel, quad)

    los = torch.where(dr == 0, row_tab[..., None, :].expand(full),
                      torch.where(dc == 0, col_tab[..., :, None].expand(full),
                                  quad))
    return los.to(torch.uint8)


def seed_from_point(h: int, w: int, r, c, device) -> torch.Tensor:
    """bool[h, w] seed mask with a single tile set."""
    rows = torch.arange(h, device=device)[:, None]
    cols = torch.arange(w, device=device)[None, :]
    return (rows == r) & (cols == c)


def _dir_unit_table() -> torch.Tensor:
    t = torch.tensor([[float(dc), float(dr)] for dr, dc in FLOW_DIR_OFFSETS],
                     dtype=torch.float32)
    norm = torch.sqrt(t[:, 0:1] * t[:, 0:1] + t[:, 1:2] * t[:, 1:2])
    return torch.where(norm > 0, t / torch.clamp(norm, min=1e-9), 0.0)


# FlowDir code -> unit world direction (x = east/cols+, z = south/rows+);
# code 0 (NONE) maps to the zero vector.
DIR_UNIT_TABLE = _dir_unit_table()


def dir_code_to_vec(codes: torch.Tensor) -> torch.Tensor:
    """u8 FlowDir codes -> f32 unit vectors [..., 2] (x, z)."""
    return DIR_UNIT_TABLE.to(codes.device)[codes.long()]
