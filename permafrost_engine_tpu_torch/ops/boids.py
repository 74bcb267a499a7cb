"""Boids steering forces over the entity arena.

Port of ``permafrost_engine_tpu/ops/boids.py`` (ref: src/game/movement.c:
418-437, force builders movement.c:1524-2023): separation, flow/arrive
seek, alignment over the shared neighbour window, cohesion from per-(flock,
cell) sums box-filtered over 7x7 cells (the movement substep's form) or
per pair over an explicit neighbour set (``cohesion_force``), and the
formation keep force. Velocities are per-movement-tick displacements.
"""

from __future__ import annotations

import torch

from permafrost_engine_tpu_torch.core.config import (
    ALIGNMENT_FORCE,
    ALIGNMENT_RADIUS,
    ARRIVE_FORCE,
    ARRIVE_SLOWING_RADIUS,
    CELL_ARRIVAL_RADIUS,
    COHESION_FORCE,
    COHESION_RADIUS,
    FORMATION_COHESION_FORCE,
    FORMATION_DRAG,
    MAX_FORCE,
    SEPARATION_FORCE,
    SEPARATION_RADIUS,
)

_EPS = 1e-6


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def truncate(v: torch.Tensor, max_len) -> torch.Tensor:
    """Clamp vector magnitudes to max_len ([..., 2] over [...])."""
    n = _norm(v)[..., None]
    if isinstance(max_len, torch.Tensor):
        max_len = max_len[..., None]
    else:           # a device fill, not a host-to-device copy
        max_len = torch.full_like(n, max_len)
    scale = torch.where(n > max_len, max_len / torch.clamp(n, min=_EPS), 1.0)
    return v * scale


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-neighbour values x[idx] for idx [N, K]; -1 (invalid) is clamped
    to row 0 as in JAX, not wrapped to the last row."""
    return x[torch.clamp(idx, 0, x.shape[0] - 1).long()]


def arrive_force(pos, dest, vel, max_speed_tick):
    to_dest = dest - pos
    dist = _norm(to_dest)[..., None]
    speed = max_speed_tick[..., None] * torch.clamp(
        dist / ARRIVE_SLOWING_RADIUS, max=1.0)
    desired = to_dest / torch.clamp(dist, min=_EPS) * speed
    return truncate(desired - vel, MAX_FORCE) * ARRIVE_FORCE


def flow_follow_force(flow_dir, vel, max_speed_tick):
    return truncate(flow_dir * max_speed_tick[..., None] - vel, MAX_FORCE)


def separation_force(pos, neigh_idx, neigh_valid, neigh_pos):
    diff = pos[:, None, :] - neigh_pos
    d = _norm(diff)
    in_range = neigh_valid & (d < SEPARATION_RADIUS)
    w = torch.where(in_range, 1.0 / torch.clamp(d * d, min=0.25), 0.0)
    force = (diff * w[..., None]).sum(1)
    return truncate(force, MAX_FORCE) * SEPARATION_FORCE


def cohesion_force(pos, flock, neigh_idx, neigh_valid, neigh_pos, neigh_flock):
    """Steer toward the centroid of same-flock neighbours within radius."""
    d = _norm(neigh_pos - pos[:, None, :])
    mate = neigh_valid & (neigh_flock == flock[:, None]) & (flock[:, None] >= 0)
    in_range = mate & (d < COHESION_RADIUS)
    cnt = in_range.sum(1)
    centroid = torch.where(in_range[..., None], neigh_pos, 0.0).sum(1)
    centroid = centroid / torch.clamp(cnt, min=1)[..., None]
    force = torch.where((cnt > 0)[..., None], centroid - pos, 0.0)
    return truncate(force, MAX_FORCE) * COHESION_FORCE


def _box_sum(g: torch.Tensor, dim: int, box: int) -> torch.Tensor:
    """Zero-padded centred box sum of width `box` along `dim` (the JAX
    reduce_window "SAME" add)."""
    half = box // 2
    n = g.shape[dim]
    pad_shape = list(g.shape)
    pad_shape[dim] = half
    z = torch.zeros(pad_shape, dtype=g.dtype, device=g.device)
    gp = torch.cat([z, g, z], dim=dim)
    out = torch.zeros_like(g)
    for i in range(box):
        out += gp.narrow(dim, i, n)
    return out


def flock_cohesion_centroids(pos, flock, mask, *, cells_r, cells_c,
                             cell_size, max_flocks, box: int = 7):
    """Per-entity same-flock centroid via fixed-point integer per-(flock,
    cell) sums and a separable (box x box)-cell box filter. The fixed-point
    scale is the code's, 2^(22 - ceil(log2 extent)): 1/2048 u at the
    default 1024 u world (the JAX docstring's 1/4096 is wrong). Returns
    (centroid f32[N,2], own position where alone; cnt f32[N])."""
    num_cells = cells_r * cells_c
    dev = pos.device
    c = torch.clamp((pos[:, 0] / cell_size).to(torch.int32), 0, cells_c - 1)
    r = torch.clamp((pos[:, 1] / cell_size).to(torch.int32), 0, cells_r - 1)
    ok = mask & (flock >= 0)
    f = torch.clamp(flock, 0, max_flocks - 1)
    cell = r * cells_c + c
    idx = torch.where(ok, f * num_cells + cell, max_flocks * num_cells)
    extent = float(max(cells_r, cells_c)) * float(cell_size)
    scale_bits = 12
    while scale_bits > 0 and extent * (1 << scale_bits) > 2.0 ** 22 - 1:
        scale_bits -= 1
    scale = float(1 << scale_bits)
    item = torch.clamp(torch.round(pos * scale), 0, 2.0 ** 22 - 1
                       ).to(torch.int32)
    q, rem = item >> 11, item & 2047
    one = torch.ones((pos.shape[0], 1), dtype=torch.int32, device=dev)
    vals = torch.where(ok[:, None], torch.cat([q, rem, one], dim=1), 0)
    sums = torch.zeros((max_flocks * num_cells + 1, 5), dtype=torch.int32,
                       device=dev)
    sums.index_add_(0, idx.long(), vals)
    g = sums[:-1].reshape(max_flocks, cells_r, cells_c, 5)
    g = _box_sum(_box_sum(g, 1, box), 2, box)
    flat = g.reshape(max_flocks * num_cells, 5)
    row = flat[torch.where(ok, f * num_cells + cell, 0).long()]
    pos_sum = (row[:, 0:2].to(torch.float32) * 2048.0
               + row[:, 2:4].to(torch.float32)) / scale
    cnt = torch.where(ok, (row[:, 4] - 1).to(torch.float32), 0.0)
    own = item.to(torch.float32) / scale
    centroid = torch.where((cnt > 0.5)[:, None],
                           (pos_sum - own) / torch.clamp(cnt, min=1.0)[:, None],
                           pos)
    return centroid, cnt


def cohesion_force_from_centroid(pos, centroid, cnt):
    force = torch.where((cnt > 0.5)[:, None], centroid - pos, 0.0)
    return truncate(force, MAX_FORCE) * COHESION_FORCE


def alignment_force(vel, flock, neigh_idx, neigh_valid, neigh_pos, neigh_vel,
                    neigh_flock, pos):
    d = _norm(neigh_pos - pos[:, None, :])
    mate = neigh_valid & (neigh_flock == flock[:, None]) & (flock[:, None] >= 0)
    in_range = mate & (d < ALIGNMENT_RADIUS)
    cnt = in_range.sum(1)
    avg = torch.where(in_range[..., None], neigh_vel, 0.0).sum(1)
    avg = avg / torch.clamp(cnt, min=1)[..., None]
    force = torch.where((cnt > 0)[..., None], avg - vel, 0.0)
    return truncate(force, MAX_FORCE) * ALIGNMENT_FORCE


_SUM_BITS = 32   # fixed-point scale of the formation sums: 2^-32 u


def _flock_sums(idx, vals, rows: int) -> torch.Tensor:
    """Per-row sums of f32 vals[N, 2] over idx, as f32. A CUDA ``index_add_``
    adds f32 atomically in any order, so its rounding (an ulp of 0.25 at a
    4,000-unit flock's ~2e6) changes from run to run; here each value is an
    int64 multiple of 2^-32, so the sums are the same in any order and so is
    their f32 rounding. The integer sums are exact for 2^-9 <= |v| < 2^11
    and up to 2^19 entities; a smaller |v| is rounded by 2^-33 at most."""
    fixed = torch.round(vals.to(torch.float64) * 2.0 ** _SUM_BITS).to(torch.int64)
    sums = torch.zeros((rows, vals.shape[1]), dtype=torch.int64,
                       device=vals.device).index_add_(0, idx, fixed)
    return (sums.to(torch.float64) * 2.0 ** -_SUM_BITS).to(torch.float32)


def formation_keep_force(pos, vel, flock, cell, has_cell, flock_formation,
                         max_flocks: int, rows: slice = slice(None)):
    """Formation cohesion + drag toward the unit's cell offset from the
    moving flock centroid; zero for flocks without a FormationType. The
    per-flock sums are exact (``_flock_sums``), where the JAX version adds
    in f32 in scatter order: the centroids agree to the f32 sum's rounding
    and, unlike an f32 atomic scatter, are the same on every run. The sums
    run over every entity; the force is returned for the entities `rows`
    (all by default)."""
    dev = pos.device
    in_formation = flock_formation[torch.clamp(flock, 0, max_flocks - 1).long()] > 0
    m = has_cell & (flock >= 0) & in_formation
    idx = torch.where(m, flock, max_flocks).long()
    cnt = torch.zeros(max_flocks + 1, dtype=torch.int32, device=dev
                      ).index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32)
                                   ).to(torch.float32)
    m2 = torch.where(m[:, None], 1.0, 0.0)
    psum = _flock_sums(idx, pos * m2, max_flocks + 1)
    csum = _flock_sums(idx, cell * m2, max_flocks + 1)
    denom = torch.clamp(cnt, min=1.0)[:, None]
    pc, cc = psum / denom, csum / denom
    m, idx, pos, vel, cell = m[rows], idx[rows], pos[rows], vel[rows], cell[rows]
    target = pc[idx] + (cell - cc[idx])
    keep = truncate(target - pos, MAX_FORCE) * FORMATION_COHESION_FORCE
    near_cell = _norm(cell - pos) < CELL_ARRIVAL_RADIUS
    drag = torch.where(near_cell[:, None], -vel * FORMATION_DRAG, 0.0)
    return torch.where(m[:, None], keep + drag, 0.0)


def preferred_velocity(pos, vel, flock, dest, flow_dir, use_arrive,
                       max_speed_tick, neigh_idx, neigh_valid, moving, *,
                       neigh_pos=None, neigh_vel=None, neigh_flock=None,
                       coh_centroid=None, coh_cnt=None, keep=None):
    """Combined steering -> preferred per-tick velocity for the HRVO solve
    (ref: movement.c:3414-3452); zero for entities not moving. Neighbour
    positions, velocities and flocks are gathered from the arena by
    `neigh_idx` where not given (the movement substep passes the grid
    window's payload). Cohesion comes from ``flock_cohesion_centroids``'
    `coh_centroid` and `coh_cnt` (the movement substep's form), or per pair
    (``cohesion_force``) without them. `keep` is the formation keep force
    (``formation_keep_force``; None without formations)."""
    if neigh_pos is None:
        neigh_pos = _gather(pos, neigh_idx)
    if neigh_vel is None:
        neigh_vel = _gather(vel, neigh_idx)
    if neigh_flock is None:
        neigh_flock = _gather(flock, neigh_idx)
    seek = torch.where(use_arrive[..., None],
                       arrive_force(pos, dest, vel, max_speed_tick),
                       flow_follow_force(flow_dir, vel, max_speed_tick))
    sep = separation_force(pos, neigh_idx, neigh_valid, neigh_pos)
    if coh_centroid is not None and coh_cnt is not None:
        coh = cohesion_force_from_centroid(pos, coh_centroid, coh_cnt)
    else:
        coh = cohesion_force(pos, flock, neigh_idx, neigh_valid, neigh_pos,
                             neigh_flock)
    ali = alignment_force(vel, flock, neigh_idx, neigh_valid, neigh_pos,
                          neigh_vel, neigh_flock, pos)
    total = seek + sep + coh + ali
    if keep is not None:
        total = total + keep
    total = truncate(total, MAX_FORCE)
    vpref = truncate(vel + total, max_speed_tick)
    return torch.where(moving[..., None], vpref, 0.0)
