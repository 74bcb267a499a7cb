"""Boids steering forces over the entity arena.

Port of ``permafrost_engine_tpu/ops/boids.py`` (ref: src/game/movement.c:
418-437, force builders movement.c:1524-2023): separation, flow/arrive
seek, alignment over the shared neighbour window, cohesion from per-(flock,
cell) sums box-filtered over 7x7 cells, and the formation keep force. The
JAX version's per-pair cohesion (``cohesion_force``) and its arena-gather
fallbacks serve no caller of the movement substep and are not ported.
Velocities are per-movement-tick displacements.
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
    max_len = torch.as_tensor(max_len, dtype=v.dtype, device=v.device)[..., None]
    scale = torch.where(n > max_len, max_len / torch.clamp(n, min=_EPS), 1.0)
    return v * scale


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


def formation_keep_force(pos, vel, flock, cell, has_cell, flock_formation,
                         max_flocks: int):
    """Formation cohesion + drag toward the unit's cell offset from the
    moving flock centroid; zero for flocks without a FormationType."""
    dev = pos.device
    in_formation = flock_formation[torch.clamp(flock, 0, max_flocks - 1).long()] > 0
    m = has_cell & (flock >= 0) & in_formation
    idx = torch.where(m, flock, max_flocks).long()
    cnt = torch.zeros(max_flocks + 1, dtype=torch.float32, device=dev
                      ).index_add_(0, idx, torch.ones_like(pos[:, 0]))
    m2 = torch.where(m[:, None], 1.0, 0.0)
    psum = torch.zeros((max_flocks + 1, 2), dtype=torch.float32, device=dev
                       ).index_add_(0, idx, pos * m2)
    csum = torch.zeros((max_flocks + 1, 2), dtype=torch.float32, device=dev
                       ).index_add_(0, idx, cell * m2)
    denom = torch.clamp(cnt, min=1.0)[:, None]
    pc, cc = psum / denom, csum / denom
    target = pc[idx] + (cell - cc[idx])
    keep = truncate(target - pos, MAX_FORCE) * FORMATION_COHESION_FORCE
    near_cell = _norm(cell - pos) < CELL_ARRIVAL_RADIUS
    drag = torch.where(near_cell[:, None], -vel * FORMATION_DRAG, 0.0)
    return torch.where(m[:, None], keep + drag, 0.0)


def preferred_velocity(pos, vel, flock, dest, flow_dir, use_arrive,
                       max_speed_tick, neigh_idx, neigh_valid, moving, *,
                       neigh_pos, neigh_vel, neigh_flock, coh_centroid,
                       coh_cnt, formation_cell=None, has_cell=None,
                       flock_formation=None, max_flocks: int = 0):
    """Combined steering -> preferred per-tick velocity for the HRVO solve
    (ref: movement.c:3414-3452); zero for entities not moving. Neighbour
    attributes come from the grid window's payload, cohesion from
    ``flock_cohesion_centroids`` (the movement substep's only form)."""
    seek = torch.where(use_arrive[..., None],
                       arrive_force(pos, dest, vel, max_speed_tick),
                       flow_follow_force(flow_dir, vel, max_speed_tick))
    sep = separation_force(pos, neigh_idx, neigh_valid, neigh_pos)
    coh = cohesion_force_from_centroid(pos, coh_centroid, coh_cnt)
    ali = alignment_force(vel, flock, neigh_idx, neigh_valid, neigh_pos,
                          neigh_vel, neigh_flock, pos)
    total = seek + sep + coh + ali
    if (formation_cell is not None and has_cell is not None
            and flock_formation is not None and max_flocks):
        total = total + formation_keep_force(
            pos, vel, flock, formation_cell, has_cell, flock_formation,
            max_flocks)
    total = truncate(total, MAX_FORCE)
    vpref = truncate(vel + total, max_speed_tick)
    return torch.where(moving[..., None], vpref, 0.0)
