"""Movement integration + state machine as masked dense updates.

The benchmark's frozen copy of
``permafrost_engine_tpu_torch/ops/integrate.py``, taken when the benchmark
was defined and kept as it was: part of the plain reference that
``benchmark/check.py`` holds the program against. It imports nothing of the
program and nothing of JAX.

Port of ``permafrost_engine_tpu/ops/integrate.py`` (ref:
entity_compute_update, src/game/movement.c:2303-2421): position advance
with pathability rejection and wall sliding, the heading gate, stuck and
wedge counters, arrival, WAITING, velocity history and facing, and the
capped de-penetration pushout.
"""

from __future__ import annotations

import functools
import math

import torch

from benchmark.reference.config import (
    ARRIVAL_THRESHOLD,
    CELL_ARRIVAL_RADIUS,
    COST_IMPASSABLE,
    HEADING_HALT_DEG,
    HEADING_RESUME_DEG,
    MAX_TURN_RATE_DEG,
    MoveState,
    NAV_TILE_SIZE,
    VEL_HIST_LEN,
    WAIT_TICKS,
)


@functools.cache
def _unit_axes(device: torch.device):
    """The x and z unit vectors on `device`, made once per device (never a
    host-to-device copy inside a tick)."""
    return (torch.tensor([1.0, 0.0], device=device),
            torch.tensor([0.0, 1.0], device=device))


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


@functools.cache
def _deg2rad(deg: float) -> float:
    """The f32 radians jnp.deg2rad gives for a constant."""
    return float(torch.deg2rad(torch.tensor(deg, dtype=torch.float32)))


def _angle_of(v: torch.Tensor) -> torch.Tensor:
    """Heading angle of (x, z) vectors; 0 at -z ("north")."""
    return torch.atan2(v[..., 0], -v[..., 1])


def _wrap_pi(a: torch.Tensor) -> torch.Tensor:
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def facing_from_history(vel_hist: torch.Tensor, facing: torch.Tensor) -> torch.Tensor:
    """Weighted moving average of the velocity-history ring, recent entries
    weighing more (ref: movement.c orient_to_velocity_history:2291)."""
    h = vel_hist.shape[1]
    w = torch.arange(1, h + 1, dtype=torch.float32, device=vel_hist.device
                     )[None, :, None]
    avg = (vel_hist * w).sum(1) / w.sum()
    return torch.where(_norm(avg) > 1e-3, _angle_of(avg), facing)


def tile_passable(pos, layer, cost_base, blockers):
    """(passable, blocked) at each entity's nav tile for its layer. A layer
    beyond the configured ones reads the last (JAX clamps gather indices:
    a config with fewer layers than footprints does this)."""
    h, w = cost_base.shape[-2], cost_base.shape[-1]
    c = torch.clamp((pos[:, 0] / NAV_TILE_SIZE).to(torch.int32), 0, w - 1).long()
    r = torch.clamp((pos[:, 1] / NAV_TILE_SIZE).to(torch.int32), 0, h - 1).long()
    in_bounds = ((pos[:, 0] >= 0) & (pos[:, 0] < w * NAV_TILE_SIZE)
                 & (pos[:, 1] >= 0) & (pos[:, 1] < h * NAV_TILE_SIZE))
    lay = torch.clamp(layer, 0, cost_base.shape[0] - 1).long()
    return ((cost_base[lay, r, c] != COST_IMPASSABLE) & in_bounds,
            blockers[lay, r, c] > 0)


def movement_update(*, alive, moving_mask, pos, new_vel, dest, movestate,
                    facing, vel_hist, vel_hist_idx, wait_ticks, stuck_ticks,
                    layer, cost_base, blockers, garrisoned, flock_arrived,
                    has_cell, depen=None, slot=None):
    """One movement-tick integration pass. Returns a dict of updated fields
    plus an `arrived` event mask (see the JAX function for the rules).
    `slot` i32[N] holds the rows' arena slots (default 0..N-1), which set
    each unit's wait jitter."""
    dev = pos.device
    st = movestate
    was_moving = moving_mask & alive

    vel_angle = _angle_of(new_vel)
    speed = _norm(new_vel)
    heading_err = _wrap_pi(vel_angle - facing).abs()
    need_turn = was_moving & (speed > 1e-3) & (heading_err > _deg2rad(HEADING_HALT_DEG))
    turning = st == MoveState.TURNING
    turn_step = _deg2rad(MAX_TURN_RATE_DEG)
    delta = _wrap_pi(vel_angle - facing)
    turn_facing = facing + torch.clamp(delta, -turn_step, turn_step)
    resume = turning & (delta.abs() < _deg2rad(HEADING_RESUME_DEG))

    advance = was_moving & ~need_turn & ~turning
    vel_adv = torch.where(advance[:, None], new_vel, 0.0)
    _, was_blocked = tile_passable(pos, layer, cost_base, blockers)

    def _ok(cand):
        passable, cand_blocked = tile_passable(cand, layer, cost_base, blockers)
        return passable & (~cand_blocked | was_blocked)

    ex, ez = _unit_axes(dev)

    def _slide(base, vel):
        vx, vz = vel * ex, vel * ez
        ok_full, ok_x, ok_z = _ok(base + vel), _ok(base + vx), _ok(base + vz)
        prefer_x = vel[:, 0].abs() >= vel[:, 1].abs()
        first = torch.where(prefer_x[:, None], vx, vz)
        second = torch.where(prefer_x[:, None], vz, vx)
        ok_first = torch.where(prefer_x, ok_x, ok_z)
        ok_second = torch.where(prefer_x, ok_z, ok_x)
        return torch.where(ok_full[:, None], vel,
                           torch.where(ok_first[:, None], first,
                                       torch.where(ok_second[:, None], second,
                                                   0.0)))

    new_pos = pos + _slide(pos, vel_adv)
    eff_vel = new_pos - pos

    d_before = _norm(dest - pos)
    d_after = _norm(dest - new_pos)
    vmag = _norm(new_vel)
    closing = (d_before - d_after) > torch.clamp(0.1 * vmag, min=0.05)
    far = d_after >= 5 * ARRIVAL_THRESHOLD
    moving_well = _norm(new_pos - pos) > torch.clamp(0.3 * vmag, min=0.02)
    progressing = closing | (far & moving_well)
    new_stuck = torch.clamp(
        stuck_ticks + torch.where(was_moving & ~progressing, 1, -2
                                  ).to(torch.int32), 0, 100)

    dist_dest = _norm(dest - new_pos)
    arrived_now = was_moving & (dist_dest < ARRIVAL_THRESHOLD)
    arrived_now = arrived_now | (
        was_moving & (new_stuck > 12) & (dist_dest < 5 * ARRIVAL_THRESHOLD))
    jammed = _norm(eff_vel) < torch.clamp(0.15 * vmag, min=0.02)
    arrived_now = arrived_now | (
        was_moving & flock_arrived & (
            ((dist_dest < CELL_ARRIVAL_RADIUS) & (~has_cell | (new_stuck > 8)))
            | (jammed & (new_stuck > 8))))
    arrived_now = arrived_now | (garrisoned & alive)

    wait_now = (was_moving & ~turning & ~need_turn & jammed & ~flock_arrived
                & (new_stuck > 20) & (dist_dest >= 5 * ARRIVAL_THRESHOLD)
                & ~arrived_now)
    waiting = st == MoveState.WAITING
    new_wait = torch.where(waiting, torch.clamp(wait_ticks - 1, min=0), wait_ticks)
    if slot is None:
        slot = torch.arange(pos.shape[0], dtype=torch.int32, device=dev)
    jitter = slot % 16
    new_wait = torch.where(wait_now, WAIT_TICKS + 4 * jitter, new_wait)
    wait_done = waiting & (new_wait == 0)

    new_st = st
    new_st = torch.where(wait_done, int(MoveState.MOVING), new_st)
    new_st = torch.where(need_turn & ~turning, int(MoveState.TURNING), new_st)
    new_st = torch.where(resume, int(MoveState.MOVING), new_st)
    new_st = torch.where(wait_now, int(MoveState.WAITING), new_st)
    new_st = torch.where(arrived_now, int(MoveState.ARRIVED), new_st)
    new_st = torch.where(alive, new_st, st)

    idx = (vel_hist_idx % VEL_HIST_LEN).long()
    vh = vel_hist.clone()
    vh[torch.arange(pos.shape[0], device=dev), idx] = eff_vel
    new_idx = (vel_hist_idx + 1) % VEL_HIST_LEN
    new_facing = torch.where(turning | need_turn, turn_facing,
                             facing_from_history(vh, facing))
    new_facing = torch.where(alive, new_facing, facing)

    out_vel = torch.where((arrived_now | ~was_moving)[:, None], 0.0, eff_vel)
    final_pos = new_pos if depen is None else new_pos + _slide(new_pos, depen)

    return dict(
        pos=final_pos,
        vel=out_vel,
        movestate=new_st,
        facing=new_facing,
        vel_hist=vh,
        vel_hist_idx=new_idx,
        wait_ticks=new_wait,
        stuck_ticks=torch.where(arrived_now | wait_now, 0, new_stuck),
        arrived=arrived_now & (st != MoveState.ARRIVED),
    )
