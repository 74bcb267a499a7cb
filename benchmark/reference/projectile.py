"""Projectile physics: ballistic step, swept hit test, on-device spawning.

The benchmark's frozen copy of
``permafrost_engine_tpu_torch/ops/projectile.py``, taken when the benchmark
was defined and kept as it was: part of the plain reference that
``benchmark/check.py`` holds the program against. It imports nothing of the
program and nothing of JAX.

Port of ``permafrost_engine_tpu/ops/projectile.py`` (ref:
src/phys/projectile.c: 30 Hz batch update, ballistic integration :178,
swept hit test :282-354, approximated as a segment against the entity's
selection-radius cylinder; damage carried in the cookie and applied on hit,
combat.c:1020; arc launcher P_Projectile_VelocityForTarget :594).

Ranged attackers take pool slots on the device: free slots in a stable
order (``argsort(stable=True)`` of ``active``) matched to shooters by a
cumsum rank, so a volley never visits the host. Writes that JAX drops
(``mode="drop"``) land on a spare row that is cut off.
"""

from __future__ import annotations

import functools

import torch

from benchmark.reference.config import (
    DiplomacyState,
    EngineConfig,
    EntityFlags,
    PROJECTILE_HZ,
)
from benchmark.reference.rounding import fma, sqrt

GRAVITY = 98.0          # world units / s^2 (scaled to 8-unit tiles)
PROJ_SPEED = 120.0      # default launch speed, world units / s
LAUNCH_HEIGHT = 4.0
HIT_HEIGHT_TOL = 6.0
DT = 1.0 / PROJECTILE_HZ


@functools.cache
def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def launch_velocity(src_xz, dst_xz, speed: float = PROJ_SPEED):
    """Arc velocity reaching dst at the same height (the flat-ground
    solution of P_Projectile_VelocityForTarget): (vxz [..., 2], vy [...],
    flight time [...]).

    Rounded as XLA compiles the JAX expression on the CPU: the division by
    the constant speed becomes a multiply by its f32 reciprocal, and
    ``0.5 * GRAVITY * t`` folds into one constant factor on the distance."""
    d = dst_xz - src_xz
    dist = sqrt(fma(d[..., 1:2], d[..., 1:2], d[..., 0:1] * d[..., 0:1]))
    inv_speed = _f32(1.0 / speed)
    t = dist * inv_speed
    vxz = d / torch.clamp(t, min=1e-6)
    vy = dist[..., 0] * _f32(inv_speed * _f32(0.5 * GRAVITY))
    return vxz, vy, t[..., 0]


def _put(dst: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """dst with dst[idx] = val (a tensor, or a Python scalar for every
    index), where idx == len(dst) is dropped."""
    out = torch.cat([dst, dst[:1]])
    if isinstance(val, torch.Tensor):
        out[idx] = val
    else:
        out.index_fill_(0, idx, val)
    return out[:-1]


def spawn_projectiles(cfg: EngineConfig, proj, shooter_mask, pos, target_pos,
                      faction, damage):
    """Allocate pool slots for this substep's shooters (bool[N]) and write
    their projectiles: launched from `pos` at `target_pos` (f32[N, 2]),
    owned by `faction`, carrying `damage` as the cookie. Shooters past the
    free slots are dropped. Updates `proj` in place and returns it."""
    n = shooter_mask.shape[0]
    p = cfg.max_projectiles
    dev = pos.device
    free_order = torch.argsort(proj.active.to(torch.uint8), stable=True)
    num_free = (~proj.active).sum()
    rank = torch.cumsum(shooter_mask.to(torch.int64), 0) - 1
    can = shooter_mask & (rank < num_free) & (rank < p)
    slot = free_order[torch.clamp(rank, 0, p - 1)]
    slot = torch.where(can, slot, p)

    vxz, vy, _ = launch_velocity(pos, target_pos)
    vel3 = torch.stack([vxz[:, 0], vy, vxz[:, 1]], 1)
    pos3 = torch.stack([pos[:, 0], torch.full((n,), LAUNCH_HEIGHT, device=dev),
                        pos[:, 1]], 1)
    proj.active = _put(proj.active, slot, True)
    proj.pos = _put(proj.pos, slot, pos3)
    proj.vel = _put(proj.vel, slot, vel3)
    proj.faction = _put(proj.faction, slot, faction)
    proj.parent = _put(proj.parent, slot,
                       torch.arange(n, dtype=torch.int32, device=dev))
    proj.cookie = _put(proj.cookie, slot, damage)
    return proj


def projectile_substep(cfg: EngineConfig, state, deltas):
    """One 30 Hz physics tick: integrate, test hits (the nearest enemy whose
    cylinder the tick's travel segment passes), apply damage, record hits
    in `deltas` (target, shooter, cookie). Returns (state, deltas)."""
    proj = state.projectiles
    ents = state.ents
    p = cfg.max_projectiles
    n = cfg.max_ents
    dev = ents.pos.device

    new_pos = fma(proj.vel, _f32(DT), proj.pos)
    new_vel = proj.vel.clone()
    new_vel[:, 1] -= GRAVITY * DT

    # ---- hit test: nearest enemy entity within its selection radius ---------
    ox, oz = proj.pos[:, 0:1], proj.pos[:, 2:3]
    sx, sz = new_pos[:, 0:1] - ox, new_pos[:, 2:3] - oz         # segment
    seg_len2 = fma(sz, sz, sx * sx)
    targetable = ents.alive & (ents.hp > 0.0) & (
        (ents.flags & int(EntityFlags.COMBATABLE)) != 0)
    war = state.factions.diplomacy == DiplomacyState.WAR
    f = war.shape[0]
    efac = torch.clamp(ents.faction, 0, f - 1).long()
    pfac = torch.clamp(proj.faction, 0, f - 1).long()[:, None]
    ny = new_pos[:, 1:2]
    best_d2 = torch.full((p,), float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.full((p,), -1, dtype=torch.int64, device=dev)
    block = min(1024, n)
    for s in range(0, n, block):
        bpos = ents.pos[s:s + block]
        bx, bz = bpos[None, :, 0], bpos[None, :, 1]
        rx, rz = bx - ox, bz - oz
        t = torch.clamp(fma(rz, sz, rx * sx) / torch.clamp(seg_len2, min=1e-9),
                        0.0, 1.0)
        cx = fma(sx, t, ox) - bx
        cz = fma(sz, t, oz) - bz
        d2 = fma(cz, cz, cx * cx)
        hit_r = ents.sel_radius[None, s:s + block] + 0.5
        # the JAX bit test reads war[entity faction, projectile faction]
        ok = (targetable[None, s:s + block]
              & war[efac[None, s:s + block], pfac]
              & (d2 <= hit_r * hit_r)
              & ((ny - ents.height[None, s:s + block]).abs() < HIT_HEIGHT_TOL))
        d2 = torch.where(ok, d2, float("inf"))
        bi = torch.argmin(d2, dim=1)
        bd2 = torch.gather(d2, 1, bi[:, None])[:, 0]
        better = bd2 < best_d2
        best_d2 = torch.where(better, bd2, best_d2)
        best_i = torch.where(better, bi + s, best_i)
    hit = proj.active & (best_i >= 0) & torch.isfinite(best_d2)

    # ---- ground impact ------------------------------------------------------------
    grounded = proj.active & (new_pos[:, 1] <= 0.0) & ~hit

    # ---- damage (cookie * (1 - armour)) -----------------------------------------
    ti = torch.clamp(best_i, 0, n - 1)
    dmg = torch.where(hit, proj.cookie * (1.0 - ents.armour_pc[ti]), 0.0)
    dmg_in = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    dmg_in.index_add_(0, torch.where(hit, ti, n), dmg)
    ents.hp = torch.where(ents.alive, ents.hp - dmg_in[:n], ents.hp)

    hit_i = best_i.to(torch.int32)
    deltas.proj_hit = torch.where(hit, hit_i, deltas.proj_hit)
    deltas.proj_hit_shooter = torch.where(hit, proj.parent,
                                          deltas.proj_hit_shooter)
    deltas.proj_hit_cookie = torch.where(hit, proj.cookie,
                                         deltas.proj_hit_cookie)
    proj.active = proj.active & ~hit & ~grounded
    proj.pos = new_pos
    proj.vel = new_vel
    return state, deltas
