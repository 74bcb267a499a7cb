"""The simulation tick: the 60 Hz frame counter and its substeps.

The benchmark's frozen copy of ``permafrost_engine_tpu_torch/game/step.py``,
taken when the benchmark was defined and kept as it was: part of the plain
reference that ``benchmark/check.py`` holds the program against. It imports
nothing of the program and nothing of JAX.

Port of ``permafrost_engine_tpu/game/step.py``. The reference runs
decimated event rates off a 60 Hz timer (ref: src/game/timer_events.c:
107-122); here the counter and the cadence gates live on the host, so a
frame that runs no substep launches nothing and no gate syncs the device.

The movement substep is the reference's move_do_tick pipeline (ref:
movement.c:4312-4413): composite-key grid build -> 3x3 neighbour window ->
flow-field and LOS sampling -> boids preferred velocity -> HRVO solve
(kernel K1, ``ops/crowd_cuda.hrvo_select``) -> de-penetration and contact
projection -> integration and state machine -> blocker restamp.

The other substeps follow the JAX tick's order and rates: combat (10 Hz,
``ops/combat.py``; ranged attackers spawn projectiles), projectiles (30
Hz, ``ops/projectile.py``), corpses (1 Hz) and fog (``cfg.fog_hz``,
``ops/fog.py``; the shadowcaster when the map has a ``tile_height``) and,
last, skinning (``cfg.skin_hz``, ``ops/skin.py``) when a ``SkinBank`` is
given.

The reference runs its ticks one by one on one device (the program's
``make_tick_scan``, which replays them as CUDA graphs, and its mesh
partition are left out).
"""

from __future__ import annotations

import torch

from benchmark.reference.config import (
    ARRIVE_SLOWING_RADIUS,
    CONTACT_CELL_SIZE,
    CombatState,
    EngineConfig,
    EntityFlags,
    FRAME_HZ,
    MoveState,
    NAV_TILE_SIZE,
    NUM_FOOTPRINTS,
)
from benchmark.reference import boids, grid
from benchmark.reference import combat as combat_ops
from benchmark.reference import fog as fog_ops
from benchmark.reference import integrate as integ_ops
from benchmark.reference import projectile as proj_ops
from benchmark.reference import velocity as vel_ops
from benchmark.reference import skin as skin_ops
from benchmark.reference.crowd import hrvo_select_plain as hrvo_select

_DEPEN_CAP = 0.25     # world units per move tick


def _has(flags: torch.Tensor, bit: EntityFlags) -> torch.Tensor:
    return (flags & int(bit)) != 0


def _grow3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max dilation of a non-negative [H, W] grid (zero outside), as
    two 3-wide separable passes (the JAX reduce_window max)."""
    return fog_ops.max3_cols(fog_ops.max3_rows(x))


def _restamp_blockers(cfg: EngineConfig, ents):
    """Dense blocker rebuild: stationary collidable ground entities stamp
    their nav tile; footprint layers see the stamp dilated 1 -> 3 -> 5 -> 7
    (ref: N_BlockersIncref nav.c:4663). Returns the new blockers grid
    i32[L, H, W]."""
    h, w = cfg.field_h, cfg.field_w
    grows = min(NUM_FOOTPRINTS, cfg.num_layers) - 1
    stationary = (ents.alive & _has(ents.flags, EntityFlags.COLLISION)
                  & ~_has(ents.flags, EntityFlags.AIR)
                  & (ents.movestate == MoveState.ARRIVED))
    c = torch.clamp((ents.pos[:, 0] / NAV_TILE_SIZE).to(torch.int32), 0, w - 1)
    r = torch.clamp((ents.pos[:, 1] / NAV_TILE_SIZE).to(torch.int32), 0, h - 1)
    size = h * w
    flat = torch.where(stationary, r * w + c, size).long()
    counts = torch.zeros(size + 1, dtype=torch.int32, device=flat.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    per_fp = [counts[:-1].reshape(h, w)]
    for _ in range(grows):
        per_fp.append(_grow3(per_fp[-1]))
    fp_stack = torch.stack(per_fp)
    reps = -(-cfg.num_layers // fp_stack.shape[0])
    return fp_stack.repeat(reps, 1, 1)[:cfg.num_layers].contiguous()


def crowd_inputs(cfg: EngineConfig, state: GameState) -> dict:
    """The front half of the movement substep: grid build, 3x3 window,
    flow/LOS sampling and the boids preferred velocity. Returns the
    intermediates the back half uses, with ``hrvo_args``: the exact
    positional arguments of kernel K1 at this substep."""
    ents = state.ents
    n = cfg.max_ents
    dev = ents.pos.device
    movable = _has(ents.flags, EntityFlags.MOVABLE)
    ms = ents.movestate

    # ---- spatial index + 3x3 window (ref: movement.c:2768-2830) --------------
    collidable = ents.alive & _has(ents.flags, EntityFlags.COLLISION)
    slots = torch.arange(n, dtype=torch.int32, device=dev)
    ent_static = ~movable | (ms == MoveState.ARRIVED)
    payload = torch.cat([
        ents.vel,
        ents.radius[:, None],
        ent_static.to(torch.float32)[:, None],
        ents.flock.to(torch.float32)[:, None],
        (ms == MoveState.ARRIVED).to(torch.float32)[:, None],
    ], dim=1)
    sgrid, cgrid = grid.build_grid_pair(
        ents.pos, collidable,
        cells_r=cfg.grid_cells_r, cells_c=cfg.grid_cells_c,
        cap=cfg.spatial_cell_cap, payload=payload,
        fine_r=cfg.contact_cells_r, fine_c=cfg.contact_cells_c,
        fine_cap=cfg.contact_cell_cap, fine_payload=ents.radius[:, None],
        fine_cell_size=CONTACT_CELL_SIZE)
    coh_centroid, coh_cnt = boids.flock_cohesion_centroids(
        ents.pos, ents.flock, collidable,
        cells_r=cfg.grid_cells_r, cells_c=cfg.grid_cells_c,
        cell_size=sgrid.cell_size, max_flocks=cfg.max_flocks)
    keep = boids.formation_keep_force(
        ents.pos, ents.vel, ents.flock, ents.formation_cell,
        ents.has_formation_cell, state.flocks.formation,
        max_flocks=cfg.max_flocks)

    pos, vel, flock, alive = ents.pos, ents.vel, ents.flock, ents.alive
    moving_mask = alive & (
        (ms == MoveState.MOVING) | (ms == MoveState.TURNING)
        | (ms == MoveState.SEEK_ENEMIES) | (ms == MoveState.ARRIVING_TO_CELL)
        | (ms == MoveState.SURROUND_ENTITY)) & movable
    cand, cpos, cpay, cvalid = grid.window_candidates(sgrid, pos, slots,
                                                      window=3)
    rel = cpos - pos[:, None, :]
    neigh_vel = cpay[..., 0:2].contiguous()
    neigh_flock = cpay[..., 4].to(torch.int32)

    # ---- desired velocity (ref: movement.c:4166, nav.c:3468) -------------------
    chasing = alive & (ents.combatstate == CombatState.MOVING_TO_TARGET)
    chase_flat = state.factions.chase_slot.reshape(-1)
    ent_gslot = torch.where(
        chasing,
        chase_flat[(torch.clamp(ents.faction, 0, cfg.max_factions - 1)
                    * cfg.num_layers
                    + torch.clamp(ents.layer, 0, cfg.num_layers - 1)).long()],
        -1)
    flow_dir, has_field = vel_ops.flow_velocity(
        pos, flock, state.flocks.field_slot, state.fields.flow,
        state.flocks.global_slot, state.fields.global_flow, ent_gslot,
        chunks_r=cfg.chunks_r, chunks_c=cfg.chunks_c)
    dest = ents.dest
    to_dest = dest - pos
    dist_dest = torch.sqrt(to_dest[:, 0] * to_dest[:, 0]
                           + to_dest[:, 1] * to_dest[:, 1])
    has_los = vel_ops.dest_los(
        pos, flock, state.flocks.los_slot, state.fields.los,
        chunks_r=cfg.chunks_r, chunks_c=cfg.chunks_c)
    use_arrive = ~has_field | has_los | (
        (dist_dest < 4 * ARRIVE_SLOWING_RADIUS) & ~chasing)

    max_speed_tick = ents.max_speed / float(cfg.move_hz)
    vpref = boids.preferred_velocity(
        pos, vel, flock, dest, flow_dir, use_arrive,
        max_speed_tick, cand, cvalid, moving_mask,
        neigh_pos=cpos, neigh_vel=neigh_vel, neigh_flock=neigh_flock,
        coh_centroid=coh_centroid, coh_cnt=coh_cnt, keep=keep)
    return dict(
        movable=movable, moving_mask=moving_mask, slots=slots, cgrid=cgrid,
        cvalid=cvalid, vpref=vpref, neigh_flock=neigh_flock,
        neigh_arrived=cpay[..., 5] > 0.5,
        neigh_dist=torch.sqrt(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]),
        hrvo_args=(pos, vel, ents.radius, vpref, max_speed_tick,
                   cpos.contiguous(), neigh_vel, cpay[..., 2].contiguous(),
                   cvalid, (cpay[..., 3] > 0.5).contiguous()))


def movement_substep(cfg: EngineConfig, state: GameState,
                     deltas: TickDeltas) -> tuple[GameState, TickDeltas]:
    """One 20 Hz movement substep (see the module docstring). Replaces
    ``state.ents``/``state.nav.blockers`` fields with new tensors and ORs
    this substep's arrivals into ``deltas.arrived``."""
    ents = state.ents
    x = crowd_inputs(cfg, state)
    movable, moving_mask, slots = x["movable"], x["moving_mask"], x["slots"]
    cvalid, vpref = x["cvalid"], x["vpref"]
    pos, alive, flock, radius = ents.pos, ents.alive, ents.flock, ents.radius

    # ---- HRVO solve (ref: clearpath.c:694): kernel K1 ------------------------
    raw = hrvo_select(*x["hrvo_args"], exact=cfg.clearpath_exact)
    new_vel = torch.where(moving_mask[:, None], raw, vpref)

    # ---- group arrival propagation ---------------------------------------------
    garrisoned = _has(ents.flags, EntityFlags.GARRISONED)
    neigh_same_flock = (cvalid & (x["neigh_flock"] == flock[:, None])
                        & (flock[:, None] >= 0))
    flock_arrived = (neigh_same_flock & x["neigh_arrived"]
                     & (x["neigh_dist"] < 10.0)).any(dim=1)

    # ---- de-penetration pushout over the fine contact grid --------------------
    _, kpos, kpay, kvalid = grid.contact_candidates(x["cgrid"], pos, slots)
    krel = kpos - pos[:, None, :]
    kdist = torch.sqrt(krel[..., 0] * krel[..., 0] + krel[..., 1] * krel[..., 1])
    krad = kpay[..., 0]
    depth = (radius[:, None] + krad) * 0.9 - kdist
    over = torch.where(kvalid & (depth > 0.0), depth, 0.0)
    away = (pos[:, None, :] - kpos) / torch.clamp(kdist, min=1e-3)[..., None]
    push = (away * (0.5 * over)[..., None]).sum(1)
    pmag = torch.sqrt(push[:, 0] * push[:, 0] + push[:, 1] * push[:, 1])[:, None]
    push = torch.where(pmag > _DEPEN_CAP,
                       push * (_DEPEN_CAP / torch.clamp(pmag, min=1e-6)), push)
    depen_ok = (alive & movable & ~garrisoned
                & (ents.combatstate != CombatState.CORPSE))
    depen = torch.where(depen_ok[:, None], push, 0.0)

    # ---- contact velocity projection: the 4 deepest overlaps --------------------
    # (stable descending sort: ties go to the lower index, as jax.lax.top_k)
    c_depth = torch.where(kvalid, depth, -float("inf"))
    c_sorted, c_idx = torch.sort(c_depth, dim=1, descending=True, stable=True)
    c_top, c_idx = c_sorted[:, :4], c_idx[:, :4]
    c_n = torch.take_along_dim(away, c_idx[..., None], dim=1)
    for ci in range(4):
        n_i = c_n[:, ci, :]
        vn = (new_vel[:, 0] * n_i[:, 0] + new_vel[:, 1] * n_i[:, 1])[:, None]
        new_vel = torch.where(
            (c_top[:, ci:ci + 1] > 0.0) & (vn < 0.0) & depen_ok[:, None],
            new_vel - vn * n_i, new_vel)

    upd = integ_ops.movement_update(
        alive=alive, moving_mask=moving_mask, pos=pos,
        new_vel=new_vel, dest=ents.dest, movestate=ents.movestate,
        facing=ents.facing, vel_hist=ents.vel_hist,
        vel_hist_idx=ents.vel_hist_idx, wait_ticks=ents.wait_ticks,
        stuck_ticks=ents.stuck_ticks, layer=ents.layer,
        cost_base=state.nav.cost_base, blockers=state.nav.blockers,
        garrisoned=garrisoned, flock_arrived=flock_arrived,
        has_cell=ents.has_formation_cell, depen=depen, slot=slots)
    arrived = upd.pop("arrived")
    ents.prev_pos = ents.pos
    for name, value in upd.items():
        setattr(ents, name, value)
    state.nav.blockers = _restamp_blockers(cfg, ents)
    deltas.arrived = deltas.arrived | arrived
    return state, deltas


def combat_substep(cfg: EngineConfig, state: GameState, deltas: TickDeltas):
    """The 10 Hz combat substep; ranged attackers loose a projectile at
    their target's current position."""
    state, deltas, attack_now = combat_ops.combat_substep(cfg, state, deltas)
    ents = state.ents
    ti = torch.clamp(ents.target, 0, cfg.max_ents - 1).long()
    proj_ops.spawn_projectiles(
        cfg, state.projectiles, attack_now & ents.is_ranged, ents.pos,
        ents.pos[ti], ents.faction, ents.base_dmg)
    return state, deltas


def fog_substep(cfg: EngineConfig, state: GameState, tile_height=None):
    """Recompute every faction's fog plane (``tile_height`` f32[TH, TW]
    selects the height-aware shadowcaster)."""
    ents = state.ents
    state.fog.state = fog_ops.update_fog(
        state.fog.state, state.fog.enabled, ents.pos,
        ents.alive & (ents.hp > 0.0), ents.faction, ents.vision_range,
        tile_height, tiles_h=cfg.tiles_h, tiles_w=cfg.tiles_w,
        max_factions=cfg.max_factions)
    return state


def make_tick(cfg: EngineConfig, tile_height=None, skin_bank=None):
    """The 60 Hz tick ``(state, acc) -> (state, acc)``: advances the host
    frame counter (and ``state.anim.tick``, its device copy, when the state
    skins) and runs, in the JAX tick's order, movement every ``FRAME_HZ //
    cfg.move_hz`` frames, combat every ``FRAME_HZ // cfg.combat_hz``,
    projectiles every 2 (30 Hz), corpses every 60 (1 Hz), fog every
    ``FRAME_HZ // cfg.fog_hz`` and, with `skin_bank` (an
    ``ops/skin.SkinBank``; needs ``cfg.skin_joints > 0``), skinning every
    ``FRAME_HZ // cfg.skin_hz``. Substeps fold their events into the
    accumulator `acc` in place (merging a frame's empty deltas is the
    identity, so a frame without a substep touches nothing).
    `tile_height` (f32[TH, TW] on the state's device, or None) makes fog
    height-aware."""
    move_period = FRAME_HZ // cfg.move_hz
    combat_period = FRAME_HZ // cfg.combat_hz
    proj_period = FRAME_HZ // 30
    corpse_period = FRAME_HZ
    fog_period = max(FRAME_HZ // cfg.fog_hz, 1)
    skin_period = max(FRAME_HZ // cfg.skin_hz, 1)
    skins = skin_bank is not None and cfg.skin_joints > 0

    def tick(state: GameState, acc: TickDeltas):
        state.tick += 1
        t = state.tick
        if state.anim is not None:
            state.anim.tick += 1
        if t % move_period == 0:
            state, acc = movement_substep(cfg, state, acc)
        if t % combat_period == 0:
            state, acc = combat_substep(cfg, state, acc)
        if t % proj_period == 0:
            state, acc = proj_ops.projectile_substep(cfg, state, acc)
        if t % corpse_period == 0:
            state, acc, expired = combat_ops.corpse_substep(cfg, state, acc)
            acc.corpse_expired = acc.corpse_expired | expired
        if t % fog_period == 0:
            state = fog_substep(cfg, state, tile_height)
        if skins and t % skin_period == 0:
            state = skin_ops.skin_substep(cfg, skin_bank, state)
        return state, acc

    return tick
