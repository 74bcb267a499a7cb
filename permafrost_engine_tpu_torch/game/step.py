"""The simulation tick: the 60 Hz frame counter and its substeps.

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

``make_tick_scan`` runs n frames as one segment: one CUDA graph replay on
the card (``game/graphs.py``), n ticks in turn on the CPU. No substep
synchronizes with the host or copies host data to the device, so every
frame can be captured.

On a mesh (``parallel/step.py``) the tick takes a ``RowPartition``: the
movement substep's query side runs on the rank's entity rows, the blocker
restamp and the flat-map fog on its row bands, and the rank gathers the
results whole; the ops on each row are the single-device tick's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from permafrost_engine_tpu_torch.core.config import (
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
from permafrost_engine_tpu_torch.ops import boids, grid
from permafrost_engine_tpu_torch.ops import combat as combat_ops
from permafrost_engine_tpu_torch.ops import fog as fog_ops
from permafrost_engine_tpu_torch.ops import integrate as integ_ops
from permafrost_engine_tpu_torch.ops import projectile as proj_ops
from permafrost_engine_tpu_torch.ops import velocity as vel_ops
from permafrost_engine_tpu_torch.game.graphs import TickGraphs
from permafrost_engine_tpu_torch.ops import skin as skin_ops
from permafrost_engine_tpu_torch.ops.crowd_cuda import hrvo_select
from permafrost_engine_tpu_torch.state.schema import (
    GameState,
    TickDeltas,
    empty_deltas,
)

_DEPEN_CAP = 0.25     # world units per move tick


def _has(flags: torch.Tensor, bit: EntityFlags) -> torch.Tensor:
    return (flags & int(bit)) != 0


def _grow3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max dilation of a non-negative [H, W] grid (zero outside), as
    two 3-wide separable passes (the JAX reduce_window max)."""
    return fog_ops.max3_cols(fog_ops.max3_rows(x))


def _restamp_blockers(cfg: EngineConfig, ents, nav, part=None):
    """Dense blocker rebuild: stationary collidable ground entities stamp
    their nav tile; footprint layers see the stamp dilated 1 -> 3 -> 5 -> 7
    (ref: N_BlockersIncref nav.c:4663). Returns the new blockers grid
    i32[L, H, W]. With a `part` whose ``field_rows`` is a band [r0, r1),
    this rank counts and dilates its band alone (from the rows within the
    dilation's reach, zero beyond the map as in the whole grid) and the
    footprint planes' bands are gathered: the counts are integers, so the
    grid is exact."""
    h, w = cfg.field_h, cfg.field_w
    grows = min(NUM_FOOTPRINTS, cfg.num_layers) - 1
    r0, r1 = (0, h) if part is None or part.field_rows is None \
        else part.field_rows
    e0, e1 = max(r0 - grows, 0), min(r1 + grows, h)
    stationary = (ents.alive & _has(ents.flags, EntityFlags.COLLISION)
                  & ~_has(ents.flags, EntityFlags.AIR)
                  & (ents.movestate == MoveState.ARRIVED))
    c = torch.clamp((ents.pos[:, 0] / NAV_TILE_SIZE).to(torch.int32), 0, w - 1)
    r = torch.clamp((ents.pos[:, 1] / NAV_TILE_SIZE).to(torch.int32), 0, h - 1)
    size = (e1 - e0) * w
    flat = torch.where(stationary & (r >= e0) & (r < e1), (r - e0) * w + c,
                       size).long()
    counts = torch.zeros(size + 1, dtype=torch.int32, device=flat.device)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    per_fp = [counts[:-1].reshape(e1 - e0, w)]
    for _ in range(grows):
        per_fp.append(_grow3(per_fp[-1]))
    fp_stack = torch.stack(per_fp)[:, r0 - e0:r1 - e0]
    if (r0, r1) != (0, h):
        fp_stack = part.gather([fp_stack], 1)[0]
    reps = -(-cfg.num_layers // fp_stack.shape[0])
    return fp_stack.repeat(reps, 1, 1)[:cfg.num_layers].contiguous()


def crowd_inputs(cfg: EngineConfig, state: GameState,
                 rows: tuple[int, int] | None = None) -> dict:
    """The front half of the movement substep: grid build, 3x3 window,
    flow/LOS sampling and the boids preferred velocity. Returns the
    intermediates the back half uses, with ``hrvo_args``: the exact
    positional arguments of kernel K1 at this substep.

    The grids, the cohesion sums and the formation sums are built from
    the whole arena; the per-entity (query) part runs on the entity rows
    ``rows = (lo, hi)`` alone (all rows by default), so every returned
    per-entity tensor has ``hi - lo`` rows and equals those rows of the
    whole computation."""
    ents = state.ents
    n = cfg.max_ents
    lo, hi = (0, n) if rows is None else rows
    q = slice(lo, hi)
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
        max_flocks=cfg.max_flocks, rows=q)

    # ---- the query rows ----------------------------------------------------------
    pos, vel, flock, alive = ents.pos[q], ents.vel[q], ents.flock[q], ents.alive[q]
    ms, movable, slots = ms[q], movable[q], slots[q]
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
    chasing = alive & (ents.combatstate[q] == CombatState.MOVING_TO_TARGET)
    chase_flat = state.factions.chase_slot.reshape(-1)
    ent_gslot = torch.where(
        chasing,
        chase_flat[(torch.clamp(ents.faction[q], 0, cfg.max_factions - 1)
                    * cfg.num_layers
                    + torch.clamp(ents.layer[q], 0, cfg.num_layers - 1)).long()],
        -1)
    flow_dir, has_field = vel_ops.flow_velocity(
        pos, flock, state.flocks.field_slot, state.fields.flow,
        state.flocks.global_slot, state.fields.global_flow, ent_gslot,
        chunks_r=cfg.chunks_r, chunks_c=cfg.chunks_c)
    dest = ents.dest[q]
    to_dest = dest - pos
    dist_dest = torch.sqrt(to_dest[:, 0] * to_dest[:, 0]
                           + to_dest[:, 1] * to_dest[:, 1])
    has_los = vel_ops.dest_los(
        pos, flock, state.flocks.los_slot, state.fields.los,
        chunks_r=cfg.chunks_r, chunks_c=cfg.chunks_c)
    use_arrive = ~has_field | has_los | (
        (dist_dest < 4 * ARRIVE_SLOWING_RADIUS) & ~chasing)

    max_speed_tick = ents.max_speed[q] / float(cfg.move_hz)
    vpref = boids.preferred_velocity(
        pos, vel, flock, dest, flow_dir, use_arrive,
        max_speed_tick, cand, cvalid, moving_mask,
        neigh_pos=cpos, neigh_vel=neigh_vel, neigh_flock=neigh_flock,
        coh_centroid=coh_centroid[q], coh_cnt=coh_cnt[q], keep=keep)
    return dict(
        movable=movable, moving_mask=moving_mask, slots=slots, cgrid=cgrid,
        cvalid=cvalid, vpref=vpref, neigh_flock=neigh_flock,
        neigh_arrived=cpay[..., 5] > 0.5,
        neigh_dist=torch.sqrt(rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]),
        hrvo_args=(pos, vel, ents.radius[q], vpref, max_speed_tick,
                   cpos.contiguous(), neigh_vel, cpay[..., 2].contiguous(),
                   cvalid, (cpay[..., 3] > 0.5).contiguous()))


def movement_substep(cfg: EngineConfig, state: GameState,
                     deltas: TickDeltas, part=None
                     ) -> tuple[GameState, TickDeltas]:
    """One 20 Hz movement substep (see the module docstring). Replaces
    ``state.ents``/``state.nav.blockers`` fields with new tensors and ORs
    this substep's arrivals into ``deltas.arrived``.

    With a ``RowPartition`` `part`, the query side (window, preferred
    velocity, K1, arrival propagation, contact projection, integration)
    runs on the rank's entity rows ``part.ents`` alone; the changed
    columns are then gathered whole, and the blocker restamp reads them."""
    ents = state.ents
    lo, hi = (0, cfg.max_ents) if part is None else part.ents
    q = slice(lo, hi)
    x = crowd_inputs(cfg, state, (lo, hi))
    movable, moving_mask, slots = x["movable"], x["moving_mask"], x["slots"]
    cvalid, vpref = x["cvalid"], x["vpref"]
    pos, alive, flock, radius = (ents.pos[q], ents.alive[q], ents.flock[q],
                                 ents.radius[q])

    # ---- HRVO solve (ref: clearpath.c:694): kernel K1 ------------------------
    raw = hrvo_select(*x["hrvo_args"], exact=cfg.clearpath_exact)
    new_vel = torch.where(moving_mask[:, None], raw, vpref)

    # ---- group arrival propagation ---------------------------------------------
    garrisoned = _has(ents.flags[q], EntityFlags.GARRISONED)
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
                & (ents.combatstate[q] != CombatState.CORPSE))
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
        new_vel=new_vel, dest=ents.dest[q], movestate=ents.movestate[q],
        facing=ents.facing[q], vel_hist=ents.vel_hist[q],
        vel_hist_idx=ents.vel_hist_idx[q], wait_ticks=ents.wait_ticks[q],
        stuck_ticks=ents.stuck_ticks[q], layer=ents.layer[q],
        cost_base=state.nav.cost_base, blockers=state.nav.blockers,
        garrisoned=garrisoned, flock_arrived=flock_arrived,
        has_cell=ents.has_formation_cell[q], depen=depen, slot=slots)
    if part is not None:
        names = list(upd)
        upd = dict(zip(names, part.gather([upd[k] for k in names], 0)))
    arrived = upd.pop("arrived")
    ents.prev_pos = ents.pos
    for name, value in upd.items():
        setattr(ents, name, value)
    state.nav.blockers = _restamp_blockers(cfg, ents, state.nav, part)
    deltas.arrived = deltas.arrived | arrived
    return state, deltas


def merge_deltas(a: TickDeltas, b: TickDeltas) -> TickDeltas:
    """Fold two tick deltas, `b` the newer: event masks OR; the projectile
    hit record merges as one unit keyed on the newer hit."""
    hit_b = b.proj_hit >= 0
    return TickDeltas(
        arrived=a.arrived | b.arrived,
        motion_start=a.motion_start | b.motion_start,
        died=a.died | b.died,
        attack_started=a.attack_started | b.attack_started,
        proj_hit=torch.where(hit_b, b.proj_hit, a.proj_hit),
        proj_hit_shooter=torch.where(hit_b, b.proj_hit_shooter,
                                     a.proj_hit_shooter),
        proj_hit_cookie=torch.where(hit_b, b.proj_hit_cookie,
                                    a.proj_hit_cookie),
        corpse_expired=a.corpse_expired | b.corpse_expired,
    )


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


def fog_substep(cfg: EngineConfig, state: GameState, tile_height=None,
                part=None):
    """Recompute every faction's fog plane (``tile_height`` f32[TH, TW]
    selects the height-aware shadowcaster). With a `part` whose
    ``fog_rows`` is a band and no ``tile_height``, this rank computes its
    band of tile rows from the whole entity columns and the bands are
    gathered; the shadowcaster's viewer cap is global, so with heights
    every rank computes the whole planes."""
    ents = state.ents
    rows = None
    if part is not None and tile_height is None:
        rows = part.fog_rows
    new = fog_ops.update_fog(
        state.fog.state, state.fog.enabled, ents.pos,
        ents.alive & (ents.hp > 0.0), ents.faction, ents.vision_range,
        tile_height, tiles_h=cfg.tiles_h, tiles_w=cfg.tiles_w,
        max_factions=cfg.max_factions, rows=rows)
    state.fog.state = new if rows is None else part.gather([new], 1)[0]
    return state


def _substep_periods(cfg: EngineConfig) -> tuple[int, ...]:
    """Frames between two firings of each substep gate: movement, combat,
    projectiles (30 Hz), corpses (1 Hz), fog and skinning."""
    return (FRAME_HZ // cfg.move_hz, FRAME_HZ // cfg.combat_hz,
            FRAME_HZ // 30, FRAME_HZ, max(FRAME_HZ // cfg.fog_hz, 1),
            max(FRAME_HZ // cfg.skin_hz, 1))


def cadence_period(cfg: EngineConfig) -> int:
    """Frames after which every substep gate repeats: the lcm of the
    substep periods (60 at the defaults). A segment's substeps depend only
    on its length and its first frame modulo this."""
    periods = _substep_periods(cfg)
    return math.lcm(*(periods if cfg.skin_joints > 0 else periods[:5]))


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """One rank's share of the tick on a mesh (``parallel/step.py`` builds
    it): the entity rows ``ents = (lo, hi)`` whose query side the rank
    computes, the row bands of the nav grids (``field_rows``) and of the
    fog planes (``fog_rows``) it computes when the map is row-sharded
    (None: the whole grid on every rank), and ``gather(bands, dim)``,
    which concatenates every rank's band of each tensor along `dim`, in
    rank order, and returns the whole tensors."""

    ents: tuple[int, int]
    gather: Callable[[list, int], list]
    field_rows: tuple[int, int] | None = None
    fog_rows: tuple[int, int] | None = None


def make_tick(cfg: EngineConfig, tile_height=None, skin_bank=None,
              part: RowPartition | None = None):
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
    height-aware. With `part` (a ``RowPartition``) the movement, blocker
    and fog work is divided over a mesh's ranks; every other substep runs
    whole on every rank. The tick's ``gates(t)`` gives the substeps it
    fires at frame `t`."""
    periods = _substep_periods(cfg)
    skins = skin_bank is not None and cfg.skin_joints > 0

    def gates(t: int) -> tuple[bool, ...]:
        """Which substeps the tick fires at host frame `t` (the frame
        after its increment): movement, combat, projectiles, corpses, fog,
        skinning. The tick reads the host frame nowhere else."""
        fires = tuple(t % p == 0 for p in periods)
        return fires if skins else fires[:5] + (False,)

    def tick(state: GameState, acc: TickDeltas):
        state.tick += 1
        if state.anim is not None:
            state.anim.tick += 1
        move, combat, proj, corpse, fog, skin = gates(state.tick)
        if move:
            state, acc = movement_substep(cfg, state, acc, part)
        if combat:
            state, acc = combat_substep(cfg, state, acc)
        if proj:
            state, acc = proj_ops.projectile_substep(cfg, state, acc)
        if corpse:
            state, acc, expired = combat_ops.corpse_substep(cfg, state, acc)
            acc.corpse_expired = acc.corpse_expired | expired
        if fog:
            state = fog_substep(cfg, state, tile_height, part)
        if skin:
            state = skin_ops.skin_substep(cfg, skin_bank, state)
        return state, acc

    tick.gates = gates
    return tick


def make_tick_scan(cfg: EngineConfig, tile_height=None,
                   skin_bank=None) -> TickGraphs:
    """Batched frame stepper ``(state, n, acc=None) -> (state, deltas)``:
    n frames of ``make_tick``'s tick as ONE segment, returning the state
    and the deltas merged across the window (folded into `acc` in place
    when given, else into a fresh accumulator). On CUDA state a segment is
    one CUDA graph replay, captured on first use of the substeps its n
    frames fire (the tick's ``gates``); on the CPU its ticks run in turn
    (see ``game/graphs.py``)."""
    return TickGraphs(make_tick(cfg, tile_height, skin_bank=skin_bank),
                      cadence_period(cfg),
                      lambda device: empty_deltas(cfg, device=device))
