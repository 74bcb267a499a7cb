"""SoA game-state schema: fixed-capacity tensors on one device.

Port of ``permafrost_engine_tpu/state/schema.py``. The JAX package keeps the
whole simulation as one immutable pytree of ``flax.struct`` dataclasses;
here the same fields are plain (mutable) dataclasses of tensors on an
explicit device. Field names, shapes and dtypes match the JAX state leaf for
leaf, with two deliberate differences:

* ``EntityArena.flags`` is int32 holding the JAX u32 bit pattern: torch's
  uint32 has no comparisons or ``index_add_`` on CPU. Every
  ``EntityFlags`` bit is below bit 20, so the sign bit is never set.
* ``GameState.tick`` is a host ``int``: the 60 Hz counter and the cadence
  gates live on the host, so no stage syncs the device to branch.

``GameState.rng`` keeps the JAX PRNG key words (``[0, seed]``) as int64 so
the state round-trips; no stage of the ported slice draws random numbers.

``AnimArena`` is not ported: ``cfg.skin_joints > 0`` raises
``NotImplementedError``. ``FogState`` and ``ProjectileArena`` are allocated
but no ported stage steps them yet.
"""

from __future__ import annotations

import dataclasses

import torch

from permafrost_engine_tpu_torch.core.config import (
    EngineConfig,
    FIELD_RES,
    VEL_HIST_LEN,
)


@dataclasses.dataclass(eq=False)
class EntityArena:
    """SoA entity arrays, capacity ``cfg.max_ents`` (see the JAX schema)."""

    alive: torch.Tensor          # bool[N]
    uid: torch.Tensor            # i32[N]
    flags: torch.Tensor          # i32[N] EntityFlags bits (u32 in JAX)
    faction: torch.Tensor        # i32[N]
    layer: torch.Tensor          # i32[N]
    pos: torch.Tensor            # f32[N,2]
    height: torch.Tensor         # f32[N]
    prev_pos: torch.Tensor       # f32[N,2]
    facing: torch.Tensor         # f32[N]
    radius: torch.Tensor         # f32[N]
    sel_radius: torch.Tensor     # f32[N]
    movestate: torch.Tensor      # i32[N]
    vel: torch.Tensor            # f32[N,2]
    max_speed: torch.Tensor      # f32[N]
    dest: torch.Tensor           # f32[N,2]
    flock: torch.Tensor          # i32[N]
    vel_hist: torch.Tensor       # f32[N,H,2]
    vel_hist_idx: torch.Tensor   # i32[N]
    wait_ticks: torch.Tensor     # i32[N]
    stuck_ticks: torch.Tensor    # i32[N]
    formation_cell: torch.Tensor  # f32[N,2]
    has_formation_cell: torch.Tensor  # bool[N]
    hp: torch.Tensor             # f32[N]
    max_hp: torch.Tensor         # f32[N]
    combatstate: torch.Tensor    # i32[N]
    stance: torch.Tensor         # i32[N]
    target: torch.Tensor         # i32[N]
    attack_range: torch.Tensor   # f32[N]
    base_dmg: torch.Tensor       # f32[N]
    armour_pc: torch.Tensor      # f32[N]
    attack_cooldown: torch.Tensor  # i32[N]
    attack_period: torch.Tensor  # i32[N]
    is_ranged: torch.Tensor      # bool[N]
    corpse_ticks: torch.Tensor   # i32[N]
    vision_range: torch.Tensor   # f32[N]


@dataclasses.dataclass(eq=False)
class FlockTable:
    active: torch.Tensor         # bool[F]
    dest: torch.Tensor           # f32[F,2]
    layer: torch.Tensor          # i32[F]
    target_ent: torch.Tensor     # i32[F]
    field_slot: torch.Tensor     # i32[F, num_chunks]
    los_slot: torch.Tensor       # i32[F, num_chunks]
    global_slot: torch.Tensor    # i32[F]
    formation: torch.Tensor      # i32[F]


@dataclasses.dataclass(eq=False)
class FieldSlab:
    flow: torch.Tensor           # u8[S, FIELD_RES, FIELD_RES] FlowDir codes
    los: torch.Tensor            # u8[S2, FIELD_RES, FIELD_RES]
    global_flow: torch.Tensor    # u8[G, H, W]


@dataclasses.dataclass(eq=False)
class NavState:
    cost_base: torch.Tensor      # u8[L, H, W]
    blockers: torch.Tensor       # i32[L, H, W]
    islands: torch.Tensor        # i32[L, H, W]


@dataclasses.dataclass(eq=False)
class FogState:
    state: torch.Tensor          # u8[F, TH, TW]
    enabled: torch.Tensor        # bool[]


@dataclasses.dataclass(eq=False)
class ProjectileArena:
    active: torch.Tensor         # bool[P]
    pos: torch.Tensor            # f32[P,3]
    vel: torch.Tensor            # f32[P,3]
    faction: torch.Tensor        # i32[P]
    parent: torch.Tensor         # i32[P]
    cookie: torch.Tensor         # f32[P]


@dataclasses.dataclass(eq=False)
class FactionTable:
    active: torch.Tensor         # bool[F]
    controllable: torch.Tensor   # bool[F]
    diplomacy: torch.Tensor      # i32[F,F]
    chase_slot: torch.Tensor     # i32[F, L]


@dataclasses.dataclass(eq=False)
class GameState:
    tick: int                    # host 60 Hz frame counter
    ents: EntityArena
    flocks: FlockTable
    fields: FieldSlab
    nav: NavState
    fog: FogState
    projectiles: ProjectileArena
    factions: FactionTable
    rng: torch.Tensor            # i64[2] JAX PRNG key words (unused)


@dataclasses.dataclass(eq=False)
class TickDeltas:
    arrived: torch.Tensor        # bool[N]
    motion_start: torch.Tensor   # bool[N]
    died: torch.Tensor           # bool[N]
    attack_started: torch.Tensor  # bool[N]
    proj_hit: torch.Tensor       # i32[P]
    proj_hit_shooter: torch.Tensor  # i32[P]
    proj_hit_cookie: torch.Tensor   # f32[P]
    corpse_expired: torch.Tensor  # bool[N]


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------


def init_arena(cfg: EngineConfig, device) -> EntityArena:
    n = cfg.max_ents
    i32, f32, b = torch.int32, torch.float32, torch.bool

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    return EntityArena(
        alive=z(n, b), uid=z(n, i32), flags=z(n, i32), faction=z(n, i32),
        layer=z(n, i32), pos=z((n, 2), f32), height=z(n, f32),
        prev_pos=z((n, 2), f32), facing=z(n, f32), radius=full((n,), 1.0, f32),
        sel_radius=full((n,), 1.0, f32), movestate=z(n, i32),
        vel=z((n, 2), f32), max_speed=full((n,), 10.0, f32),
        dest=z((n, 2), f32), flock=full((n,), -1, i32),
        vel_hist=z((n, VEL_HIST_LEN, 2), f32), vel_hist_idx=z(n, i32),
        wait_ticks=z(n, i32), stuck_ticks=z(n, i32),
        formation_cell=z((n, 2), f32), has_formation_cell=z(n, b),
        hp=full((n,), 100.0, f32), max_hp=full((n,), 100.0, f32),
        combatstate=z(n, i32), stance=z(n, i32), target=full((n,), -1, i32),
        attack_range=full((n,), 10.0, f32), base_dmg=full((n,), 10.0, f32),
        armour_pc=z(n, f32), attack_cooldown=z(n, i32),
        attack_period=full((n,), 10, i32), is_ranged=z(n, b),
        corpse_ticks=z(n, i32), vision_range=full((n,), 60.0, f32),
    )


def init_flocks(cfg: EngineConfig, device) -> FlockTable:
    f, nc = cfg.max_flocks, cfg.num_chunks
    i32 = torch.int32
    return FlockTable(
        active=torch.zeros(f, dtype=torch.bool, device=device),
        dest=torch.zeros((f, 2), dtype=torch.float32, device=device),
        layer=torch.zeros(f, dtype=i32, device=device),
        target_ent=torch.full((f,), -1, dtype=i32, device=device),
        field_slot=torch.full((f, nc), -1, dtype=i32, device=device),
        los_slot=torch.full((f, nc), -1, dtype=i32, device=device),
        global_slot=torch.full((f,), -1, dtype=i32, device=device),
        formation=torch.zeros(f, dtype=i32, device=device),
    )


def init_fields(cfg: EngineConfig, device) -> FieldSlab:
    u8 = torch.uint8
    return FieldSlab(
        flow=torch.zeros((cfg.field_slab_slots, FIELD_RES, FIELD_RES),
                         dtype=u8, device=device),
        los=torch.zeros((cfg.los_slab_slots, FIELD_RES, FIELD_RES),
                        dtype=u8, device=device),
        global_flow=torch.zeros(
            (cfg.global_field_slots, cfg.field_h, cfg.field_w),
            dtype=u8, device=device),
    )


def init_nav(cfg: EngineConfig, device, passable_cost: int = 1) -> NavState:
    shape = (cfg.num_layers, cfg.field_h, cfg.field_w)
    return NavState(
        cost_base=torch.full(shape, passable_cost, dtype=torch.uint8,
                             device=device),
        blockers=torch.zeros(shape, dtype=torch.int32, device=device),
        islands=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def init_fog(cfg: EngineConfig, device) -> FogState:
    return FogState(
        state=torch.zeros((cfg.max_factions, cfg.tiles_h, cfg.tiles_w),
                          dtype=torch.uint8, device=device),
        enabled=torch.tensor(True, device=device),
    )


def init_projectiles(cfg: EngineConfig, device) -> ProjectileArena:
    p = cfg.max_projectiles
    return ProjectileArena(
        active=torch.zeros(p, dtype=torch.bool, device=device),
        pos=torch.zeros((p, 3), dtype=torch.float32, device=device),
        vel=torch.zeros((p, 3), dtype=torch.float32, device=device),
        faction=torch.zeros(p, dtype=torch.int32, device=device),
        parent=torch.full((p,), -1, dtype=torch.int32, device=device),
        cookie=torch.zeros(p, dtype=torch.float32, device=device),
    )


def init_factions(cfg: EngineConfig, device) -> FactionTable:
    f = cfg.max_factions
    return FactionTable(
        active=torch.zeros(f, dtype=torch.bool, device=device),
        controllable=torch.zeros(f, dtype=torch.bool, device=device),
        diplomacy=torch.zeros((f, f), dtype=torch.int32, device=device),
        chase_slot=torch.full((f, cfg.num_layers), -1, dtype=torch.int32,
                              device=device),
    )


def init_state(cfg: EngineConfig, seed: int = 0, *, device) -> GameState:
    if cfg.skin_joints > 0:
        raise NotImplementedError(
            "device skinning (cfg.skin_joints > 0) is not ported")
    return GameState(
        tick=0,
        ents=init_arena(cfg, device),
        flocks=init_flocks(cfg, device),
        fields=init_fields(cfg, device),
        nav=init_nav(cfg, device),
        fog=init_fog(cfg, device),
        projectiles=init_projectiles(cfg, device),
        factions=init_factions(cfg, device),
        rng=torch.tensor([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                         dtype=torch.int64, device=device),
    )


def empty_deltas(cfg: EngineConfig, *, device) -> TickDeltas:
    n, p = cfg.max_ents, cfg.max_projectiles
    b = torch.bool
    return TickDeltas(
        arrived=torch.zeros(n, dtype=b, device=device),
        motion_start=torch.zeros(n, dtype=b, device=device),
        died=torch.zeros(n, dtype=b, device=device),
        attack_started=torch.zeros(n, dtype=b, device=device),
        proj_hit=torch.full((p,), -1, dtype=torch.int32, device=device),
        proj_hit_shooter=torch.full((p,), -1, dtype=torch.int32,
                                    device=device),
        proj_hit_cookie=torch.zeros(p, dtype=torch.float32, device=device),
        corpse_expired=torch.zeros(n, dtype=b, device=device),
    )
