"""Combat FSM, target acquisition and melee damage as masked dense updates.

Port of ``permafrost_engine_tpu/ops/combat.py`` (ref: src/game/combat.c:
142-175 state machine, 2218-2242 tick, 778 melee damage, 2244-2263 corpse
countdown):

  NOT_IN_COMBAT -> (enemy in vision, AGGRESSIVE) -> MOVING_TO_TARGET
  MOVING_TO_TARGET -> (in attack range) -> CAN_ATTACK
  CAN_ATTACK -> cooldown elapses -> attack (melee damage here, ranged
  attackers loose a projectile in ``game/step.combat_substep``)
  hp <= 0 -> CORPSE (1 Hz countdown) -> slot freed

Melee damage is one scatter-add keyed by target slot (a spare row takes
the JAX ``mode="drop"`` writes), so simultaneous attacks commute. Both
substeps replace ``state.ents`` fields with new tensors.
"""

from __future__ import annotations

import torch

from permafrost_engine_tpu_torch.core.config import (
    CombatStance,
    CombatState,
    DiplomacyState,
    EngineConfig,
    EntityFlags,
    MoveState,
)
from permafrost_engine_tpu_torch.ops import grid as grid_ops
from permafrost_engine_tpu_torch.ops.rounding import sqrt


def combat_substep(cfg: EngineConfig, state, deltas):
    """One 10 Hz combat substep. Returns (state, deltas, attack_now bool[N])
    with this substep's deaths, attack starts and chase motion starts ORed
    into `deltas`."""
    ents = state.ents
    n = cfg.max_ents
    dev = ents.pos.device

    combatable = (ents.flags & int(EntityFlags.COMBATABLE)) != 0
    dead = ents.hp <= 0.0
    fighter = ents.alive & combatable & ~dead
    targetable = fighter

    war = state.factions.diplomacy == DiplomacyState.WAR

    # ---- validate the current target ----------------------------------------
    t = ents.target
    t_ok = (t >= 0) & targetable[torch.clamp(t, 0, n - 1).long()]
    t = torch.where(t_ok, t, -1)

    # ---- acquire: nearest enemy in vision -------------------------------------
    near_i, near_d = grid_ops.nearest_match(
        ents.pos, fighter, ents.pos, targetable,
        (ents.faction, war, ents.faction), block=min(1024, n))
    in_vision = near_d <= ents.vision_range
    may_engage = fighter & (ents.stance != CombatStance.NO_ENGAGEMENT)
    acquire = may_engage & (t < 0) & (near_i >= 0) & in_vision
    t = torch.where(acquire, near_i, t)

    # ---- range test ---------------------------------------------------------------
    ti = torch.clamp(t, 0, n - 1).long()
    tpos = ents.pos[ti]
    d = tpos - ents.pos
    tdist = sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    reach = ents.attack_range + ents.sel_radius[ti]
    in_range = (t >= 0) & (tdist <= reach)

    # HOLD_POSITION units never chase; neither can immobile entities
    movable = (ents.flags & int(EntityFlags.MOVABLE)) != 0
    chase = (t >= 0) & ~in_range & (
        ents.stance == CombatStance.AGGRESSIVE) & movable

    # ---- FSM ----------------------------------------------------------------------
    cs = ents.combatstate
    new_cs = torch.where(fighter & (t < 0), int(CombatState.NOT_IN_COMBAT), cs)
    new_cs = torch.where(fighter & chase, int(CombatState.MOVING_TO_TARGET),
                         new_cs)
    new_cs = torch.where(fighter & in_range, int(CombatState.CAN_ATTACK), new_cs)
    drop = (fighter & (t >= 0) & ~in_range
            & (ents.stance == CombatStance.HOLD_POSITION))
    t = torch.where(drop, -1, t)
    new_cs = torch.where(drop, int(CombatState.NOT_IN_COMBAT), new_cs)

    # ---- attacks --------------------------------------------------------------------
    cooldown = torch.clamp(ents.attack_cooldown - 1, min=0)
    can_attack = fighter & in_range & (new_cs == CombatState.CAN_ATTACK)
    attack_now = can_attack & (cooldown == 0)
    cooldown = torch.where(attack_now, ents.attack_period, cooldown)

    melee_now = attack_now & ~ents.is_ranged
    dmg_out = torch.where(melee_now,
                          ents.base_dmg * (1.0 - ents.armour_pc[ti]), 0.0)
    dmg_in = torch.zeros(n + 1, dtype=torch.float32, device=dev)
    dmg_in.index_add_(0, torch.where(melee_now, ti, n), dmg_out)
    new_hp = torch.where(ents.alive, ents.hp - dmg_in[:n], ents.hp)

    # ---- deaths, keyed on combatstate (a projectile kill lands between combat
    # substeps, so the pre-substep hp would leave it alive forever) -----------
    died_now = ents.alive & (cs != CombatState.CORPSE) & (new_hp <= 0.0)
    new_cs = torch.where(died_now, int(CombatState.CORPSE), new_cs)
    corpse_ticks = torch.where(died_now, 3, ents.corpse_ticks)  # ~3 s at 1 Hz
    t = torch.where(died_now, -1, t)

    # dead entities stop; chasers steer at their target (flock -1)
    chasing = chase & fighter
    starts = chasing & (ents.movestate == MoveState.ARRIVED)
    new_ms = torch.where(died_now, int(MoveState.ARRIVED), ents.movestate)
    new_ms = torch.where(starts, int(MoveState.MOVING), new_ms)
    stop_to_fight = fighter & in_range & (cs == CombatState.MOVING_TO_TARGET)
    new_ms = torch.where(stop_to_fight, int(MoveState.ARRIVED), new_ms)

    ents.target = t.to(torch.int32)
    ents.combatstate = new_cs.to(torch.int32)
    ents.attack_cooldown = cooldown.to(torch.int32)
    ents.hp = new_hp
    ents.corpse_ticks = corpse_ticks.to(torch.int32)
    ents.movestate = new_ms.to(torch.int32)
    ents.dest = torch.where(chasing[:, None], tpos, ents.dest)
    ents.flock = torch.where(chasing, -1, ents.flock)
    ents.vel = torch.where((died_now | stop_to_fight)[:, None], 0.0, ents.vel)
    deltas.died = deltas.died | died_now
    deltas.attack_started = deltas.attack_started | attack_now
    deltas.motion_start = deltas.motion_start | starts
    return state, deltas, attack_now


def corpse_substep(cfg: EngineConfig, state, deltas):
    """1 Hz corpse countdown and removal. Returns (state, deltas, expired
    bool[N]): the corpses whose slots were freed this substep."""
    ents = state.ents
    corpse = ents.alive & (ents.combatstate == CombatState.CORPSE)
    ticks = torch.where(corpse, torch.clamp(ents.corpse_ticks - 1, min=0),
                        ents.corpse_ticks)
    expired = corpse & (ticks == 0)
    ents.corpse_ticks = ticks
    ents.alive = ents.alive & ~expired
    return state, deltas, expired
