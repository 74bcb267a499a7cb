"""PyTorch port vs the JAX package: seek-enemies and surround orders.

Both ``Engine``s (the port on the CPU) play the same scenes:

* ``tests/test_combat.py:135``'s hunt: a hunter follows a whole-map
  enemy-seek field to its prey and kills it;
* ``tests/test_combat.py:191``'s change-driven rebuilds: the seek field is
  rebuilt only when an enemy's chunk signature changes (a move, a death)
  or a structure commit changes the costs, one cadence late;
* ``tests/test_economy.py:207``'s surround: a pack converges on one unit;
* a global slab too small for every field: a surround order evicts the
  oldest seek flock, which loses its slot and its refreshes.

Checks (tolerance: none unless stated): bit-equal ``global_flow`` rows and
``global_slot`` tables, equal slot owners and seek-flock registries, equal
movestates and destinations, equal events; positions within 1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core.config import (
    CombatStance,
    DiplomacyState,
    EngineConfig,
    MoveState,
)
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig
from permafrost_engine_tpu_torch.game.engine import Engine
from test_combat import small_cfg as combat_cfg
from test_dynamic_nav import BUILDING_FLAGS
from test_engine_move import small_cfg as move_cfg


def _pair(cfg, war=True):
    engines = [JaxEngine(cfg),
               Engine(TorchConfig(**dataclasses.asdict(cfg)), device="cpu")]
    for eng in engines:
        eng.add_faction(0)
        eng.add_faction(1)
        if war:
            eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    return engines


def _spawn_both(engines, *args, **kw):
    uids = [eng.spawn_batch(*args, **kw) for eng in engines]
    assert uids[0] == uids[1]
    return uids[0]


def _assert_fields_equal(jeng, teng):
    jfl = jax.device_get(jeng.state.flocks)
    for name in ("active", "layer", "global_slot", "target_ent", "formation"):
        np.testing.assert_array_equal(getattr(teng.state.flocks, name).numpy(),
                                      np.asarray(getattr(jfl, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(teng.state.factions.chase_slot.numpy(),
                                  np.asarray(jeng.state.factions.chase_slot))
    assert teng._gslot_owner == jeng._gslot_owner
    assert teng._seek_flocks == jeng._seek_flocks
    assert teng._seek_created == jeng._seek_created
    slots = sorted(jeng._gslot_owner)
    np.testing.assert_array_equal(
        teng.state.fields.global_flow.numpy()[slots],
        np.asarray(jeng.state.fields.global_flow)[slots])
    je = jax.device_get(jeng.state.ents)
    for name in ("movestate", "dest", "flock", "has_formation_cell"):
        np.testing.assert_array_equal(getattr(teng.state.ents, name).numpy(),
                                      np.asarray(getattr(je, name)),
                                      err_msg=name)


def test_hunt_equal():
    engines = _pair(combat_cfg())
    hunters = _spawn_both(engines, np.array([[40.0, 40.0]], np.float32),
                          faction=0, max_speed=80.0, base_dmg=30.0,
                          vision_range=40.0)
    prey = _spawn_both(engines, np.array([[200.0, 200.0]], np.float32),
                       faction=1, base_dmg=0.0, hp=30.0,
                       stance=int(CombatStance.NO_ENGAGEMENT))
    for eng in engines:
        assert eng.seek_enemies(hunters)
    jeng, teng = engines
    assert teng.movestate_of(hunters[0]) == MoveState.SEEK_ENEMIES
    assert int(teng.state.flocks.global_slot.max()) >= 0
    _assert_fields_equal(jeng, teng)
    for _ in range(10):
        for eng in engines:
            eng.step(60)
        assert teng.events == jeng.events
        _assert_fields_equal(jeng, teng)
    assert ("entity_death", {"uid": prey[0]}) in teng.events
    np.testing.assert_allclose(teng.pos_of(hunters[0]), jeng.pos_of(hunters[0]),
                               atol=1e-3)


def test_change_driven_rebuilds_equal(monkeypatch):
    """Rebuilds (seek specs, one cadence late) land on the same cadences in
    both engines: none while the world is static, one after the prey moves,
    one after a structure commit (the nav version in the freshness key),
    one after the prey dies."""
    engines = _pair(combat_cfg())
    hunters = _spawn_both(engines, np.array([[40.0, 40.0]], np.float32),
                          faction=0, max_speed=0.0)
    prey = _spawn_both(engines, np.array([[200.0, 200.0]], np.float32),
                       faction=1, max_speed=0.0)
    builds = [[], []]
    for eng, log in zip(engines, builds):
        assert eng.seek_enemies(hunters)
        orig = eng.nav.build_enemy_seek_fields_batch

        def counting(state, specs, _orig=orig, _log=log):
            _log.extend(fid for (_f, _l, _s, fid) in specs if fid is not None)
            return _orig(state, specs)

        monkeypatch.setattr(eng.nav, "build_enemy_seek_fields_batch", counting)
    jeng, teng = engines
    period = teng.seek_refresh_period

    def run(frames):
        for eng in engines:
            eng.step(frames)
        assert builds[0] == builds[1]
        _assert_fields_equal(jeng, teng)
        return len(builds[1])

    primed = run(period * 2)
    assert run(period * 3) == primed
    slot = teng.uid_to_slot[prey[0]]
    jeng.state = jeng.state.replace(ents=jeng.state.ents.replace(
        pos=jeng.state.ents.pos.at[slot].set(jnp.asarray([120.0, 120.0]))))
    teng.state.ents.pos[slot] = torch.tensor([120.0, 120.0])
    moved = run(period * 2)
    assert moved > primed
    assert run(period * 3) == moved
    # a building of the hunters' own faction: no enemy moved, but the
    # commit bumps the nav version, so the field is rebuilt
    wall = _spawn_both(engines, np.array([[140.0, 60.0]], np.float32),
                       faction=0, radius=6.0, flags=BUILDING_FLAGS,
                       max_speed=0.0)
    for eng in engines:
        eng.set_structure_blocking(wall[0], True)
    walled = run(period * 2)
    assert walled > moved and teng._nav_version == 1
    assert run(period * 3) == walled
    jeng.state = jeng.state.replace(ents=jeng.state.ents.replace(
        hp=jeng.state.ents.hp.at[slot].set(0.0),
        alive=jeng.state.ents.alive.at[slot].set(False)))
    teng.state.ents.hp[slot] = 0.0
    teng.state.ents.alive[slot] = False
    assert run(period * 2) > walled


def test_surround_equal():
    engines = _pair(move_cfg(), war=False)
    target = _spawn_both(engines, np.array([[300.0, 300.0]], np.float32))[0]
    pack = _spawn_both(engines, np.array([[80.0, 80.0], [90.0, 80.0],
                                          [80.0, 90.0]], np.float32),
                       max_speed=120.0)
    for eng in engines:
        assert eng.surround(pack, target)
    jeng, teng = engines
    assert teng.movestate_of(pack[0]) == MoveState.SURROUND_ENTITY
    _assert_fields_equal(jeng, teng)
    for _ in range(8):
        for eng in engines:
            eng.step(30)
        assert teng.events == jeng.events
        _assert_fields_equal(jeng, teng)
    tp = np.stack([teng.pos_of(u) for u in pack])
    np.testing.assert_allclose(tp, np.stack([jeng.pos_of(u) for u in pack]),
                               atol=1e-3)
    d = np.linalg.norm(tp - teng.pos_of(target), axis=1)
    assert d.max() < 60.0, d


def test_full_slab_evicts_seek_flock_equal():
    """Two global slots: two seek flocks take them, a surround order
    evicts the oldest seek flock (it loses its slot and its refreshes),
    and the war's chase fields evict in turn at the next cadences."""
    cfg = dataclasses.replace(combat_cfg(), global_field_slots=2)
    engines = _pair(cfg)
    h1 = _spawn_both(engines, np.array([[40.0, 40.0]], np.float32), faction=0,
                     max_speed=40.0)
    h2 = _spawn_both(engines, np.array([[40.0, 200.0]], np.float32),
                     faction=0, max_speed=40.0)
    pack = _spawn_both(engines, np.array([[200.0, 40.0]], np.float32),
                       faction=1, max_speed=40.0)
    target = _spawn_both(engines, np.array([[200.0, 200.0]], np.float32),
                         faction=0, max_speed=0.0, base_dmg=0.0)[0]
    for eng in engines:
        assert eng.seek_enemies(h1)
        assert eng.seek_enemies(h2)
    jeng, teng = engines
    assert len(teng._seek_flocks) == 2
    _assert_fields_equal(jeng, teng)
    first = next(iter(teng._seek_flocks))
    for eng in engines:
        assert eng.surround(pack, target)
    assert first not in teng._seek_flocks and len(teng._seek_flocks) == 1
    assert int(teng.state.flocks.global_slot[first]) == -1
    assert teng.nav.stats["gslot_evictions"] == 1
    _assert_fields_equal(jeng, teng)
    for _ in range(4):
        for eng in engines:
            eng.step(30)
        assert teng.events == jeng.events
        _assert_fields_equal(jeng, teng)
    assert (teng.nav.stats["gslot_evictions"]
            == jeng.nav.stats["gslot_evictions"] > 1)
