"""PyTorch port vs the JAX package: the war path end to end.

The JAX ``Engine`` and the port's ``Engine`` (on the CPU, where the port's
kernel wrappers run their plain versions) play the same scenes and must
give the same results:

* ``tests/test_combat.py``'s scenes (melee kill and corpse removal,
  projectile kill with shooter and cookie, aggressive chase, no
  engagement): equal event lists, payloads included;
* ``tests/test_chase_layers.py``'s wall scene with a 6-frame cadence:
  bit-equal ``chase_slot`` tables and ``global_flow`` rows after the first
  refresh, and equal events until the kill;
* ``test_torch_engine.py``'s walled 2x2-chunk move, stepped to 240 frames
  across the 60-frame blocker cadence: equal host slot tables and flock
  tables and the same flow/LOS slab rows.

A fresh interpreter then runs a small war through the port with no JAX
module loaded.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core.config import (
    COST_IMPASSABLE,
    CombatStance,
    DiplomacyState,
    EngineConfig,
    NavDomain,
)
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig
from permafrost_engine_tpu_torch.game.engine import Engine
from test_combat import small_cfg as combat_cfg
from test_engine_move import small_cfg as move_cfg
from test_engine_move import walled_cost

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tcfg(cfg):
    """The port's EngineConfig with the same fields as a JAX one."""
    return TorchConfig(**dataclasses.asdict(cfg))


def _pair(cfg, cost=None, war=True):
    engines = [JaxEngine(cfg, cost_base=cost),
               Engine(_tcfg(cfg), device="cpu", cost_base=cost)]
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


def _p(x, z):
    return np.array([[x, z]], np.float32)


SCENES = {
    "melee_kill_corpse": (240, [
        (_p(100, 100), dict(faction=0, base_dmg=20.0, hp=100.0,
                            attack_period=1)),
        (_p(104, 100), dict(faction=1, base_dmg=0.0, hp=40.0))]),
    "projectile_kill": (360, [
        (_p(100, 100), dict(faction=0, is_ranged=True, attack_range=60.0,
                            base_dmg=80.0, attack_period=1,
                            stance=int(CombatStance.HOLD_POSITION))),
        (_p(140, 100), dict(faction=1, base_dmg=0.0, hp=100.0,
                            stance=int(CombatStance.NO_ENGAGEMENT)))]),
    "aggressive_chase": (60, [
        (_p(100, 100), dict(faction=0, max_speed=40.0, vision_range=100.0,
                            attack_range=5.0)),
        (_p(160, 100), dict(faction=1, base_dmg=0.0,
                            stance=int(CombatStance.NO_ENGAGEMENT)))]),
    "no_engagement": (120, [
        (_p(100, 100), dict(faction=0,
                            stance=int(CombatStance.NO_ENGAGEMENT))),
        (_p(104, 100), dict(faction=1,
                            stance=int(CombatStance.NO_ENGAGEMENT)))]),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_combat_scene_events_equal(scene):
    frames, spawns = SCENES[scene]
    engines = _pair(combat_cfg())
    uids = [_spawn_both(engines, pos, **kw)[0] for pos, kw in spawns]
    for eng in engines:
        eng.step(frames)
    jeng, teng = engines
    assert teng.events == jeng.events
    kinds = {k for k, _ in teng.events}
    if scene == "melee_kill_corpse":
        assert {"attack_start", "entity_death", "entity_removed"} <= kinds
        assert uids[1] not in teng.uid_to_slot
    elif scene == "projectile_kill":
        hit = next(p for k, p in teng.events if k == "projectile_hit")
        assert hit == {"uid": uids[1], "shooter": uids[0], "cookie": 80.0}
        assert ("entity_removed", {"uid": uids[1]}) in teng.events
    elif scene == "aggressive_chase":
        assert teng.pos_of(uids[0])[0] > 110.0
        np.testing.assert_allclose(teng.pos_of(uids[0]), jeng.pos_of(uids[0]),
                                   atol=1e-3)
    else:
        assert "attack_start" not in kinds
    np.testing.assert_array_equal(teng.state.fog.state.numpy(),
                                  np.asarray(jeng.state.fog.state))


def test_stance_stop_despawn_equal():
    """Mid-chase orders: one chaser set to HOLD_POSITION, one stopped, one
    enemy despawned; both engines give the same events and entity tables."""
    engines = _pair(combat_cfg())
    a = _spawn_both(engines, np.array([[100, 100], [100, 130]], np.float32),
                    faction=0, max_speed=40.0, vision_range=100.0,
                    attack_range=5.0)
    b = _spawn_both(engines, np.array([[150, 100], [150, 130]], np.float32),
                    faction=1, base_dmg=0.0,
                    stance=int(CombatStance.NO_ENGAGEMENT))
    for eng in engines:
        eng.step(30)
        eng.set_stance([a[0]], CombatStance.HOLD_POSITION)
        eng.stop([a[1]])
        eng.despawn(b[1])
        eng.step(90)
    jeng, teng = engines
    assert teng.events == jeng.events
    je = jax.device_get(jeng.state.ents)
    for name in ("alive", "stance", "movestate", "flock", "combatstate",
                 "target"):
        np.testing.assert_array_equal(getattr(teng.state.ents, name).numpy(),
                                      np.asarray(getattr(je, name)),
                                      err_msg=name)
    assert teng.uid_to_slot == jeng.uid_to_slot
    assert teng._free_slots == jeng._free_slots


def _wall_pair():
    cost = np.ones((8, 64, 64), np.uint8)
    cost[:, 0:52, 32] = COST_IMPASSABLE
    cfg = EngineConfig(max_ents=16, chunks_r=1, chunks_c=1, num_layers=8,
                       max_flocks=4, max_projectiles=8, field_slab_slots=8,
                       los_slab_slots=8)
    engines = _pair(cfg, cost)
    for eng in engines:
        eng.seek_refresh_period = 6
    return engines


@pytest.mark.parametrize("kind", ["big", "water"])
def test_chase_fields_bit_equal(kind):
    """The wall scene: the first refresh (frame 12, from the frame-6
    snapshot) builds bit-equal chase tables and fields; the chaser then
    routes around the wall to the same kill, with the same events."""
    engines = _wall_pair()
    if kind == "big":
        a_kw, b_kw = dict(radius=4.0), {}
    else:
        a_kw = b_kw = dict(domain=NavDomain.WATER)
    _spawn_both(engines, _p(100, 100), faction=0, max_speed=60.0,
                vision_range=250.0, attack_range=8.0, base_dmg=50.0,
                attack_period=1, **a_kw)
    _spawn_both(engines, _p(160, 100), faction=1, base_dmg=0.0, hp=60.0,
                **b_kw)
    for eng in engines:
        eng.step(12)
    jeng, teng = engines
    jcs = np.asarray(jeng.state.factions.chase_slot)
    np.testing.assert_array_equal(teng.state.factions.chase_slot.numpy(), jcs)
    assert (jcs >= 0).sum() >= 2
    slots = np.unique(jcs[jcs >= 0])
    np.testing.assert_array_equal(
        teng.state.fields.global_flow.numpy()[slots],
        np.asarray(jeng.state.fields.global_flow)[slots])
    assert teng._gslot_owner == jeng._gslot_owner
    for _ in range(20):
        for eng in engines:
            eng.step(60)
        assert teng.events == jeng.events
        if any(k == "entity_death" for k, _ in teng.events):
            break
    assert any(k == "entity_death" for k, _ in teng.events)
    assert teng.pos_of(1)[0] > 32 * 4.0          # it went around the wall
    np.testing.assert_array_equal(teng.state.factions.chase_slot.numpy(),
                                  np.asarray(jeng.state.factions.chase_slot))


def test_move_across_blocker_cadence_tables_equal():
    """The walled 2x2-chunk move of test_torch_engine.py (one faction, so
    only the blocker half of the cadence runs), with a parked line plugging
    the wall gap, stepped to 240 frames: blocker snapshots at 60, 120, 180
    and 240, each consumed at the next blocker period; the plug flips the gap's
    portal edges and the squad replans once (rate-limited after that)."""
    cfg = move_cfg()
    engines = [JaxEngine(cfg, cost_base=walled_cost(cfg)),
               Engine(_tcfg(cfg), device="cpu", cost_base=walled_cost(cfg))]
    rng = np.random.default_rng(0)
    squad = (np.array([400.0, 100.0]) + rng.random((8, 2)) * 30
             ).astype(np.float32)
    # a parked line across the wall gap: its blockers bury the gap portal
    parked = np.stack([2.0 + 4.0 * np.arange(8), np.full(8, 250.0)],
                      1).astype(np.float32)
    uids = _spawn_both(engines, squad, faction=0, max_speed=80.0)
    _spawn_both(engines, parked, faction=0)
    for eng in engines:
        assert eng.move(uids, (400.0, 400.0))
        eng.step(240)
    jeng, teng = engines
    np.testing.assert_array_equal(teng.nav.slot_mirror, jeng.nav.slot_mirror)
    np.testing.assert_array_equal(teng.nav.los_mirror, jeng.nav.los_mirror)
    assert teng.nav._blocker_snap is not None
    np.testing.assert_array_equal(teng.nav._blocker_snap,
                                  np.asarray(jeng.nav._blocker_snap))
    jfl = jax.device_get(jeng.state.flocks)
    for name in ("active", "dest", "layer", "field_slot", "los_slot",
                 "global_slot"):
        np.testing.assert_array_equal(getattr(teng.state.flocks, name).numpy(),
                                      np.asarray(getattr(jfl, name)),
                                      err_msg=name)
    flow = np.unique(jeng.nav.slot_mirror[jeng.nav.slot_mirror >= 0])
    np.testing.assert_array_equal(teng.state.fields.flow.numpy()[flow],
                                  np.asarray(jeng.state.fields.flow)[flow])
    for key in ("requests", "hits", "misses", "blocker_replans"):
        assert teng.nav.stats[key] == jeng.nav.stats[key], key
    assert teng.nav.stats["blocker_replans"] >= 1
    # flock 0 replans at 120, on the frame-60 snapshot (a cadence with no
    # war and no blocker period of its own consumes nothing)
    assert teng._blocker_replan_frame == jeng._blocker_replan_frame == {0: 120}
    assert {k for k, _ in teng.events} == {k for k, _ in jeng.events}


_NO_JAX = """
import sys
import numpy as np
from permafrost_engine_tpu_torch.core.config import DiplomacyState, EngineConfig
from permafrost_engine_tpu_torch.game.engine import Engine
cfg = EngineConfig(max_ents=32, chunks_r=1, chunks_c=1, num_layers=1,
                   max_flocks=4, max_projectiles=16, field_slab_slots=8,
                   los_slab_slots=8)
eng = Engine(cfg, device="cpu")
eng.add_faction(0)
eng.add_faction(1)
eng.set_diplomacy(0, 1, DiplomacyState.WAR)
eng.spawn_batch(np.array([[100.0, 100.0], [96.0, 92.0]], np.float32),
                faction=0, base_dmg=30.0, attack_period=1, is_ranged=[False, True],
                attack_range=[5.0, 40.0])
eng.spawn_batch(np.array([[150.0, 100.0]], np.float32), faction=1, hp=50.0)
eng.step(360)
kinds = {k for k, _ in eng.events}
assert {"attack_start", "entity_death", "entity_removed"} <= kinds, kinds
assert (eng.state.fog.state[0] == 2).any()
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "permafrost_engine_tpu"))
assert not bad, bad
print("ok")
"""


def test_war_imports_no_jax():
    """A fresh interpreter (tests/conftest.py imports jax into this one)
    fights a small war through the port without importing jax, jaxlib,
    flax or anything of the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
