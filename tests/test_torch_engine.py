"""PyTorch port vs the JAX package: the move-order slice end to end.

The JAX ``Engine`` and the port's ``Engine`` (on the CPU, where the port's
kernel wrappers run their plain versions) take the same map
(test_engine_move.py's walled 2x2-chunk map), the same spawn and the same
move order, and run 96 frames, before the JAX engine's first 120-frame
blocker cadence. The navigation results must be exactly equal: installed
flow- and LOS-slab rows, the host slot tables and the flock table. Unit
positions must agree within a mean of 0.5 world units and a maximum of 4
(the crowd is chaotic: the two engines round differently).

Then the port alone drives the squad to full arrival through the wall gap,
and a fresh interpreter shows the port imports no JAX.
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

from permafrost_engine_tpu.core.config import FIELD_RES, MoveState, NAV_TILE_SIZE
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig
from permafrost_engine_tpu_torch.game.engine import Engine
from test_engine_move import small_cfg, walled_cost

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GOAL = (400.0, 400.0)


def _tcfg(cfg):
    """The port's EngineConfig with the same fields as a JAX one."""
    return TorchConfig(**dataclasses.asdict(cfg))


def _squad():
    rng = np.random.default_rng(0)
    return (np.array([400.0, 100.0]) + rng.random((8, 2)) * 30).astype(np.float32)


@pytest.fixture(scope="module")
def both_engines():
    cfg = small_cfg()
    jeng = JaxEngine(cfg, cost_base=walled_cost(cfg))
    teng = Engine(_tcfg(cfg), device="cpu", cost_base=walled_cost(cfg))
    ju = jeng.spawn_batch(_squad(), faction=0, max_speed=80.0)
    tu = teng.spawn_batch(_squad(), faction=0, max_speed=80.0)
    assert ju == tu
    assert jeng.move(ju, _GOAL) and teng.move(tu, _GOAL)
    jeng.step(96)
    teng.step(96)
    return jeng, teng, tu


def test_navigation_state_exact(both_engines):
    jeng, teng, _ = both_engines
    np.testing.assert_array_equal(teng.nav.slot_mirror, jeng.nav.slot_mirror)
    np.testing.assert_array_equal(teng.nav.los_mirror, jeng.nav.los_mirror)
    assert (teng.nav.slot_mirror >= 0).sum() >= 3
    jfl = jax.device_get(jeng.state.flocks)
    for name in ("active", "dest", "layer", "target_ent", "field_slot",
                 "los_slot", "global_slot", "formation"):
        np.testing.assert_array_equal(getattr(teng.state.flocks, name).numpy(),
                                      np.asarray(getattr(jfl, name)), err_msg=name)
    flow_slots = np.unique(jeng.nav.slot_mirror[jeng.nav.slot_mirror >= 0])
    los_slots = np.unique(jeng.nav.los_mirror[jeng.nav.los_mirror >= 0])
    jflow = np.asarray(jeng.state.fields.flow)[flow_slots]
    jlos = np.asarray(jeng.state.fields.los)[los_slots]
    np.testing.assert_array_equal(teng.state.fields.flow.numpy()[flow_slots], jflow)
    np.testing.assert_array_equal(teng.state.fields.los.numpy()[los_slots], jlos)
    assert (jflow > 0).sum() > 1000 and jlos.sum() > 1000


def test_positions_close(both_engines):
    jeng, teng, uids = both_engines
    jp = np.stack([jeng.pos_of(u) for u in uids])
    tp = np.stack([teng.pos_of(u) for u in uids])
    d = np.linalg.norm(tp - jp, axis=1)
    assert np.isfinite(tp).all()
    assert d.mean() < 0.5 and d.max() < 4.0, d
    # both squads actually moved toward the gap
    start = _squad()
    assert np.linalg.norm(tp - start, axis=1).min() > 10.0


def test_events_match(both_engines):
    jeng, teng, _ = both_engines
    starts = sorted(e[1]["uid"] for e in teng.events if e[0] == "motion_start")
    jstarts = sorted(e[1]["uid"] for e in jeng.events if e[0] == "motion_start")
    assert starts == jstarts and len(starts) == 8


def test_new_terrain_replans_like_jax():
    """set_cost_base on live flocks: both engines drop every cached field
    and replan; the closed gap moves the effective goal to the squad's
    side, so ring slots are re-dealt. Tables and destinations are equal."""
    cfg = small_cfg()
    engines = [JaxEngine(cfg, cost_base=walled_cost(cfg)),
               Engine(_tcfg(cfg), device="cpu", cost_base=walled_cost(cfg))]
    sealed = walled_cost(cfg)
    sealed[:, FIELD_RES - 1:FIELD_RES + 1, :] = 255
    for eng in engines:
        uids = eng.spawn_batch(_squad(), faction=0, max_speed=80.0)
        assert eng.move(uids, _GOAL)
        eng.set_cost_base(sealed)
    jeng, teng = engines
    assert teng.nav.stats["retargeted"] == jeng.nav.stats["retargeted"] == 1
    np.testing.assert_array_equal(teng.nav.slot_mirror, jeng.nav.slot_mirror)
    np.testing.assert_array_equal(teng.nav.los_mirror, jeng.nav.los_mirror)
    np.testing.assert_array_equal(teng.state.ents.dest.numpy(),
                                  np.asarray(jeng.state.ents.dest))
    np.testing.assert_array_equal(teng.state.flocks.dest.numpy(),
                                  np.asarray(jeng.state.flocks.dest))
    assert teng.state.flocks.dest.numpy()[:, 1].max() < FIELD_RES * NAV_TILE_SIZE


@pytest.fixture(scope="module")
def arrived_engine():
    cfg = small_cfg()
    eng = Engine(_tcfg(cfg), device="cpu", cost_base=walled_cost(cfg))
    uids = eng.spawn_batch(_squad(), faction=0, max_speed=80.0)
    assert eng.move(uids, _GOAL), "path request failed"
    for _ in range(200):
        eng.step(6)
        if all(eng.movestate_of(u) == MoveState.ARRIVED for u in uids):
            break
    return eng, uids


def test_squad_arrives(arrived_engine):
    eng, uids = arrived_engine
    for u in uids:
        assert eng.movestate_of(u) == MoveState.ARRIVED, f"unit {u} stuck"
        d = np.linalg.norm(eng.pos_of(u) - np.asarray(_GOAL))
        assert d < 60.0, f"unit {u} 'arrived' {d:.0f} units from goal"


def test_no_wall_clipping(arrived_engine):
    eng, uids = arrived_engine
    for u in uids:
        assert eng.pos_of(u)[1] > FIELD_RES * NAV_TILE_SIZE


def test_arrival_events_fired(arrived_engine):
    eng, uids = arrived_engine
    done = {ev[1]["uid"] for ev in eng.events if ev[0] == "motion_end"}
    assert set(uids) <= done


_NO_JAX = """
import sys
import numpy as np
import permafrost_engine_tpu_torch
from permafrost_engine_tpu_torch.core.config import EngineConfig, MoveState
from permafrost_engine_tpu_torch.game.engine import Engine
cfg = EngineConfig(max_ents=16, chunks_r=1, chunks_c=2, num_layers=1,
                   max_flocks=4, max_projectiles=8, field_slab_slots=8,
                   los_slab_slots=8)
eng = Engine(cfg, device="cpu")
uids = eng.spawn_batch(np.array([[20.0, 20.0], [30.0, 25.0]], np.float32),
                       max_speed=40.0)
assert eng.move(uids, (400.0, 200.0))
eng.step(12)
assert eng.movestate_of(uids[0]) in (MoveState.MOVING, MoveState.TURNING)
from permafrost_engine_tpu_torch.core.config import DiplomacyState, EntityFlags
from permafrost_engine_tpu_torch.game.formation import FormationType
eng.add_faction(0)
eng.add_faction(1)
eng.set_diplomacy(0, 1, DiplomacyState.WAR)
squad = eng.spawn_batch(np.array([[40.0, 150.0], [48.0, 150.0], [56.0, 152.0]],
                                 np.float32), max_speed=40.0, unit_type=1)
assert eng.move_in_formation(squad, (300.0, 120.0), FormationType.RANK)
assert eng.state.ents.has_formation_cell[eng.uid_to_slot[squad[0]]]
hall = eng.spawn_batch(np.array([[200.0, 60.0]], np.float32), radius=6.0,
                       flags=int(EntityFlags.COLLISION | EntityFlags.BUILDING),
                       max_speed=0.0)
eng.set_structure_blocking(hall[0], True)
enemy = eng.spawn_batch(np.array([[480.0, 200.0]], np.float32), faction=1,
                        max_speed=0.0)
assert eng.seek_enemies(uids)
assert eng.surround([enemy[0]], squad[0])
eng.step(31)
assert eng._nav_version == 1 and (eng.nav.cost_base == 255).any()
assert eng.movestate_of(uids[0]) == MoveState.SEEK_ENEMIES
assert eng.movestate_of(enemy[0]) == MoveState.SURROUND_ENTITY
from permafrost_engine_tpu_torch.game import graphs
from permafrost_engine_tpu_torch.ops import pose, skin
scfg = EngineConfig(max_ents=16, chunks_r=1, chunks_c=1, num_layers=1,
                    max_flocks=4, max_projectiles=8, field_slab_slots=8,
                    los_slab_slots=8, skin_joints=8)
skinned = Engine(scfg, device="cpu")
walker = skinned.spawn_batch(np.array([[20.0, 20.0]], np.float32),
                             max_speed=40.0)
assert skinned.move(walker, (200.0, 200.0))
skinned.step_scan(30)
assert int(skinned.state.anim.tick) == skinned.state.tick == 30
assert int(skinned.state.anim.clip[skinned.uid_to_slot[walker[0]]]) == skin.CLIP_RUN
assert isinstance(skinned._scan_fn, graphs.TickGraphs)
from permafrost_engine_tpu_torch.core.config import SimState
from permafrost_engine_tpu_torch.core.sched import Sleep
from permafrost_engine_tpu_torch.core.session import (load_session_bytes,
                                                      save_session_bytes)
from permafrost_engine_tpu_torch.game.economy import (HarvesterComp,
                                                      ResourceComp, StorageComp)
eco = Engine(cfg, device="cpu")
eco.economy_period = 3
h = eco.spawn_batch(np.array([[100.0, 60.0]], np.float32), max_speed=120.0)[0]
eco.economy.harvesters[h] = HarvesterComp(gather_speeds={"Wood": 5},
                                          max_carry={"Wood": 10})
r = eco.spawn_batch(np.array([[130.0, 60.0]], np.float32),
                    flags=int(EntityFlags.RESOURCE))[0]
eco.economy.resources[r] = ResourceComp("Wood", 30, 30)
s = eco.spawn_batch(np.array([[100.0, 90.0]], np.float32),
                    flags=int(EntityFlags.STORAGE_SITE))[0]
eco.economy.storages[s] = StorageComp(capacity={"Wood": 100})
eco.economy.gather(h, r)

def pauser(task):
    yield Sleep(2)
    eco.sim_state = SimState.PAUSED_FULL
    yield Sleep(3)
    eco.sim_state = SimState.RUNNING

eco.sched.create(pauser)
eco.step(60)
assert eco._frame == 60 and eco.state.tick == 57 and not eco.sched.tasks
for _ in range(40):
    eco.step(6)
    if eco.economy.storages[s].stored.get("Wood", 0) >= 10:
        break
assert eco.economy.storages[s].stored.get("Wood", 0) >= 10
back = load_session_bytes(save_session_bytes(eco), device="cpu")
assert back.economy.storages[s].stored == eco.economy.storages[s].stored
assert bool((back.state.ents.pos == eco.state.ents.pos).all())
from permafrost_engine_tpu_torch.assets.pfmap import make_flat_map, write_pfmap
from permafrost_engine_tpu_torch.script import pf
pf.init(EngineConfig(max_ents=16, chunks_r=1, chunks_c=1, num_layers=1,
                     max_flocks=4, max_projectiles=8, field_slab_slots=8,
                     los_slab_slots=8), device="cpu")
assert pf.load_map_string(write_pfmap(make_flat_map(1, 1)))
ents = [pf.MovableEntity("u.pfobj", f"u{i}", pos=(40.0 + 4 * i, 0.0, 60.0),
                         speed=40.0) for i in range(3)]
pf.set_unit_selection(ents)
cam = pf.get_active_camera()
cam.move_within_bounds_and_face((100.0, 100.0))
vw, vh = pf.context().ui.virtual_resolution
x, y = cam.world_to_screen((200.0, 0.0, 120.0), vw, vh)
assert pf.inject_mouse_click(x, y, 3) == "move"
pf.step(1)
assert ents[0].moving and pf.get_ticks() == 1
import os, tempfile
from permafrost_engine_tpu_torch.render import (debug_overlays, draw, hud,
                                                raster, scene, textures,
                                                ui_compose)
from permafrost_engine_tpu_torch.ops import quilt
from permafrost_engine_tpu_torch.utils import image, noise
pf.set_minimap_render_all_ents(True)
pf.settings_set("pf.debug.show_chunk_boundaries", True)
with tempfile.TemporaryDirectory() as tmp:
    for name, mm in (("frame.npy", False), ("minimap.npy", True)):
        assert pf.dump_framebuffer(os.path.join(tmp, name), minimap=mm)
        img = np.load(os.path.join(tmp, name))
        assert img.dtype == np.uint8 and img.ndim == 3 and img.std() > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "permafrost_engine_tpu"))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    """A fresh interpreter (tests/conftest.py imports jax into this one)
    builds and steps an Engine, orders a formation move, places a
    structure, issues seek-enemies and surround orders, runs a skinned
    engine through ``step_scan`` (``ops/skin``, ``ops/pose``,
    ``game/graphs``), and runs a harvest with a task that pauses the game,
    then a session round trip (``core/sched``, ``game/economy``,
    ``core/session``, ``core/pickling`` and the rest of the host layer),
    then drives the ``pf`` script surface (a PFMAP map loaded from text,
    script entities ordered by a right click through the camera, one
    ``pf.step``) and renders through it (``pf.dump_framebuffer``, a frame
    with a debug overlay and the HUD, and the minimap; every ``render``
    module, ``ops/quilt``, ``utils/image`` and ``utils/noise`` imported),
    without importing jax, jaxlib, flax or anything of the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
