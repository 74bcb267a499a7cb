"""PyTorch port vs the JAX package: structures.

* ``update_portal_graph`` on ``tests/test_portal_update.py``'s scenes
  (a cutout over a chunk border, a stamp then its unstamp, a commit that
  dirties a third of the map): equal portals, pairing and weighted
  adjacency, pid for pid (tolerance: none; both integrate bit-equal), and
  the unstamp restores the original graph.
* ``tests/test_dynamic_nav.py``'s wall scenes through both ``Engine``s (the
  port on the CPU): a wall forcing a detour, a seal that retargets and
  then reopens when buildings are despawned, and a building that only
  replans the flocks crossing its chunks. Equal ``cost_base`` (host and
  device), slot tables, flock and unit destinations, nav stats and events.
* A building whose corpse expires is unstamped by both engines.
"""

import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core.config import (
    COST_IMPASSABLE,
    DiplomacyState,
    EngineConfig,
    EntityFlags,
    FIELD_RES,
    NAV_TILE_SIZE,
)
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu.nav import portals as jpt
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig
from permafrost_engine_tpu_torch.game.engine import Engine
from permafrost_engine_tpu_torch.nav import portals as tpt
from test_dynamic_nav import BUILDING_FLAGS, cfg_2x2, spawn_wall
from test_portal_update import _walled_cost


def _graph_rows(g):
    portals = [(p.pid, p.chunk, p.side, p.lo, p.hi, p.paired) for p in g.portals]
    return portals, {k: list(v) for k, v in g.adj.items()}, g.by_chunk


def _assert_graphs_equal(tg, jg):
    tp, ta, tb = _graph_rows(tg)
    jp, ja, jb = _graph_rows(jg)
    assert tp == jp
    assert ta == ja
    assert tb == jb


def _portal_scene(name):
    """(cost before, cost after, dirty chunks, chunks per side)."""
    if name == "border_cutout":
        cost = _walled_cost(4, 4, np.random.default_rng(7))
        cost2 = cost.copy()
        r0, c0 = FIELD_RES - 2, 2 * FIELD_RES + 10
        cost2[r0:r0 + 8, c0:c0 + 8] = COST_IMPASSABLE
        return cost, cost2, {(0, 2), (1, 2)}, 4
    if name == "inner_stamp":
        cost = _walled_cost(4, 4, np.random.default_rng(11))
        cost2 = cost.copy()
        cost2[40:48, 40:48] = COST_IMPASSABLE
        return cost, cost2, {(0, 0)}, 4
    if name == "full_rebuild":
        cost = _walled_cost(3, 3, np.random.default_rng(3))
        cost2 = cost.copy()
        cost2[60:70, 60:70] = COST_IMPASSABLE
        return cost, cost2, {(0, 0), (0, 1), (1, 0), (1, 1)}, 3
    raise KeyError(name)


@pytest.mark.parametrize("name", ["border_cutout", "inner_stamp",
                                  "full_rebuild"])
def test_update_portal_graph_equal(name):
    cost, cost2, dirty, k = _portal_scene(name)
    jg = jpt.build_portal_graph(cost, k, k)
    tg = tpt.build_portal_graph(cost, k, k, device="cpu")
    _assert_graphs_equal(tg, jg)
    jup, jn = jpt.update_portal_graph(jg, cost2, dirty, k, k)
    tup, tn = tpt.update_portal_graph(tg, cost2, dirty, k, k, device="cpu")
    assert tn == jn
    _assert_graphs_equal(tup, jup)
    if name == "full_rebuild":
        assert tn == k * k
    # the unstamp restores the original graph (as a set: pids compact)
    jback, _ = jpt.update_portal_graph(jup, cost, dirty, k, k)
    tback, _ = tpt.update_portal_graph(tup, cost, dirty, k, k, device="cpu")
    _assert_graphs_equal(tback, jback)
    orig = tpt.build_portal_graph(cost, k, k, device="cpu")

    def canon(g):
        ident = {p.pid: (p.chunk, p.side, p.lo, p.hi) for p in g.portals}
        return (sorted(ident.values()),
                sorted((ident[a], ident[b], w) for a, l in g.adj.items()
                       for b, w in l))
    assert canon(tback) == canon(orig)


def _pair(cfg, cost=None):
    return [JaxEngine(cfg, cost_base=cost),
            Engine(TorchConfig(**dataclasses.asdict(cfg)), device="cpu",
                   cost_base=cost)]


def _assert_nav_equal(jeng, teng, stats=("requests", "hits", "misses",
                                         "retargeted", "invalidations",
                                         "chunks_rebuilt")):
    np.testing.assert_array_equal(teng.nav.cost_base, jeng.nav.cost_base)
    np.testing.assert_array_equal(teng.state.nav.cost_base.numpy(),
                                  np.asarray(jeng.state.nav.cost_base))
    np.testing.assert_array_equal(teng.nav.structure_ref,
                                  jeng.nav.structure_ref)
    np.testing.assert_array_equal(teng.nav.slot_mirror, jeng.nav.slot_mirror)
    np.testing.assert_array_equal(teng.nav.los_mirror, jeng.nav.los_mirror)
    jfl = jax.device_get(jeng.state.flocks)
    for name in ("active", "dest", "field_slot", "los_slot", "global_slot"):
        np.testing.assert_array_equal(getattr(teng.state.flocks, name).numpy(),
                                      np.asarray(getattr(jfl, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(teng.state.ents.dest.numpy(),
                                  np.asarray(jeng.state.ents.dest))
    for key in stats:
        assert teng.nav.stats[key] == jeng.nav.stats[key], key
    assert teng._structures == jeng._structures
    assert teng._nav_version == jeng._nav_version


def test_wall_forces_detour_equal():
    engines = _pair(cfg_2x2())
    for eng in engines:
        squad = eng.spawn_batch(
            (np.array([[96.0, 80.0]], np.float32)
             + np.random.default_rng(3).random((6, 2)).astype(np.float32) * 24),
            max_speed=80.0)
        assert eng.move(squad, (110.0, 430.0))
        eng.step(12)
        spawn_wall(eng, z=256.0, x0=8.0, x1=392.0)
        assert eng.nav._pending_dirty and eng._nav_version == 0
        eng.step(6)
    jeng, teng = engines
    assert teng.nav.stats["invalidations"] > 0
    assert teng._nav_version == 1 and not teng.nav._pending_dirty
    assert (teng.nav.cost_base[0, 63:65, 4:96] == COST_IMPASSABLE).all()
    _assert_nav_equal(jeng, teng)
    for eng in engines:
        eng.step(120)
    _assert_nav_equal(jeng, teng)
    assert teng.events == jeng.events
    np.testing.assert_allclose(teng.state.ents.pos.numpy(),
                               np.asarray(jeng.state.ents.pos), atol=1e-3)


def test_seal_then_reopen_equal():
    engines = _pair(cfg_2x2())
    for eng in engines:
        u = eng.spawn_batch(np.array([[96.0, 96.0]], np.float32),
                            max_speed=80.0)
        wall = spawn_wall(eng, z=256.0, x0=4.0, x1=512.0)
        eng.step(6)
        assert eng.move(u, (96.0, 430.0))
    jeng, teng = engines
    assert teng.nav.stats["retargeted"] == 1
    assert teng.state.ents.dest.numpy()[teng.uid_to_slot[u[0]]][1] < 256.0
    _assert_nav_equal(jeng, teng)
    for eng in engines:
        for w in wall[-6:]:
            eng.despawn(w)
        # despawn unstamps; the move commits before it plans
        assert eng.nav._pending_dirty
        assert eng.move(u, (96.0, 430.0))
    assert teng.nav.stats["retargeted"] == 1
    assert teng.state.ents.dest.numpy()[teng.uid_to_slot[u[0]]][1] > 256.0
    _assert_nav_equal(jeng, teng)
    for eng in engines:
        eng.step(60)
    _assert_nav_equal(jeng, teng)
    assert teng.events == jeng.events


def test_only_crossing_flocks_replan_equal():
    engines = _pair(cfg_2x2())
    for eng in engines:
        a = eng.spawn_batch(np.array([[40.0, 40.0]], np.float32),
                            max_speed=10.0)
        assert eng.move(a, (200.0, 40.0))
        requests = eng.nav.stats["requests"]
        b = eng.spawn_batch(np.array([[400.0, 400.0]], np.float32),
                            radius=7.0, flags=BUILDING_FLAGS, max_speed=0.0)
        eng.set_structure_blocking(b[0], True)
        eng.step(6)
        assert eng.nav.stats["requests"] == requests
        assert eng._nav_version == 1
    _assert_nav_equal(*engines)


def test_building_corpse_unstamps_equal():
    """A building killed in a war: its corpse expires, the drain unstamps
    it, and the next frame's commit restores the terrain cost."""
    cfg = EngineConfig(max_ents=32, chunks_r=1, chunks_c=1, num_layers=2,
                       max_flocks=4, max_projectiles=16, field_slab_slots=8,
                       los_slab_slots=8)
    engines = _pair(cfg)
    for eng in engines:
        eng.add_faction(0)
        eng.add_faction(1)
        eng.set_diplomacy(0, 1, DiplomacyState.WAR)
        eng.spawn_batch(np.array([[100.0, 100.0]], np.float32), faction=0,
                        base_dmg=40.0, attack_period=1)
        b = eng.spawn_batch(
            np.array([[110.0, 100.0]], np.float32), faction=1, radius=5.0,
            flags=BUILDING_FLAGS | int(EntityFlags.COMBATABLE), max_speed=0.0,
            base_dmg=0.0, hp=60.0)
        eng.set_structure_blocking(b[0], True)
        eng.step(6)
        r = int(100.0 // NAV_TILE_SIZE)
        assert eng.nav.cost_base[0, r, int(110.0 // NAV_TILE_SIZE)] == \
            COST_IMPASSABLE
        eng.step(300)
        assert ("entity_removed", {"uid": b[0]}) in eng.events
        assert b[0] not in eng._structures
        eng.step(1)
    jeng, teng = engines
    assert teng.events == jeng.events
    assert not teng.nav.structure_ref.any()
    np.testing.assert_array_equal(teng.nav.cost_base, teng.nav.terrain_cost)
    _assert_nav_equal(jeng, teng)
    assert teng._nav_version == 2


def test_commit_without_stamps_is_a_host_noop(monkeypatch):
    """With no stamp pending, the commit that opens every frame and order
    recomputes nothing, pushes nothing and keeps the nav version."""
    eng = Engine(TorchConfig(**dataclasses.asdict(cfg_2x2())), device="cpu")
    u = eng.spawn_batch(np.array([[96.0, 96.0]], np.float32), max_speed=80.0)

    def boom(*_a, **_k):
        raise AssertionError("commit work with nothing pending")

    for name in ("_recompute_effective", "_push_tables",
                 "_invalidate_chunk_fields"):
        monkeypatch.setattr(eng.nav, name, boom)
    state = eng.state
    eng._commit_nav()
    assert eng.state is state and eng._nav_version == 0
    monkeypatch.undo()
    assert eng.move(u, (300.0, 300.0))
    eng.step(3)
    assert eng._nav_version == 0 and not eng.nav._pending_dirty


def test_engine_runs_on_the_card_by_default():
    """The port's entry point asks for the CPU only when told to."""
    default = inspect.signature(Engine.__init__).parameters["device"].default
    assert default == "cuda"
