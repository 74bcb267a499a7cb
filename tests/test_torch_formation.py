"""PyTorch port vs the JAX package: formations.

* ``layout_cells`` and ``block_depth`` on ``tests/test_formation.py``'s
  layouts (rank and column, blocked rows, occupancy and islands): equal
  cells, equal depths (tolerance: none, both are the same host numpy).
* ``move_in_formation`` through both ``Engine``s (the port on the CPU) on
  ``tests/test_formation.py``'s scenes: subformations per nav layer, per
  unit type, and one block through a choke. Equal ``dest``,
  ``formation_cell``, ``has_formation_cell``, ``flocks.formation``, host
  and device slot tables, and the cell-seeded flow-slab rows (tolerance:
  none). Then both are stepped across the 60-frame nav cadence: equal
  events and slot tables, positions within 1e-3 (the crowd's rounding).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core.config import COST_IMPASSABLE, EngineConfig, NAV_TILE_SIZE
from permafrost_engine_tpu.game import formation as jform
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu.ops.islands import label_islands
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig
from permafrost_engine_tpu_torch.game import formation as tform
from permafrost_engine_tpu_torch.game.engine import Engine
from test_engine_move import small_cfg


def _layouts():
    cost = np.ones((128, 128), np.uint8)
    blocked = cost.copy()
    blocked[60:68, :] = COST_IMPASSABLE
    half = cost.copy()
    half[:, 64:] = COST_IMPASSABLE
    occ = np.zeros((128, 128), np.int32)
    occ[78:82, 28:36] = 1
    isl = np.asarray(label_islands(jax.numpy.asarray(half)))
    g = np.array([256.0, 256.0])
    return {
        "rank": (16, g, np.array([1.0, 0.0]), 1, 4.0, cost, {}),
        "column": (16, g, np.array([1.0, 0.0]), 2, 4.0, cost, {}),
        "diagonal_rank": (40, g, np.array([0.6, 0.8]), 1, 3.0, cost, {}),
        "blocked_row": (8, np.array([256.0, 62 * NAV_TILE_SIZE]),
                        np.array([0.0, 1.0]), 1, 4.0, blocked, {}),
        "occupied_islands": (24, np.array([32 * NAV_TILE_SIZE, 80 * NAV_TILE_SIZE]),
                             np.array([0.0, 1.0]), 1, 4.0, half,
                             dict(occupancy=occ, islands=isl,
                                  island=int(isl[80, 32]))),
    }


@pytest.mark.parametrize("name", list(_layouts()))
def test_layout_and_depth_equal(name):
    n, goal, d, ftype, spacing, cost, kw = _layouts()[name]
    want = jform.layout_cells(n, goal, d, jform.FormationType(ftype), spacing,
                              cost, **kw)
    got = tform.layout_cells(n, goal, d, tform.FormationType(ftype), spacing,
                             cost, **kw)
    assert len(want) >= n
    np.testing.assert_array_equal(got, want)
    assert tform.block_depth(got, d) == jform.block_depth(want, d)


def _tcfg(cfg):
    return TorchConfig(**dataclasses.asdict(cfg))


def _cfg(num_layers=1, max_ents=64):
    return EngineConfig(max_ents=max_ents, chunks_r=2, chunks_c=2,
                        num_layers=num_layers, max_flocks=8, max_projectiles=8,
                        field_slab_slots=16, los_slab_slots=16)


def _spawn_layers(eng):
    rng = np.random.default_rng(2)
    small = eng.spawn_batch((rng.random((8, 2)) * 30 + 60).astype(np.float32),
                            radius=1.0, max_speed=60.0)
    big = eng.spawn_batch((rng.random((4, 2)) * 30 + 100).astype(np.float32),
                          radius=8.0, max_speed=60.0)
    return small + big, (300.0, 300.0)


def _spawn_types(eng):
    rng = np.random.default_rng(3)
    k = eng.spawn_batch((rng.random((6, 2)) * 30 + 60).astype(np.float32),
                        max_speed=60.0, unit_type=1, formation_priority=0)
    m = eng.spawn_batch((rng.random((6, 2)) * 30 + 60).astype(np.float32),
                        max_speed=60.0, unit_type=2, formation_priority=1)
    b = eng.spawn_batch((rng.random((5, 2)) * 25 + 60).astype(np.float32),
                        max_speed=80.0, unit_type=3)
    return k + m + b, (320.0, 320.0)


def _spawn_choke(eng):
    rng = np.random.default_rng(5)
    pos = (rng.random((64, 2)) * np.array([200.0, 80.0])
           + np.array([150.0, 60.0])).astype(np.float32)
    return eng.spawn_batch(pos, max_speed=80.0), (250.0, 420.0)


def _choke_cost(cfg):
    cost = np.ones((1, cfg.field_h, cfg.field_w), np.uint8)
    cost[0, 62:66, :] = COST_IMPASSABLE
    cost[0, 62:66, 61:67] = 1
    return cost


SCENES = {
    "per_layer": (lambda: _cfg(num_layers=4), None, _spawn_layers),
    "per_unit_type": (lambda: _cfg(), None, _spawn_types),
    "choke": (lambda: _cfg(max_ents=128), _choke_cost, _spawn_choke),
    "settle": (small_cfg, None, lambda eng: (eng.spawn_batch(
        (np.random.default_rng(1).random((9, 2)) * 40 + 80).astype(np.float32),
        max_speed=80.0), (300.0, 300.0))),
}


@pytest.fixture(scope="module", params=list(SCENES))
def ordered(request):
    make_cfg, make_cost, spawn = SCENES[request.param]
    cfg = make_cfg()
    cost = None if make_cost is None else make_cost(cfg)
    engines = [JaxEngine(cfg, cost_base=cost),
               Engine(_tcfg(cfg), device="cpu", cost_base=cost)]
    uids = []
    for eng in engines:
        u, goal = spawn(eng)
        uids.append(u)
        assert eng.move_in_formation(u, goal, 1)
    assert uids[0] == uids[1]
    return request.param, engines, uids[0]


def _assert_tables_equal(jeng, teng):
    np.testing.assert_array_equal(teng.nav.slot_mirror, jeng.nav.slot_mirror)
    np.testing.assert_array_equal(teng.nav.los_mirror, jeng.nav.los_mirror)
    jfl = jax.device_get(jeng.state.flocks)
    for name in ("active", "dest", "layer", "field_slot", "los_slot",
                 "global_slot", "formation"):
        np.testing.assert_array_equal(getattr(teng.state.flocks, name).numpy(),
                                      np.asarray(getattr(jfl, name)),
                                      err_msg=name)
    flow = np.unique(jeng.nav.slot_mirror[jeng.nav.slot_mirror >= 0])
    np.testing.assert_array_equal(teng.state.fields.flow.numpy()[flow],
                                  np.asarray(jeng.state.fields.flow)[flow])


def test_formation_order_equal(ordered):
    name, (jeng, teng), uids = ordered
    je = jax.device_get(jeng.state.ents)
    for field in ("dest", "formation_cell", "has_formation_cell", "flock"):
        np.testing.assert_array_equal(getattr(teng.state.ents, field).numpy(),
                                      np.asarray(getattr(je, field)),
                                      err_msg=field)
    _assert_tables_equal(jeng, teng)
    slots = [teng.uid_to_slot[u] for u in uids]
    assert teng.state.ents.has_formation_cell.numpy()[slots].all()
    fids = set(teng.state.ents.flock.numpy()[slots].tolist())
    assert (teng.state.flocks.formation.numpy()[sorted(fids)] == 1).all()
    # the cell-seeded fields are in the cache under their ("cells", ...) keys
    assert any(k[2][0] == "cells" for k in teng.nav.flow_cache.order)
    assert teng.nav.flock_chunks == jeng.nav.flock_chunks
    assert teng.unit_type == jeng.unit_type
    if name == "per_layer":
        assert len(fids) == 2


def test_formation_steps_across_cadence_equal(ordered):
    _name, (jeng, teng), uids = ordered
    for eng in (jeng, teng):
        eng.step(66)
    assert teng.events == jeng.events
    _assert_tables_equal(jeng, teng)
    tp = np.stack([teng.pos_of(u) for u in uids])
    jp = np.stack([jeng.pos_of(u) for u in uids])
    np.testing.assert_allclose(tp, jp, atol=1e-3)
    ms = np.asarray(jax.device_get(jeng.state.ents.movestate))
    np.testing.assert_array_equal(teng.state.ents.movestate.numpy(), ms)
