"""PyTorch port: the nav service's boundary (CPU, no JAX).

* After each of the engine's nav-changing actions (a group order, a failed
  order, a formation order, a stray-chunk extension, a structure drop and
  its commit, a flock reclaim once the table is full, a session save and
  load, new terrain) the device flock tables ``flocks.field_slot`` and
  ``flocks.los_slot`` equal the service's host mirrors, and
  ``state.nav.cost_base`` equals its host costs (tolerance: none).
* A flock released by a failed request and one released by a reclaim
  leave the same nav state: no planned chunks, goal, detour flag or failed
  extension, and both slot-table rows at -1 on the host and the device.
* Outside ``nav/``, the port's source reaches no private name of the
  service and none of its per-flock dicts or mirrors, and only
  ``nav/service.py`` assigns the device copies of its host state.
"""

import os
import re

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu_torch.core.config import (
    COST_IMPASSABLE,
    EngineConfig,
    EntityFlags,
    FIELD_RES,
    NAV_TILE_SIZE,
)
from permafrost_engine_tpu_torch.core.session import (load_session_bytes,
                                                      save_session_bytes)
from permafrost_engine_tpu_torch.game.engine import Engine

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_REPO, "permafrost_engine_tpu_torch")
CHUNK_W = FIELD_RES * NAV_TILE_SIZE      # world units a chunk spans


def _cfg(max_flocks=8):
    return EngineConfig(max_ents=256, chunks_r=3, chunks_c=3, num_layers=2,
                        max_flocks=max_flocks, max_projectiles=8,
                        field_slab_slots=12, los_slab_slots=12)


def _cost():
    """Layer 0: a wall across the map's middle row of chunks with a gap at
    its east end; layer 1: impassable everywhere, so its requests fail."""
    cfg = _cfg()
    cost = np.ones((cfg.num_layers, cfg.field_h, cfg.field_w), np.uint8)
    cost[0, 96:100, :160] = COST_IMPASSABLE
    cost[1] = COST_IMPASSABLE
    return cost


def _engine(max_flocks=8):
    eng = Engine(_cfg(max_flocks), device="cpu", cost_base=_cost())
    rng = np.random.default_rng(3)
    uids = eng.spawn_batch(
        rng.uniform(20.0, 300.0, (24, 2)).astype(np.float32), max_speed=60.0)
    return eng, uids


def _assert_mirrors(eng):
    nav, st = eng.nav, eng.state
    np.testing.assert_array_equal(st.flocks.field_slot.cpu().numpy(),
                                  nav.slot_mirror)
    np.testing.assert_array_equal(st.flocks.los_slot.cpu().numpy(),
                                  nav.los_mirror)
    np.testing.assert_array_equal(st.nav.cost_base.cpu().numpy(),
                                  nav.cost_base)


def _group_order(eng, uids):
    assert eng.move(uids[:12], (2.5 * CHUNK_W, 2.5 * CHUNK_W))
    assert (eng.nav.slot_mirror >= 0).sum() >= 3   # a multi-chunk path
    return eng


def _failed_order(eng, uids):
    big = eng.spawn_batch(np.array([[60.0, 60.0], [70.0, 60.0]], np.float32),
                          radius=4.0)             # footprint layer 1
    assert not eng.move(big, (2.5 * CHUNK_W, 0.5 * CHUNK_W))
    assert eng.nav.stats["failed"] == 1
    return eng


def _formation_order(eng, uids):
    assert eng.move_in_formation(uids, (2.5 * CHUNK_W, 0.5 * CHUNK_W))
    return eng


def _stray_extension(eng, uids):
    eng.move(uids[:12], (2.5 * CHUNK_W, 0.5 * CHUNK_W))
    fid = int(eng.state.ents.flock[eng.uid_to_slot[uids[0]]])
    stray = 2 * 3 + 0                               # chunk (2, 0), off path
    assert eng.nav.slot_mirror[fid, stray] < 0
    eng.teleport(uids[0], (0.5 * CHUNK_W, 2.5 * CHUNK_W))
    # two blocker cadences: the second acts on the first's occupancy
    eng.step(4 * eng.seek_refresh_period)
    assert eng.nav.slot_mirror[fid, stray] >= 0     # the cadence extended
    return eng


def _structure_commit(eng, uids):
    eng.move(uids[:12], (2.5 * CHUNK_W, 2.5 * CHUNK_W))
    bld = eng.spawn_batch(np.array([[2.7 * CHUNK_W, 1.5 * CHUNK_W]],
                                   np.float32), radius=12.0, max_speed=0.0,
                          flags=int(EntityFlags.COLLISION
                                    | EntityFlags.BUILDING))
    eng.set_structure_blocking(bld[0], True)
    eng._commit_nav()
    assert eng._nav_version == 1
    return eng


def _reclaim(eng, uids):
    for i in range(10):                             # the table holds 4
        group = uids[(i % 3) * 8:(i % 3) * 8 + 8]
        eng.move(group, ((0.5 + i % 3) * CHUNK_W, 2.5 * CHUNK_W))
        eng.step(3)
    assert eng.counters["flocks.reclaims"] >= 1
    return eng


def _session(eng, uids):
    _stray_extension(eng, uids)
    return load_session_bytes(save_session_bytes(eng), device="cpu")


def _new_terrain(eng, uids):
    eng.move(uids[:12], (2.5 * CHUNK_W, 2.5 * CHUNK_W))
    cost = _cost()
    cost[0, :, 100:104] = COST_IMPASSABLE
    eng.set_cost_base(cost)
    return eng


ACTIONS = {"group_order": _group_order, "failed_order": _failed_order,
           "formation_order": _formation_order,
           "stray_extension": _stray_extension,
           "structure_commit": _structure_commit, "reclaim": _reclaim,
           "session": _session, "new_terrain": _new_terrain}


@pytest.mark.parametrize("action", list(ACTIONS))
def test_device_tables_equal_the_mirrors(action):
    eng, uids = _engine(max_flocks=4 if action == "reclaim" else 8)
    _assert_mirrors(eng)
    eng = ACTIONS[action](eng, uids)
    _assert_mirrors(eng)
    eng.step(3)
    _assert_mirrors(eng)


def _flock_nav_state(eng, fid):
    nav = eng.nav
    return (fid in nav.path_flocks(), nav.goal_chunk(fid),
            fid in nav.flock_plan_detoured,
            sorted(k for k in nav._extend_failed if k[0] == fid),
            nav.slot_mirror[fid].tolist(), nav.los_mirror[fid].tolist(),
            eng.state.flocks.field_slot[fid].tolist(),
            eng.state.flocks.los_slot[fid].tolist())


def test_failed_request_and_reclaim_release_alike():
    """Both engines plan one flock (with a failed extension recorded); one
    releases it by a request that fails, the other by a reclaim."""
    released = []
    for how in ("failed", "reclaim"):
        eng, uids = _engine()
        assert eng.move(uids[:12], (2.5 * CHUNK_W, 2.5 * CHUNK_W))
        fid = int(eng.state.ents.flock[eng.uid_to_slot[uids[0]]])
        eng.nav._extend_failed.add((fid, 4))
        held = _flock_nav_state(eng, fid)
        assert held[0] and held[1] is not None and held[2] and held[3]
        if how == "failed":
            eng.state, results = eng.nav.request_paths(
                eng.state, [(fid, (60.0, 60.0), (600.0, 600.0), 1)])
            assert results == [(False, (600.0, 600.0))]
        else:
            eng.stop(uids[:12])
            eng._reclaim_flocks()
            assert fid in eng._free_flocks
        released.append(_flock_nav_state(eng, fid))
        _assert_mirrors(eng)
    rows = [-1] * _cfg().num_chunks
    assert released[0] == released[1] == (False, None, False, [], rows, rows,
                                          rows, rows)


def _port_sources():
    """(relative path, text) of the port's source outside ``nav/`` and the
    probes, and ``chip_smoke.py``."""
    out = [("chip_smoke.py", open(os.path.join(_REPO, "chip_smoke.py")).read())]
    for root, _dirs, files in os.walk(_PORT):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, _REPO)
            if (not name.endswith(".py") or os.sep + "nav" + os.sep in path
                    or (rel.startswith(os.path.join(
                        "permafrost_engine_tpu_torch", "tools"))
                        and name.startswith("probe_"))):
                continue
            with open(path) as f:
                out.append((rel, f.read()))
    return out


def test_nothing_outside_nav_reaches_into_the_service():
    private = re.compile(r"\bnav\._\w+")
    owned = re.compile(r"\b(slot_mirror|los_mirror|flock_chunks|flock_goal"
                       r"|flock_plan_detoured)\b")
    found = [(rel, m.group(0)) for rel, text in _port_sources()
             for rx in (private, owned) for m in rx.finditer(text)]
    assert found == []
    assert any(rel.endswith(os.path.join("game", "engine.py"))
               for rel, _ in _port_sources())


def test_only_the_service_writes_its_device_copies():
    write = re.compile(r"\.(nav\.cost_base|field_slot|los_slot)\b"
                       r"(\[[^\]]*\])?\s*=(?!=)")
    writers = set()
    for root, _dirs, files in os.walk(_PORT):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    if write.search(f.read()):
                        writers.add(os.path.relpath(path, _PORT))
    assert writers == {os.path.join("nav", "service.py")}
