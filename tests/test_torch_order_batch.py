"""An economy tick's orders as one batch (``Engine.order_batch``) against
the same orders given one by one.

Two engines run the same small match: bases with storages, gold nodes
across a walled map's chunks (one node runs dry and is despawned inside a
tick) and idle automated workers, a builder founding a building (a
structure commit) and a flock table small enough to reclaim. One engine's
economy gives its orders as it does, one batch a tick; the other's
``order_batch`` is a no-op, so every ``Engine.move`` and ``Engine.stop``
is given alone, as before batches. After every economy tick the two must
hold the same recorded orders, bit-equal entity columns, the same
partition of rows into flocks with the same flock rows, and, for every
flock and chunk, the same flow and LOS field content (compared by content:
the slab slots may differ); at the end, the same economy tables.

The edges: a stop after a queued move of the same unit (and the reverse),
a despawn and a structure stamp inside a batch (each flushes it first), a
batch that fills a 4-flock table (it reclaims as one by one, with no
"flock table full"), a unit whose own chunk needs a field beyond its plan
in a batch that overruns a three-slot slab (the slab evicts what one by
one evicts), and a move outside any batch, which flushes nothing of a
batch and fetches from the device as often as before batches.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu_torch.core.config import (COST_IMPASSABLE,
                                                     EngineConfig, EntityFlags)
from permafrost_engine_tpu_torch.game import economy as eco_mod
from permafrost_engine_tpu_torch.game.engine import Engine

STATIC = int(EntityFlags.COLLISION | EntityFlags.SELECTABLE)
COLUMNS = ("dest", "formation_cell", "movestate", "has_formation_cell",
           "vel", "alive", "pos")


def _cfg(**kw):
    base = dict(max_ents=96, chunks_r=2, chunks_c=2, num_layers=1,
                max_flocks=12, max_projectiles=8, field_slab_slots=6,
                los_slab_slots=6)
    base.update(kw)
    return EngineConfig(**base)


def _walled_cost(cfg, rows=(62, 66)) -> np.ndarray:
    """A wall across the map over nav-tile `rows`, along the chunk row
    boundary, with two gaps, so paths between the map's halves cross
    chunks through portals."""
    r0, r1 = rows
    cost = np.ones((cfg.num_layers, cfg.field_h, cfg.field_w), np.uint8)
    cost[:, r0:r1, :] = COST_IMPASSABLE
    cost[:, r0:r1, 20:28] = 1
    cost[:, r0:r1, 100:108] = 1
    return cost


def _engine(batched: bool, cfg=None, wall=(62, 66)) -> Engine:
    cfg = cfg or _cfg()
    eng = Engine(cfg, device="cpu", cost_base=_walled_cost(cfg, wall))
    eng.add_faction(0)
    if not batched:
        # every order given alone, as before batches
        eng.order_batch = lambda scope: contextlib.nullcontext()
    return eng


def _match(eng) -> dict:
    """Three bases, each a storage with two gold nodes (one across the
    wall) and three idle automated workers; one node small enough to run
    dry; a builder sent to a building site across the wall."""
    eco = eng.economy
    bases = [((100.0, 150.0), (150.0, 330.0), (60.0, 180.0)),
             ((420.0, 170.0), (440.0, 300.0), (380.0, 120.0)),
             ((260.0, 400.0), (300.0, 200.0), (220.0, 440.0))]
    for b, (home, far, near) in enumerate(bases):
        s = eng.spawn_batch(np.array([home], np.float32), radius=3.0,
                            flags=STATIC, max_speed=0.0)[0]
        eco.storages[s] = eco_mod.StorageComp(capacity={"gold": 10_000})
        nodes = eng.spawn_batch(np.array([far, near], np.float32), radius=2.0,
                                flags=STATIC, max_speed=0.0)
        for i, u in enumerate(nodes):
            amount = 6 if (b, i) == (0, 1) else 400
            eco.resources[u] = eco_mod.ResourceComp("gold", amount, amount)
        at = np.asarray(home, np.float32) + np.array(
            [[8.0, 4.0], [-6.0, 8.0], [4.0, -8.0]], np.float32)
        for u in eng.spawn_batch(at, max_speed=90.0):
            eco.harvesters[u] = eco_mod.HarvesterComp(
                gather_speeds={"gold": 2}, max_carry={"gold": 4})
    site = eng.spawn_batch(np.array([[130.0, 290.0]], np.float32),
                           radius=6.0, flags=STATIC, max_speed=0.0)[0]
    builder = eng.spawn_batch(np.array([[110.0, 215.0]], np.float32),
                              max_speed=90.0)[0]
    eco.buildings[site] = eco_mod.BuildingComp(required={"gold": 1})
    eco.builders[builder] = eco_mod.BuilderComp()
    eco.build(builder, site)
    return {"site": site, "builder": builder}


def _spy(eng) -> list:
    """Record every move and stop given to `eng`, with its arguments."""
    calls = []
    for name in ("move", "stop"):
        bound = getattr(eng, name)

        def call(*args, _bound=bound, _name=name):
            calls.append((_name, tuple(int(u) for u in args[0]),
                          tuple(float(x) for x in args[1]) if len(args) > 1
                          else None))
            return _bound(*args)
        setattr(eng, name, call)
    return calls


def _flocks(eng) -> dict:
    """{frozenset of living rows: (flock dest, layer, active, flow fields
    by chunk, LOS fields by chunk)} of every flock a living row is in."""
    st = eng.state
    alive, flock = st.ents.alive.numpy(), st.ents.flock.numpy()
    out = {}
    for fid in np.unique(flock[alive & (flock >= 0)]):
        rows = frozenset(np.flatnonzero(alive & (flock == fid)).tolist())
        fs = st.flocks.field_slot[fid].numpy()
        ls = st.flocks.los_slot[fid].numpy()
        flow = tuple(None if s < 0 else st.fields.flow[s].numpy().tobytes()
                     for s in fs)
        los = tuple(None if s < 0 else st.fields.los[s].numpy().tobytes()
                    for s in ls)
        out[rows] = (st.flocks.dest[fid].numpy().tobytes(),
                     int(st.flocks.layer[fid]), bool(st.flocks.active[fid]),
                     flow, los)
    return out


def _assert_same(a: Engine, b: Engine) -> None:
    ea, eb = a.state.ents, b.state.ents
    for name in COLUMNS:
        assert torch.equal(getattr(ea, name), getattr(eb, name)), name
    # a row is in a flock on one engine exactly where it is on the other
    assert torch.equal(ea.flock >= 0, eb.flock >= 0)
    fa, fb = _flocks(a), _flocks(b)
    assert fa.keys() == fb.keys()
    for rows in fa:
        assert fa[rows] == fb[rows], sorted(rows)


def _tables(eng) -> dict:
    eco = eng.economy
    out = {name: {u: dataclasses.asdict(c) for u, c in
                  getattr(eco, name).items()}
           for name in ("resources", "harvesters", "storages", "buildings",
                        "builders")}
    out["assigned"] = dict(eco._transport_assigned)
    return out


def _delta(c, c0, key):
    return c.get(key, 0.0) - c0.get(key, 0.0)


def test_economy_batch_matches_orders_one_by_one():
    engines = [_engine(True), _engine(False)]
    scenes = [_match(e) for e in engines]
    calls = [_spy(e) for e in engines]
    c0 = [dict(e.counters) for e in engines]
    ticks = 0
    period = engines[0].economy_period
    while ticks < 24:
        for eng, sc in zip(engines, scenes):
            eng.step(1)
            eco = eng.economy
            if (eco.builders[sc["builder"]].building
                    and sc["site"] not in eng._structures):
                eco.found_building(sc["site"])
                eco.supply_building(sc["site"], "gold", 1)
        if engines[0]._frame % period == 0:
            ticks += 1
            assert calls[0] == calls[1]
            _assert_same(*engines)
    assert _tables(engines[0]) == _tables(engines[1])
    ca, cb = (e.counters for e in engines)
    moves = _delta(ca, c0[0], "economy.moves")
    stops = _delta(ca, c0[0], "economy.stops")
    # the scene gives many orders a tick, reclaims flocks, despawns a dry
    # node inside a tick and commits a founded building
    assert moves >= 24 and stops >= 12
    assert _delta(ca, c0[0], "order.batch.orders") == moves + stops
    assert _delta(ca, c0[0], "order.batch.orders") / _delta(
        ca, c0[0], "order.batch.n") > 2.0
    assert _delta(cb, c0[1], "order.batch.n") == 0
    assert ca["flocks.reclaims"] >= 1 and ca["nav.commit.n"] >= 1
    assert len(engines[0].economy.resources) < 6
    # one plan a flush, against one a move alone
    assert _delta(ca, c0[0], "order.plan.n") < _delta(cb, c0[1],
                                                      "order.plan.n")


def _pair(wall=(62, 66), **cfg):
    """Two engines, each with six units of one faction in a row, on the
    walled map."""
    out = []
    for batched in (True, False):
        eng = _engine(batched, _cfg(**cfg), wall)
        uids = eng.spawn_batch(np.array([[40.0 + 30 * i, 120.0]
                                         for i in range(6)], np.float32),
                               max_speed=40.0)
        out.append((eng, uids))
    return out


def _both(pair, script) -> None:
    """Run `script(eng, uids)` on both engines: inside one batch on the
    first, one by one on the second."""
    for eng, uids in pair:
        with eng.order_batch("test.order"):
            script(eng, uids)


@pytest.mark.parametrize("stop_last", [True, False])
def test_last_order_to_a_row_wins(stop_last):
    pair = _pair()

    def script(eng, u):
        if stop_last:
            eng.move([u[0]], (300.0, 400.0))
            eng.stop([u[0]])
        else:
            eng.stop([u[1]])
            eng.move([u[1]], (300.0, 400.0))
        eng.move([u[2]], (100.0, 420.0))

    _both(pair, script)
    (a, ua), (b, _ub) = pair
    _assert_same(a, b)
    ents = a.state.ents
    if stop_last:
        s = a.uid_to_slot[ua[0]]
        assert int(ents.flock[s]) == -1 and int(ents.movestate[s]) == 0
        assert ents.dest[s].tolist() == [300.0, 400.0]
    else:
        s = a.uid_to_slot[ua[1]]
        assert int(ents.flock[s]) >= 0 and int(ents.movestate[s]) != 0
    assert _delta(a.counters, {}, "order.batch.n") == 1


def test_despawn_and_structure_stamp_flush_the_batch():
    pair = _pair()
    for eng, uids in pair:
        eng.step(1)
    site = []
    for eng, _u in pair:
        site.append(eng.spawn_batch(np.array([[120.0, 300.0]], np.float32),
                                    radius=6.0, flags=STATIC,
                                    max_speed=0.0)[0])

    def script(eng, u, s):
        eng.move([u[0]], (120.0, 330.0))
        flushes = eng.counters["order.batch.n"]
        eng.despawn(u[5])
        assert eng.counters["order.batch.n"] == flushes + (eng is pair[0][0])
        # planned before the stamp; the next move commits it and plans
        # around the building
        eng.move([u[1]], (130.0, 330.0))
        eng.set_structure_blocking(s, True)
        eng.move([u[2]], (140.0, 330.0))
        eng.stop([u[3]])

    for (eng, uids), s in zip(pair, site):
        with eng.order_batch("test.order"):
            script(eng, uids, s)
    (a, _ua), (b, _ub) = pair
    _assert_same(a, b)
    assert a.counters["order.batch.n"] == 3
    assert a.counters["nav.commit.n"] == b.counters["nav.commit.n"] == 1
    assert a.nav.flock_chunks == b.nav.flock_chunks


def test_batch_reclaims_a_full_flock_table():
    pair = _pair(max_flocks=4)
    goals = [(60.0 + 50 * i, 420.0) for i in range(6)]
    for eng, u in pair:
        for i in range(4):
            eng.move([u[i]], goals[i])      # the table is full

    def script(eng, u):
        for i in range(3):
            eng.stop([u[i]])
        for i in range(3):
            eng.move([u[i]], goals[i + 2])
        eng.stop([u[0]])
        eng.move([u[0]], goals[5])
        eng.stop([u[3]])
        eng.move([u[4]], goals[1])

    _both(pair, script)
    (a, _ua), (b, _ub) = pair
    _assert_same(a, b)
    assert a.counters["flocks.reclaims"] == b.counters["flocks.reclaims"] == 3
    assert a.counters["order.batch.n"] == 1


def test_stray_chunk_fields_keep_the_slab_order_of_one_by_one():
    """A unit standing in the wall starts its path from the nearest
    passable tile, across the chunk boundary, so its own chunk needs a
    field beyond its plan. Given one by one, that field takes its slab
    slot before the next order's plan does; in a batch too, so in a
    three-slot slab the same fields are evicted later."""
    pair = _pair(wall=(62, 68), field_slab_slots=3, los_slab_slots=3)
    for eng, u in pair:
        # row 64 (chunk row 1) of a wall over rows 62-67: its nearest
        # passable tile lies in row 61, chunk row 0
        eng.teleport(u[5], (130.0, 258.0))
        eng.step(1)

    def script(eng, u):
        eng.move([u[3]], (460.0, 250.0))
        eng.move([u[5]], (440.0, 60.0))
        eng.move([u[1]], (200.0, 40.0))
        eng.move([u[2]], (420.0, 440.0))

    _both(pair, script)
    (a, _ua), (b, _ub) = pair
    _assert_same(a, b)
    assert a.nav.flock_chunks == b.nav.flock_chunks
    assert list(a.nav.flow_cache.order) == list(b.nav.flow_cache.order)
    assert list(a.nav.los_cache.order) == list(b.nav.los_cache.order)


def test_move_outside_a_batch_fetches_as_before():
    """A move given alone: no batch flush, and the fetches of the order
    path before batches, counted at the commit before them: the first move
    also fetches the blockers (no snapshot yet) and builds the layer's
    portal graph; each fetches layer and pos, the start and goal
    integration and, for its two-unit ring, pos and radius."""
    eng = _engine(True)
    u = eng.spawn_batch(np.array([[40.0, 120.0], [70.0, 120.0]],
                                 np.float32), max_speed=40.0)
    fetches = []
    for goal in ((300.0, 400.0), (100.0, 60.0), (420.0, 420.0)):
        c0 = dict(eng.counters)
        assert eng.move(u, goal)
        fetches.append(_delta(eng.counters, c0, "order.fetch.n"))
        assert _delta(eng.counters, c0, "order.batch.n") == 0
        assert _delta(eng.counters, c0, "order.batch.orders") == 0
    c0 = dict(eng.counters)
    eng.stop(u)
    assert _delta(eng.counters, c0, "order.batch.n") == 0
    assert fetches == PARENT_FETCHES


# the order.fetch counts of the three moves above before batches
PARENT_FETCHES = [7.0, 5.0, 5.0]


def test_batch_size_reader_reads_the_flushes():
    """The benchmark's ``order_batch_size.match`` (``benchmark/metrics/
    order_batch_size.py``) is the orders over the flushes of a window's
    counters, and finds nothing where no batch was flushed."""
    from benchmark.spec import reader

    read = reader("order_batch_size.match")
    eng = _engine(True)
    _match(eng)
    c0 = dict(eng.counters)
    eng.step(48)
    window = {k: _delta(eng.counters, c0, k) for k in eng.counters}
    got = read({"window": {"frames": 48, "counters": window}})
    assert got == window["order.batch.orders"] / window["order.batch.n"]
    assert got > 1.0
    assert read({"window": {"frames": 48, "counters": {"order.n": 3.0}}}) \
        is None
