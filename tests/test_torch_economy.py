"""PyTorch port vs the JAX package: the economy and its host systems.

The 16 scenarios of ``tests/test_economy.py`` (harvest cycle, ``step_scan``
against ``step``, automation, the building lifecycle, garrison and evict,
population, regions, the transport mission, the surround command, the
transport strategies, ``do_not_take``, cost-ranked automation, and no dead
economy fields) run as parametrised cases on the JAX engine and on the
port's (on the CPU), each scenario the same script for both with the
original test's assertions. Held equal between the engines, exactly: the
economy's host state (every component table and the transport counts), the
engine's event log, every handler call of the economy's bus events with the
frame it came at, the frame counter and the device tick. Positions agree
within 1e-3 world units, as the port's other engine parity tests
(``tests/test_torch_war.py``).

One more case adds a scheduler task that pauses the game for 5 frames
mid-harvest: both engines step frame by frame while it lives (the task
wakes on consecutive frames), the tick stops while paused, and the frame
count holds.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core import sched as jsched
from permafrost_engine_tpu.game import economy as jeco
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu_torch.core import sched as tsched
from permafrost_engine_tpu_torch.core.config import (EngineConfig as TorchConfig,
                                                     EntityFlags, SimState)
from permafrost_engine_tpu_torch.core.events import EventType
from permafrost_engine_tpu_torch.game import economy as teco
from permafrost_engine_tpu_torch.game.engine import Engine
from test_engine_move import small_cfg

POS_ATOL = 1e-3

# the bus events the economy, regions, garrisons, tasks and moves post
_EVENTS = (EventType.MOTION_START, EventType.MOTION_END,
           EventType.RESOURCE_EXHAUSTED, EventType.BUILDING_FOUNDED,
           EventType.BUILDING_COMPLETED, EventType.GARRISON_ENTERED,
           EventType.GARRISON_EXITED, EventType.REGION_ENTERED,
           EventType.REGION_EXITED, EventType.TRANSPORT_TARGET_ACQUIRED,
           EventType.RESOURCE_PICKED_UP, EventType.SCRIPT_TASK_FINISHED)


class Side:
    """One engine kind: its Engine and economy and scheduler modules."""

    def __init__(self, kind: str):
        self.kind = kind
        self.eco = jeco if kind == "jax" else teco
        self.sched = jsched if kind == "jax" else tsched
        self.engines = []

    def engine(self, economy_period: int | None = 3):
        cfg = small_cfg()
        eng = (JaxEngine(cfg) if self.kind == "jax" else
               Engine(TorchConfig(**dataclasses.asdict(cfg)), device="cpu"))
        if economy_period is not None:
            eng.economy_period = economy_period
        eng._calls = []
        for ev in _EVENTS:
            eng.bus.subscribe(int(ev), lambda a, e=ev, g=eng: g._calls.append(
                (g._frame, int(e), a)))
        self.engines.append(eng)
        return eng

    def spawn(self, eng, at, **kw):
        return eng.spawn_batch(np.array([at], np.float32), **kw)[0]

    def eng_with(self, *, harvester_at=None, resource_at=None,
                 storage_at=None):
        """tests/test_economy.py's eng_with."""
        eng = self.engine()
        eco = self.eco
        out = [eng]
        if harvester_at is not None:
            h = self.spawn(eng, harvester_at, max_speed=120.0)
            eng.economy.harvesters[h] = eco.HarvesterComp(
                gather_speeds={"Wood": 5}, max_carry={"Wood": 10})
            out.append(h)
        if resource_at is not None:
            r = self.spawn(eng, resource_at, flags=int(EntityFlags.RESOURCE))
            eng.economy.resources[r] = eco.ResourceComp("Wood", 30, 30)
            out.append(r)
        if storage_at is not None:
            s = self.spawn(eng, storage_at,
                           flags=int(EntityFlags.STORAGE_SITE))
            eng.economy.storages[s] = eco.StorageComp(capacity={"Wood": 100})
            out.append(s)
        return out

    def storage(self, eng, at, *, cap=100, stored=0, desired=0, name="Wood"):
        s = self.spawn(eng, at, flags=int(EntityFlags.STORAGE_SITE))
        eng.economy.storages[s] = self.eco.StorageComp(
            capacity={name: cap}, stored={name: stored} if stored else {},
            desired={name: desired} if desired else {})
        return s

    def transporter(self, eng, at):
        h = self.spawn(eng, at, max_speed=120.0)
        eng.economy.harvesters[h] = self.eco.HarvesterComp(
            max_carry={"Wood": 10}, automated=False)
        return h


def _run_until(eng, pred, steps=200):
    for _ in range(steps):
        eng.step(6)
        if pred():
            return True
    return False


def _wood(eng, s):
    return eng.economy.storages[s].stored.get("Wood", 0)


# -- the scenarios of tests/test_economy.py ------------------------------------


def sc_full_harvest_cycle(S):
    eng, h, r, s = S.eng_with(harvester_at=(100.0, 100.0),
                              resource_at=(140.0, 100.0),
                              storage_at=(100.0, 140.0))
    eng.economy.gather(h, r)
    _run_until(eng, lambda: _wood(eng, s) >= 20, 100)
    assert _wood(eng, s) >= 20
    assert eng.economy.stored_of(0, "Wood") == _wood(eng, s)
    assert eng.economy.capacity_of(0, "Wood") == 100


def sc_step_scan_matches_step(S):
    def run(stepper):
        eng, h, r, s = S.eng_with(harvester_at=(100.0, 100.0),
                                  resource_at=(140.0, 100.0),
                                  storage_at=(100.0, 140.0))
        eng.economy.gather(h, r)
        stepper(eng)
        return _wood(eng, s), np.array(eng.state.ents.pos)

    a_stored, a_pos = run(lambda e: [e.step(6) for _ in range(60)])
    b_stored, b_pos = run(lambda e: e.step_scan(360))
    assert a_stored == b_stored and a_stored > 0
    np.testing.assert_array_equal(a_pos, b_pos)


def sc_automation_assigns_idle(S):
    eng, h, r, s = S.eng_with(harvester_at=(100.0, 100.0),
                              resource_at=(130.0, 100.0),
                              storage_at=(100.0, 130.0))
    hc = eng.economy.harvesters[h]
    assert _run_until(eng, lambda: hc.state != S.eco.HarvesterState.IDLE, 60)


def sc_building_lifecycle(S):
    eng = S.engine()
    b = S.spawn(eng, (120.0, 120.0), flags=int(EntityFlags.BUILDING),
                hp=400.0)
    eng.economy.buildings[b] = S.eco.BuildingComp(required={"Wood": 20})
    w = S.spawn(eng, (100.0, 100.0), max_speed=120.0)
    eng.economy.builders[w] = S.eco.BuilderComp(build_speed=0.25)
    eng.economy.found_building(b)
    assert eng.economy.supply_building(b, "Wood", 50) == 20
    eng.economy.build(w, b)
    done = S.eco.BuildingState.COMPLETED
    assert _run_until(eng, lambda: eng.economy.buildings[b].state == done, 80)
    assert float(np.asarray(eng.state.ents.hp)[eng.uid_to_slot[b]]) == 400.0


def sc_garrison_and_evict(S):
    eng = S.engine()
    holder = S.spawn(eng, (150.0, 150.0), flags=int(EntityFlags.GARRISONABLE))
    eng.economy.garrisons[holder] = S.eco.GarrisonComp(capacity=2)
    u = S.spawn(eng, (149.0, 149.0))
    assert eng.economy.garrison(u, holder)
    flags = int(np.asarray(eng.state.ents.flags)[eng.uid_to_slot[u]])
    assert flags & int(EntityFlags.GARRISONED)
    eng.step(30)
    assert eng.economy.evict(holder) == [u]
    flags = int(np.asarray(eng.state.ents.flags)[eng.uid_to_slot[u]])
    assert not flags & int(EntityFlags.GARRISONED)


def sc_population_counts(S):
    eng = S.engine(economy_period=None)
    u1 = S.spawn(eng, (10.0, 10.0), faction=2)
    u2 = S.spawn(eng, (12.0, 10.0), faction=2)
    house = S.spawn(eng, (20.0, 20.0), faction=2)
    pop = eng.economy.population
    pop[u1] = S.eco.PopulationComp(cost=1)
    pop[u2] = S.eco.PopulationComp(cost=2)
    pop[house] = S.eco.PopulationComp(cost=0, provides=10)
    eng._counts = (eng.economy.population_of(2),
                   eng.economy.population_limit_of(2),
                   eng.economy.population_of(1))
    assert eng._counts == (3, 10, 0)


def sc_region_enter_exit(S):
    eng = S.engine()
    eng.regions.add_circle("zone", (200.0, 200.0), 25.0)
    u = S.spawn(eng, (100.0, 200.0), max_speed=120.0)
    eng.move([u], (200.0, 200.0))

    def got(ev):
        return [a for _, e, a in eng._calls if e == int(ev)]

    assert _run_until(eng, lambda: got(EventType.REGION_ENTERED), 60)
    assert got(EventType.REGION_ENTERED)[0] == {"region": "zone", "uid": u}
    assert eng.regions.ents_in("zone") == [u]
    eng.move([u], (100.0, 200.0))
    eng.step(240)
    assert {"region": "zone", "uid": u} in got(EventType.REGION_EXITED)


def sc_transport_mission(S):
    eng = S.engine()
    tr = S.spawn(eng, (100.0, 100.0), max_speed=120.0,
                 flags=int(EntityFlags.MOVABLE | EntityFlags.GARRISONABLE))
    eng.economy.garrisons[tr] = S.eco.GarrisonComp(capacity=4)
    units = eng.spawn_batch(np.array([[104.0, 100.0], [100.0, 104.0]],
                                     np.float32), max_speed=120.0)
    eng.economy.transport(tr, units, (300.0, 300.0))
    assert _run_until(eng, lambda: not eng.economy.garrisons[tr].held and (
        np.linalg.norm(eng.pos_of(units[0]) - np.asarray([300.0, 300.0]))
        < 30.0), 120)
    for u in units:
        flags = int(np.asarray(eng.state.ents.flags)[eng.uid_to_slot[u]])
        assert not flags & int(EntityFlags.GARRISONED)


def sc_surround_command(S):
    eng = S.engine(economy_period=None)
    target = S.spawn(eng, (300.0, 300.0))
    pack = eng.spawn_batch(np.array([[80.0, 80.0], [90.0, 80.0],
                                     [80.0, 90.0]], np.float32),
                           max_speed=120.0)
    assert eng.surround(pack, target)
    assert _run_until(eng, lambda: max(
        np.linalg.norm(eng.pos_of(u) - eng.pos_of(target)) for u in pack)
        < 25.0, 100)


def sc_transport_nearest(S):
    eng = S.engine()
    h = S.transporter(eng, (100.0, 100.0))
    near = S.storage(eng, (110.0, 100.0), stored=10, desired=10)
    S.storage(eng, (200.0, 100.0), stored=50, desired=0)
    dest = S.storage(eng, (100.0, 130.0), desired=10)
    assert eng.economy.transport_resources(h, dest)
    assert eng.economy.harvesters[h].transport_src == near
    assert _run_until(eng, lambda: _wood(eng, dest) >= 10)
    assert _wood(eng, near) == 0


def sc_transport_excess(S):
    eng = S.engine()
    h = S.transporter(eng, (100.0, 100.0))
    eng.economy.harvesters[h].strategy = S.eco.GatherStrategy.EXCESS
    near = S.storage(eng, (110.0, 100.0), stored=10, desired=10)
    far = S.storage(eng, (200.0, 100.0), stored=50, desired=44)
    dest = S.storage(eng, (100.0, 130.0), desired=10)
    assert eng.economy.transport_resources(h, dest)
    assert eng.economy.harvesters[h].transport_src == far
    assert _run_until(eng, lambda: _wood(eng, dest) >= 6)
    assert _wood(eng, far) == 44
    assert _run_until(eng, lambda: _wood(eng, dest) >= 10)
    assert (_wood(eng, far), _wood(eng, near)) == (44, 6)


def sc_transport_excess_fallback(S):
    eng = S.engine()
    h = S.transporter(eng, (100.0, 100.0))
    eng.economy.harvesters[h].strategy = S.eco.GatherStrategy.EXCESS
    near = S.storage(eng, (110.0, 100.0), stored=8, desired=10)
    dest = S.storage(eng, (100.0, 130.0), desired=10)
    assert eng.economy.transport_resources(h, dest)
    assert _run_until(eng, lambda: _wood(eng, dest) >= 8)
    assert _wood(eng, near) == 0


def sc_transport_gathering(S):
    eng = S.engine()
    h = S.transporter(eng, (100.0, 100.0))
    hc = eng.economy.harvesters[h]
    hc.strategy = S.eco.GatherStrategy.GATHERING
    hc.gather_speeds["Wood"] = 5
    src = S.storage(eng, (110.0, 100.0), stored=50, desired=0)
    r = S.spawn(eng, (140.0, 100.0), flags=int(EntityFlags.RESOURCE))
    eng.economy.resources[r] = S.eco.ResourceComp("Wood", 30, 30)
    dest = S.storage(eng, (100.0, 130.0), desired=10)
    assert eng.economy.transport_resources(h, dest)
    assert hc.state == S.eco.HarvesterState.TO_RESOURCE
    assert _run_until(eng, lambda: _wood(eng, dest) >= 10)
    assert _wood(eng, src) == 50


def sc_do_not_take(S):
    eng = S.engine()
    h = S.transporter(eng, (100.0, 100.0))
    near = S.storage(eng, (110.0, 100.0), stored=50)
    far = S.storage(eng, (200.0, 100.0), stored=50)
    dest = S.storage(eng, (100.0, 130.0), desired=10)
    eng.economy.storages[near].do_not_take.add("Wood")
    assert eng.economy.transport_resources(h, dest)
    assert eng.economy.harvesters[h].transport_src == far
    eng2 = S.engine(economy_period=None)
    h2 = S.transporter(eng2, (100.0, 100.0))
    near2 = S.storage(eng2, (110.0, 100.0), stored=50)
    far2 = S.storage(eng2, (200.0, 100.0), stored=50)
    dest2 = S.storage(eng2, (100.0, 130.0), desired=10)
    eng2.economy.storages[near2].do_not_take_land = True
    assert eng2.economy.transport_resources(h2, dest2)
    assert eng2.economy.harvesters[h2].transport_src == far2


def sc_transport_automation(S):
    eng = S.engine()
    h1 = S.transporter(eng, (100.0, 100.0))
    h2 = S.transporter(eng, (102.0, 100.0))
    for h in (h1, h2):
        eng.economy.harvesters[h].transport_automated = True
    S.storage(eng, (130.0, 100.0), stored=100)
    a = S.storage(eng, (100.0, 140.0), desired=10)
    b = S.storage(eng, (104.0, 140.0), desired=10)
    eng.step(6)
    assert {eng.economy.harvesters[h].transport_dest
            for h in (h1, h2)} == {a, b}


def sc_no_dead_fields(S):
    eng = S.engine(economy_period=None)
    src = inspect.getsource(S.eco)
    body = src[src.index("class Economy"):]
    eng._counts = [needle in body for needle in (
        "GatherStrategy.EXCESS", "GatherStrategy.GATHERING", ".desired",
        "do_not_take", "transport_automated")]
    assert all(eng._counts)


def sc_task_and_pause(S):
    """A task pauses the game for 5 frames mid-harvest: frame-by-frame
    stepping while it lives, no tick while paused, the frame count kept."""
    eng, h, r, s = S.eng_with(harvester_at=(100.0, 100.0),
                              resource_at=(140.0, 100.0),
                              storage_at=(100.0, 140.0))
    eng.economy.gather(h, r)
    wakes = eng._wakes = []

    def body(task):
        for _ in range(6):
            wakes.append((eng._frame, int(np.asarray(eng.state.tick))))
            yield S.sched.Sleep(1)
        eng.sim_state = SimState.PAUSED_FULL
        yield S.sched.Sleep(5)
        eng.sim_state = SimState.RUNNING

    eng.sched.create(body)
    eng.step(60)
    eng.step_scan(60)
    assert [f for f, _ in wakes] == [1, 2, 3, 4, 5, 6]
    assert eng._frame == 120
    assert int(np.asarray(eng.state.tick)) == 115
    assert not eng.sched.tasks


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_full_harvest_cycle, sc_step_scan_matches_step,
    sc_automation_assigns_idle, sc_building_lifecycle, sc_garrison_and_evict,
    sc_population_counts, sc_region_enter_exit, sc_transport_mission,
    sc_surround_command, sc_transport_nearest, sc_transport_excess,
    sc_transport_excess_fallback, sc_transport_gathering, sc_do_not_take,
    sc_transport_automation, sc_no_dead_fields, sc_task_and_pause)}


def _comps(table: dict) -> dict:
    return {u: dataclasses.asdict(c) for u, c in table.items()}


def _record(eng) -> dict:
    """Everything the two engines must agree on exactly, and positions."""
    eco = eng.economy
    return dict(
        tables={name: _comps(getattr(eco, name)) for name in (
            "resources", "harvesters", "storages", "buildings", "builders",
            "garrisons", "population")},
        assigned=dict(eco._transport_assigned),
        events=list(eng.events), calls=list(eng._calls), frame=eng._frame,
        tick=int(np.asarray(eng.state.tick)),
        regions={n: sorted(r.members) for n, r in eng.regions.regions.items()},
        flags=np.array(eng.state.ents.flags).view(np.uint32),
        alive=np.array(eng.state.ents.alive),
        extra=(getattr(eng, "_counts", None), getattr(eng, "_wakes", None)),
        pos=np.array(eng.state.ents.pos))


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_economy_scenario_matches_jax(name):
    recs = []
    for kind in ("jax", "port"):
        side = Side(kind)
        SCENARIOS[name](side)
        recs.append([_record(e) for e in side.engines])
    jrecs, trecs = recs
    assert len(jrecs) == len(trecs)
    for j, t in zip(jrecs, trecs):
        jpos, tpos = j.pop("pos"), t.pop("pos")
        np.testing.assert_allclose(tpos, jpos, atol=POS_ATOL)
        for key in ("flags", "alive"):
            np.testing.assert_array_equal(t.pop(key), j.pop(key), err_msg=key)
        for key in j:
            assert t[key] == j[key], key
