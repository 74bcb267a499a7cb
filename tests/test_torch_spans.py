"""The port's spans (``core/perf.py``): every ``Perf`` scope counts its
duration, its calls and its nested waits in ``Perf.counters``, reaches a
recording ``torch.profiler`` session as a ``record_function`` range on the
trace's clock, and makes no profiler call while none records. On a small
engine: an order, a step and a cadence count once each, ``step_scan``'s
segments leave the frame tree bounded, and ``prev_frame_perfstats`` still
names the frame's ``device_tick`` and ``host_systems``.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
torch.set_num_threads(1)
from torch.profiler import ProfilerActivity, profile

from permafrost_engine_tpu_torch.core.config import DiplomacyState, EngineConfig
from permafrost_engine_tpu_torch.core.perf import Perf
from permafrost_engine_tpu_torch.game.engine import Engine


def _delta(after: dict, before: dict, key: str) -> float:
    return after.get(key, 0.0) - before.get(key, 0.0)


def test_scope_adds_ms_and_n():
    p = Perf()
    for _ in range(3):
        with p.scope("x"):
            time.sleep(0.001)
    assert p.counters["x.n"] == 3
    assert p.counters["x.ms"] >= 3.0
    assert p.counters["x.wait_ms"] == 0.0


def test_wait_two_deep_adds_to_both_enclosing_scopes():
    p = Perf()
    with p.scope("outer"):
        with p.scope("inner"):
            time.sleep(0.002)
            with p.wait("w"):
                time.sleep(0.005)
                with p.wait("w2"):   # a wait in a wait counts once above
                    time.sleep(0.001)
    c = p.counters
    assert c["w.n"] == 1 and c["w2.n"] == 1
    assert c["w.wait_ms"] == c["w.ms"] >= 6.0
    assert c["w2.wait_ms"] == c["w2.ms"]
    assert c["inner.wait_ms"] == c["w.ms"]
    assert c["outer.wait_ms"] == c["w.ms"]
    assert c["inner.ms"] > c["inner.wait_ms"]


def test_unnamed_wait_takes_its_owner_name():
    p = Perf()
    with p.scope("order", owner=True):
        with p.scope("order.plan"):
            assert p.fetch(torch.arange(3)).tolist() == [0, 1, 2]
    with p.wait():
        pass
    assert p.counters["order.fetch.n"] == 1
    assert p.counters["order.plan.wait_ms"] == p.counters["order.fetch.ms"]
    assert p.counters["fetch.n"] == 1


def test_no_profiler_call_without_recording(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    p = Perf()
    with p.scope("quiet", owner=True):
        p.fetch(torch.ones(2))
    assert p.counters["quiet.n"] == 1 and p.counters["quiet.fetch.n"] == 1


def test_scope_on_the_profiler_clock():
    p = Perf()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with p.scope("span_probe"):
            torch.ones(256).cumsum(0)
    kevents = list(prof.profiler.kineto_results.events())
    events = [(e.name(), e.start_ns(), e.end_ns()) for e in kevents]
    # a host range, not a user annotation (kineto would mirror one onto
    # the device's timeline)
    assert not any(e.is_user_annotation() for e in kevents
                   if e.name() == "span_probe")
    spans = [e for e in events if e[0] == "span_probe"]
    ops = [e for e in events if e[0] == "aten::cumsum"]
    assert len(spans) == 1 and ops
    _, s0, s1 = spans[0]
    assert all(s0 <= o0 and o1 <= s1 for _, o0, o1 in ops)
    assert p.counters["span_probe.n"] == 1


def test_device_trace_json_holds_the_scope(tmp_path):
    p = Perf()
    with p.device_trace(str(tmp_path / "trace")):
        with p.scope("span_in_trace"):
            torch.ones(8).cumsum(0)
    with open(os.path.join(tmp_path, "trace", "trace.json")) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "span_in_trace" in names


# -- a small engine ----------------------------------------------------------------


def _engine():
    cfg = EngineConfig(max_ents=64, chunks_r=2, chunks_c=2, num_layers=1,
                       max_flocks=8, max_projectiles=16, field_slab_slots=16,
                       los_slab_slots=16)
    eng = Engine(cfg, device="cpu")
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(3)
    a = eng.spawn_batch((np.array([40.0, 40.0]) + rng.random((6, 2)) * 20
                         ).astype(np.float32), faction=0)
    eng.spawn_batch((np.array([200.0, 200.0]) + rng.random((6, 2)) * 20
                     ).astype(np.float32), faction=1)
    return eng, a


def test_move_counts_one_order():
    eng, a = _engine()
    c0 = dict(eng.counters)
    assert eng.move(a, (180.0, 60.0))
    c = eng.counters
    assert _delta(c, c0, "order.n") == 1
    assert _delta(c, c0, "order.plan.n") == 1
    assert _delta(c, c0, "order.plan.ms") > 0.0
    assert _delta(c, c0, "order.install.n") == 1
    assert _delta(c, c0, "order.ring.n") == 1
    assert _delta(c, c0, "order.fetch.n") >= 3
    # every wait of an order is one of its fetches
    assert _delta(c, c0, "order.wait_ms") == pytest.approx(
        _delta(c, c0, "order.fetch.ms"))


def test_step_counts_one_step_and_its_waits():
    eng, a = _engine()
    eng.step(1)
    c0 = dict(eng.counters)
    eng.step(1)
    c = eng.counters
    assert _delta(c, c0, "step.n") == 1
    assert _delta(c, c0, "step.flush.n") == 1
    assert _delta(c, c0, "device_tick.n") == 1
    assert _delta(c, c0, "host_systems.n") == 1
    assert _delta(c, c0, "step.wait_ms") >= _delta(c, c0, "step.flush.ms")


def test_cadence_counts_once_per_snapshot():
    eng, a = _engine()
    eng.step(29)
    c0 = dict(eng.counters)
    eng.step(1)                  # frame 30: the cadence takes a snapshot
    c = eng.counters
    assert _delta(c, c0, "cadence.n") == 1
    eng.step(30)                 # frame 60: and consumes the last one
    assert _delta(c, c0, "cadence.n") == 2
    assert _delta(c, c0, "cadence.fetch.n") >= 1
    assert _delta(c, c0, "cadence.wait_ms") == pytest.approx(
        _delta(c, c0, "cadence.fetch.ms"))


def test_scan_segments_leave_the_frame_tree_bounded():
    eng, a = _engine()
    eng.step(eng.seek_refresh_period)   # on a segment boundary: no step()
    frames_before = list(eng.perf._frames)
    # the tick itself is not under test: each segment leaves the state be
    eng._scan_fn = lambda state, n, acc: (state, acc)
    c0 = dict(eng.counters)
    eng.step_scan(1000 * eng.seek_refresh_period)
    c = eng.counters
    assert _delta(c, c0, "cadence.n") == 1000
    assert len(eng.perf._current) <= 16
    assert eng.perf._frames == frames_before


def test_prev_frame_perfstats_names_the_frame():
    eng, a = _engine()
    eng.step(29)
    eng.step(1)                  # a frame with the cadence
    eng.step(1)                  # archives it
    stats = eng.perf.prev_frame_perfstats()
    names = [e["name"] for e in stats]
    assert "device_tick" in names and "host_systems" in names
    host = names.index("host_systems")
    cad = names.index("cadence")
    assert stats[cad]["parent"] == host
    assert "step" not in names and "order" not in names


def test_economy_scopes_and_flock_counters():
    """A small economy run: every economy tick is the scope ``economy``
    with its three parts, each order it gives an ``economy.order`` (counted
    as ``economy.moves`` or ``economy.stops``), and so is each flush of its
    batch (``order.batch``, carrying ``order.batch.orders``); a founded
    building's commit ``nav.commit`` with its ``nav.replan``; a full flock table
    reclaims (``flocks.reclaims``) and keeps its high-water mark
    (``flocks.peak``)."""
    from permafrost_engine_tpu_torch.core.config import EntityFlags
    from permafrost_engine_tpu_torch.game.economy import (
        BuilderComp, BuildingComp, HarvesterComp, ResourceComp, StorageComp)

    cfg = EngineConfig(max_ents=32, chunks_r=1, chunks_c=1, num_layers=1,
                       max_flocks=4, max_projectiles=8, field_slab_slots=16,
                       los_slab_slots=16)
    eng = Engine(cfg, device="cpu")
    eng.add_faction(0)
    eco = eng.economy
    static = int(EntityFlags.COLLISION | EntityFlags.SELECTABLE)
    store = eng.spawn_batch(np.array([[60.0, 60.0]], np.float32), radius=3.0,
                            flags=static, max_speed=0.0)[0]
    eco.storages[store] = StorageComp(capacity={"gold": 100})
    for u in eng.spawn_batch(np.array([[80.0, 60.0], [60.0, 84.0]],
                                      np.float32), radius=2.0, flags=static,
                             max_speed=0.0):
        eco.resources[u] = ResourceComp("gold", 100, 100)
    for u in eng.spawn_batch(np.array([[66.0, 62.0], [64.0, 70.0],
                                       [68.0, 66.0], [62.0, 66.0]],
                                      np.float32), max_speed=20.0):
        eco.harvesters[u] = HarvesterComp(gather_speeds={"gold": 1},
                                          max_carry={"gold": 2})
    site = eng.spawn_batch(np.array([[100.0, 100.0]], np.float32),
                           radius=4.0, flags=static, max_speed=0.0)[0]
    builder = eng.spawn_batch(np.array([[90.0, 96.0]], np.float32),
                              max_speed=20.0)[0]
    eco.buildings[site] = BuildingComp(required={"gold": 1})
    eco.builders[builder] = BuilderComp()
    eco.build(builder, site)
    c0 = dict(eng.counters)
    for _ in range(240):
        eng.step(1)
        if eco.builders[builder].building and site not in eng._structures:
            eco.found_building(site)
            eco.supply_building(site, "gold", 1)
    c = eng.counters
    ticks = _delta(c, c0, "economy.n")
    assert ticks == 20
    for part in ("harvest", "build", "automation"):
        assert _delta(c, c0, f"economy.{part}.n") == ticks
    assert _delta(c, c0, "economy.moves") >= 4
    assert _delta(c, c0, "economy.stops") >= 4
    # the orders of a tick are one batch: each order, and each flush of it,
    # is one economy.order
    orders = _delta(c, c0, "economy.moves") + _delta(c, c0, "economy.stops")
    flushes = _delta(c, c0, "order.batch.n")
    assert 1 <= flushes <= ticks
    assert _delta(c, c0, "economy.order.n") == orders + flushes
    assert _delta(c, c0, "order.batch.orders") == orders
    assert _delta(c, c0, "economy.ms") > _delta(c, c0, "economy.order.ms")
    assert _delta(c, c0, "nav.commit.n") == 1
    assert _delta(c, c0, "nav.replan.n") == 1
    assert c["flocks.reclaims"] >= 1
    assert 1 <= c["flocks.peak"] <= cfg.max_flocks
