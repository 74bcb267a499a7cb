"""The port's CUDA graph segments (``game/graphs.py``) against per-frame
stepping, within the port.

Each test runs on the CPU here, where a segment's ticks run in turn (the
same engine code minus the capture), and on the card (``cuda``), where each
fused segment is a CUDA graph replay; the ``cuda`` cases skip without a
CUDA device. This file imports nothing of JAX, so on a machine with a card
it runs alone: ``python -m pytest --noconftest tests/test_torch_graphs.py``.

* An order between two fused segments changes the next segment exactly as
  it does per frame (the order rebinds state leaves the graphs read).
* A skinned battle at war, micro-batched, is bit-equal to per-frame
  stepping: positions, velocities, hp, palettes and events; K1's launch
  count (replays add what their capture recorded) is the same.
* A tick that synchronizes with the host cannot be captured, and the
  segment raises instead of stepping eagerly.
* Segments are keyed by the substeps their frames fire: the 60 one-frame
  residues of the cadence period take 7 graphs at the defaults (one per
  distinct gate tuple), and 30- and 300-frame segments as many as the
  frame modulo the period tells apart.
* ``step(1)`` with ``micro_batching`` is a one-frame segment of the scan
  stepper (``tick.graph_frames``), without it an eager tick
  (``tick.eager_frames``); 90 single frames with an order and a stop
  between them, and a skinned battle stepped frame by frame, are bit-equal
  either way, with at most 7 captures on the card.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu_torch.core.config import (
    COST_IMPASSABLE,
    DiplomacyState,
    EngineConfig,
    FIELD_RES,
)
from permafrost_engine_tpu_torch.game.engine import Engine
from permafrost_engine_tpu_torch.core.config import FRAME_HZ
from permafrost_engine_tpu_torch.core.sched import Sleep
from permafrost_engine_tpu_torch.game.graphs import TickGraphs
from permafrost_engine_tpu_torch.game.step import cadence_period, make_tick
from permafrost_engine_tpu_torch.ops import crowd_cuda
from permafrost_engine_tpu_torch.ops.skin import make_procedural_bank
from permafrost_engine_tpu_torch.state.schema import empty_deltas

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(name: str) -> str:
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs)")
    return name


def _walled(micro: bool, device: str):
    """tests/test_micro_step.py's scene: 8 units ordered across a wall."""
    cfg = EngineConfig(max_ents=64, chunks_r=2, chunks_c=2, num_layers=1,
                       max_flocks=8, max_projectiles=32, field_slab_slots=16,
                       los_slab_slots=16)
    cost = np.ones((cfg.num_layers, cfg.field_h, cfg.field_w), np.uint8)
    cost[:, FIELD_RES - 1:FIELD_RES + 1, 8:] = COST_IMPASSABLE
    eng = Engine(cfg, device=device, cost_base=cost)
    eng.micro_batching = micro
    rng = np.random.default_rng(0)
    pos = (np.array([400.0, 100.0]) + rng.random((8, 2)) * 30).astype(
        np.float32)
    uids = eng.spawn_batch(pos, faction=0, max_speed=80.0)
    assert eng.move(uids, (400.0, 400.0))
    return eng, uids


@pytest.mark.parametrize("device", DEVICES)
def test_order_between_segments_like_per_frame(device):
    """A move order and a stop between fused segments change the next
    segments exactly as they do per frame: equal positions, velocities,
    move states, destinations and events, bit for bit."""
    device = _device(device)
    runs = []
    for micro in (False, True):
        eng, uids = _walled(micro, device)
        eng.step(12)
        assert eng.move(uids[:4], (100.0, 400.0))
        eng.step(30)
        eng.stop(uids[4:])
        eng.step_scan(24)
        runs.append(eng)
    a, b = runs
    for name in ("pos", "vel", "movestate", "dest"):
        assert torch.equal(getattr(a.state.ents, name),
                           getattr(b.state.ents, name)), name
    assert a.events == b.events
    if device == "cuda":
        assert b._scan_fn.stats["replays"] > 0


def _skinned_war(micro: bool, device: str):
    cfg = EngineConfig(max_ents=96, chunks_r=1, chunks_c=2, num_layers=2,
                       max_flocks=8, max_projectiles=64, field_slab_slots=16,
                       los_slab_slots=16, skin_joints=16)
    eng = Engine(cfg, device=device)
    eng.micro_batching = micro
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(11)
    for f, x0, goal in ((0, 60.0, (300.0, 120.0)), (1, 330.0, (40.0, 120.0))):
        u = eng.spawn_batch(
            (np.array([x0, 100.0]) + rng.random((24, 2)) * 40).astype(np.float32),
            faction=f, max_speed=30.0, is_ranged=rng.random(24) < 0.3,
            attack_range=np.where(rng.random(24) < 0.3, 30.0, 5.0))
        assert eng.move(u, goal)
    return eng


@pytest.mark.parametrize("device", DEVICES)
def test_skinned_war_graphed_equals_per_frame(device):
    device = _device(device)
    runs = []
    for micro in (False, True):
        crowd_cuda.launches = 0
        eng = _skinned_war(micro, device)
        eng.step(90)
        eng.step_scan(120)
        eng.step(61)
        runs.append((eng, crowd_cuda.launches))
    (a, ka), (b, kb) = runs
    for name in ("pos", "vel", "hp", "combatstate"):
        assert torch.equal(getattr(a.state.ents, name),
                           getattr(b.state.ents, name)), name
    for name in ("palettes", "clip", "start", "tick"):
        assert torch.equal(getattr(a.state.anim, name),
                           getattr(b.state.anim, name)), name
    assert int(b.state.anim.tick) == b.state.tick == 271
    assert a.events == b.events
    assert any(k == "attack_start" for k, _ in a.events)
    assert ka == kb
    if device == "cuda":
        assert ka == b.state.tick // 3
        assert b._scan_fn.stats["replays"] > 0


@pytest.mark.parametrize("device", DEVICES)
def test_capture_failure_raises(device):
    """A tick that reads a device value on the host cannot be captured: the
    segment raises (on the CPU it simply runs)."""
    device = _device(device)
    eng, _ = _walled(True, device)

    def syncing_tick(state, acc):
        state.tick += int(state.ents.alive.sum() > 0)
        return state, acc

    syncing_tick.gates = lambda t: ()

    graphs = TickGraphs(syncing_tick, 60,
                        lambda dev: empty_deltas(eng.cfg, device=dev))
    if device == "cpu":
        state, _ = graphs(eng.state, 6)
        assert state.tick == 6
        return
    with pytest.raises(RuntimeError):
        graphs(eng.state, 6)


def _graphs_of(cfg: EngineConfig, skins: bool = False) -> TickGraphs:
    bank = (make_procedural_bank(cfg.skin_joints, device="cpu")
            if skins else None)
    return TickGraphs(make_tick(cfg, skin_bank=bank), cadence_period(cfg),
                      lambda dev: empty_deltas(cfg, device=dev))


def _gate_tuples(cfg: EngineConfig, skins: bool) -> set:
    """The distinct substep sets over the cadence period, from the rates."""
    periods = [FRAME_HZ // cfg.move_hz, FRAME_HZ // cfg.combat_hz, 2,
               FRAME_HZ, max(FRAME_HZ // cfg.fog_hz, 1)]
    if skins:
        periods.append(max(FRAME_HZ // cfg.skin_hz, 1))
    return {tuple(t % p == 0 for p in periods)
            for t in range(1, cadence_period(cfg) + 1)}


@pytest.mark.parametrize("rates,skins,want", [
    ({}, False, 7),
    ({"skin_joints": 16}, True, 7),
    ({"skin_joints": 16, "skin_hz": 30}, True, None),
    ({"move_hz": 30, "fog_hz": 10}, False, None),
    ({"move_hz": 10, "combat_hz": 5, "fog_hz": 4}, False, None),
], ids=["defaults", "skinned", "skin_30hz", "move30_fog10",
        "move10_combat5_fog4"])
def test_one_frame_segments_take_one_key_per_gate_tuple(rates, skins, want):
    """The cadence period's one-frame segments map to exactly as many keys
    as the tick has distinct substep sets: 7 at the defaults."""
    cfg = EngineConfig(max_ents=64, chunks_r=1, chunks_c=1, **rates)
    graphs = _graphs_of(cfg, skins)
    period = cadence_period(cfg)
    keys = {graphs.key(1, t) for t in range(period)}
    assert len(keys) == len(_gate_tuples(cfg, skins))
    if want is not None:
        assert len(keys) == want
    # the key repeats with the period
    assert all(graphs.key(1, t + period) == graphs.key(1, t)
               for t in range(period))


@pytest.mark.parametrize("n", [30, 300])
@pytest.mark.parametrize("skins", [False, True], ids=["flat", "skinned"])
def test_long_segment_keys_as_distinct_as_the_frame_residue(n, skins):
    """30- and 300-frame segments from the period's residues take as many
    keys as (n, first frame modulo the period) did; segments on the frames
    a scan window starts at (multiples of 30) keep one key each."""
    cfg = EngineConfig(max_ents=64, chunks_r=1, chunks_c=1,
                       skin_joints=16 if skins else 0)
    graphs = _graphs_of(cfg, skins)
    period = cadence_period(cfg)
    keys = [graphs.key(n, t) for t in range(period)]
    assert len(set(keys)) == period
    assert len({graphs.key(n, t) for t in range(0, 10 * period, 30)}) == 2


def _spy(eng) -> list:
    """Record the frames of every call of `eng`'s segment stepper."""
    calls, real = [], eng._scan_fn

    def spy(state, n, acc=None):
        calls.append(n)
        return real(state, n, acc)

    eng._scan_fn = spy
    return calls


@pytest.mark.parametrize("micro", [True, False], ids=["micro", "eager"])
def test_one_frame_step_goes_through_the_segment_stepper(micro):
    """With ``micro_batching`` each ``step(1)`` is a one-frame segment of
    the scan stepper and counts in ``tick.graph_frames``; without it the
    stepper is not called and each frame counts in ``tick.eager_frames``.
    A fused call counts its frames the same way."""
    eng, _ = _walled(micro, "cpu")
    calls = _spy(eng)
    for _ in range(5):
        eng.step(1)
    eng.step(25)               # fused segments to frame 30 with micro
    c = eng.counters
    if micro:
        assert calls[:5] == [1] * 5 and sum(calls) == 30
        assert max(calls) > 1
        assert c["tick.graph_frames"] == 30
        assert c.get("tick.eager_frames", 0) == 0
    else:
        assert calls == []
        assert c["tick.eager_frames"] == 30
        assert c.get("tick.graph_frames", 0) == 0
    assert eng.state.tick == 30


def test_live_task_steps_one_frame_segments():
    """A live task forces frame-by-frame stepping, and with
    ``micro_batching`` each of those frames is a one-frame segment."""
    eng, _ = _walled(True, "cpu")

    def waiter(task):
        yield Sleep(40)

    eng.sched.create(waiter)
    calls = _spy(eng)
    eng.step(20)
    assert calls == [1] * 20
    assert eng.counters["tick.graph_frames"] == 20


@pytest.mark.parametrize("device", DEVICES)
def test_single_frames_graphed_equal_eager(device):
    """90 single ``step(1)`` calls, a move order after 12 and a stop after
    50, micro-batched (one-frame graph replays on the card) against
    ``micro_batching = False``: equal positions, velocities, move states,
    events and K1 launches, bit for bit; on the card at most 7 captures."""
    device = _device(device)
    runs = []
    for micro in (False, True):
        crowd_cuda.launches = 0
        eng, uids = _walled(micro, device)
        for f in range(90):
            if f == 12:
                assert eng.move(uids[:4], (100.0, 400.0))
            if f == 50:
                eng.stop(uids[4:])
            eng.step(1)
        runs.append((eng, crowd_cuda.launches))
    (a, ka), (b, kb) = runs
    for name in ("pos", "vel", "movestate", "dest"):
        assert torch.equal(getattr(a.state.ents, name),
                           getattr(b.state.ents, name)), name
    assert a.events == b.events
    assert ka == kb
    assert a.counters["tick.eager_frames"] == 90
    assert b.counters["tick.graph_frames"] == 90
    if device == "cuda":
        assert ka == 90 // 3
        stats = b._scan_fn.stats
        assert 0 < stats["captures"] <= 7
        assert stats["replays"] == 90


@pytest.mark.parametrize("device", DEVICES)
def test_skinned_war_single_frames_graphed_equal_eager(device):
    """The skinned battle at war stepped by 90 ``step(1)`` calls: one-frame
    segments against eager ticks, bit for bit (positions, velocities, hp,
    palettes, the device frame, events, K1 launches)."""
    device = _device(device)
    runs = []
    for micro in (False, True):
        crowd_cuda.launches = 0
        eng = _skinned_war(micro, device)
        for _ in range(90):
            eng.step(1)
        runs.append((eng, crowd_cuda.launches))
    (a, ka), (b, kb) = runs
    for name in ("pos", "vel", "hp", "combatstate"):
        assert torch.equal(getattr(a.state.ents, name),
                           getattr(b.state.ents, name)), name
    for name in ("palettes", "tick"):
        assert torch.equal(getattr(a.state.anim, name),
                           getattr(b.state.anim, name)), name
    assert a.events == b.events
    assert ka == kb
    if device == "cuda":
        assert b._scan_fn.stats["captures"] <= 7
