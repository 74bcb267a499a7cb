"""PyTorch port vs the JAX package: micro-batched stepping, ``step_scan``
and the one-window drain lag.

* ``tests/test_micro_step.py``'s scene: ``step`` fused into cadence
  segments is bit-identical to per-frame stepping within the port (state
  and events, at 75 frames), and matches the JAX engine (equal events;
  positions within 1e-3 u, as the port's other engine parity tests);
  handlers fire with the same payloads in the same order while events flow;
  ``_fusible_frames`` equals the JAX engine's at the same frames.
  ``tests/test_micro_step.py``'s task and pause scenes wait for the port of
  the scheduler and of the pause state.
* The drain lag: on ``tests/test_torch_structures.py``'s building-corpse
  scene, one ``step(306)`` and one ``step_scan(306)`` call drain the same
  events at the same frames as the JAX engine (attack start at frame 12,
  death at 18, the building's removal and unstamp at 186).
* ``step_scan`` with no live host system (one segment) matches the JAX
  engine.
* The tick is capturable: over the 60 frames of the cadence period (every
  substep, the height-aware fog and skinning), no op synchronizes with the
  host (``.item()``, ``nonzero``, boolean indexing, ...) and no tensor
  enters an op that was not made by an op or before the tick (a host copy
  such as ``torch.from_numpy(...).to(device)``).
"""

import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch
torch.set_num_threads(1)
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _disable_current_modes,
)
from torch.utils._pytree import tree_flatten

from permafrost_engine_tpu.core.config import (
    DiplomacyState,
    EngineConfig,
    EntityFlags,
)
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig
from permafrost_engine_tpu_torch.game import step as step_mod
from permafrost_engine_tpu_torch.game.engine import Engine
from permafrost_engine_tpu_torch.game.step import cadence_period, make_tick_scan
from permafrost_engine_tpu_torch.ops.skin import make_procedural_bank
from test_dynamic_nav import BUILDING_FLAGS
from test_micro_step import small_cfg, walled_cost


def _tcfg(cfg):
    return TorchConfig(**dataclasses.asdict(cfg))


def _build(kind: str, micro: bool):
    """tests/test_micro_step.py's scene: 8 units ordered across a wall."""
    cfg = small_cfg()
    if kind == "jax":
        eng = JaxEngine(cfg, cost_base=walled_cost(cfg))
    else:
        eng = Engine(_tcfg(cfg), device="cpu", cost_base=walled_cost(cfg))
    eng.micro_batching = micro
    rng = np.random.default_rng(0)
    pos = (np.array([400.0, 100.0]) + rng.random((8, 2)) * 30).astype(
        np.float32)
    uids = eng.spawn_batch(pos, faction=0, max_speed=80.0)
    assert eng.move(uids, (400.0, 400.0))
    return eng, uids


def _host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_fused_bit_identical_to_per_frame():
    a, _ = _build("port", micro=False)
    b, _ = _build("port", micro=True)
    j, _ = _build("jax", micro=True)
    # odd frame count: exercises partial segments + boundary alignment
    for eng in (a, b, j):
        eng.step(75)
    assert a._frame == b._frame == j._frame == 75
    assert a.state.tick == b.state.tick == int(j.state.tick) == 75
    for name in ("pos", "vel", "movestate", "facing", "vel_hist"):
        np.testing.assert_array_equal(_host(getattr(a.state.ents, name)),
                                      _host(getattr(b.state.ents, name)))
    assert a.events == b.events
    assert b.events == j.events
    np.testing.assert_allclose(_host(b.state.ents.pos),
                               _host(j.state.ents.pos), atol=1e-3)


def test_fused_handler_parity_with_events_flowing():
    """Drains deliver events mid-call; the handlers must fire with the same
    payloads in the same order fused, per frame and in the JAX engine."""
    from permafrost_engine_tpu_torch.core.events import EventType

    def drive(kind, micro):
        eng, _ = _build(kind, micro)
        calls = []
        for ev in (EventType.MOTION_START, EventType.MOTION_END):
            eng.bus.subscribe(int(ev), lambda a, e=ev: calls.append(
                (int(e), a["uid"])))
        for _ in range(15):     # segment-sized calls: the queue stays warm
            eng.step(5)
        return eng, calls

    a, ca = drive("port", False)
    b, cb = drive("port", True)
    _, cj = drive("jax", True)
    assert ca, "scenario generated no events: the test is vacuous"
    assert ca == cb == cj
    np.testing.assert_array_equal(_host(a.state.ents.pos),
                                  _host(b.state.ents.pos))


def _record_handlers(eng, events) -> list:
    """Subscribe a global handler to each event kind; each call records
    (the engine's frame, event, uid)."""
    calls = []
    for ev in events:
        eng.bus.subscribe(int(ev), lambda a, e=ev: calls.append(
            (eng._frame, int(e), a["uid"])))
    return calls


@pytest.mark.parametrize("micro", [True, False], ids=["fused", "per_frame"])
def test_handlers_fire_at_jax_frames_step(micro):
    """Queued events are dispatched at the end of every host-systems tick
    (every segment), as in the JAX engine, not only at the end of a
    ``step`` call. On the scene of ``_build`` over two ``step(60)`` calls,
    the move order's 8 MOTION_START handlers fire at frame 6 fused (frame 1
    per frame) in the JAX engine; a port that serviced the queue only at
    the end of ``step`` fired them at frame 60."""
    from permafrost_engine_tpu_torch.core.events import EventType

    logs = []
    for kind in ("jax", "port"):
        eng, _ = _build(kind, micro)
        calls = _record_handlers(eng, (EventType.MOTION_START,
                                       EventType.MOTION_END))
        eng.step(60)
        eng.step(60)
        logs.append(calls)
    jlog, tlog = logs
    starts = [f for f, e, _ in jlog if e == int(EventType.MOTION_START)]
    assert starts == [6 if micro else 1] * 8
    assert tlog == jlog


def test_handlers_fire_at_jax_frames_step_scan():
    """The same for one ``step_scan(300)`` over the war scene of
    ``_corpse_scene``: attack starts, deaths, projectile hits and the
    building's removal reach their handlers at the JAX engine's frames."""
    from permafrost_engine_tpu_torch.core.events import EventType

    kinds = (EventType.ATTACK_START, EventType.ENTITY_DEATH,
             EventType.PROJECTILE_HIT, EventType.ENTITY_REMOVED)
    logs = []
    for kind in ("jax", "port"):
        eng, _ = _corpse_scene(kind)
        calls = _record_handlers(eng, kinds)
        eng.step_scan(300)
        logs.append(calls)
    jlog, tlog = logs
    assert {e for _, e, _ in jlog} >= {int(EventType.ATTACK_START),
                                        int(EventType.ENTITY_DEATH),
                                        int(EventType.ENTITY_REMOVED)}
    assert tlog == jlog


@pytest.mark.parametrize("frame,seek_period", [
    (0, 30), (1, 30), (5, 30), (7, 30), (24, 30), (29, 30), (59, 30),
    (0, 4), (6, 4), (11, 4)])
def test_fusible_frames_matches_jax(frame, seek_period):
    t, _ = _build("port", True)
    j, _ = _build("jax", True)
    for eng in (t, j):
        eng._frame = frame
        eng.seek_refresh_period = seek_period
    assert t._fusible_frames() == j._fusible_frames()


def _corpse_scene(kind):
    """tests/test_torch_structures.py's building-corpse scene: an attacker
    at war with a blocking building that dies, decays and is unstamped."""
    cfg = EngineConfig(max_ents=32, chunks_r=1, chunks_c=1, num_layers=2,
                       max_flocks=4, max_projectiles=16, field_slab_slots=8,
                       los_slab_slots=8)
    eng = (JaxEngine(cfg) if kind == "jax"
           else Engine(_tcfg(cfg), device="cpu"))
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
    return eng, b[0]


def _record_drains(eng) -> list:
    """Wrap the engine's drain: (frame, events emitted) of each drain that
    emitted any."""
    log = []
    drain = eng._drain

    def recorded(*args):
        n0 = len(eng.events)
        drain(*args)
        if len(eng.events) > n0:
            log.append((eng._frame, eng.events[n0:]))
    eng._drain = recorded
    return log


def _first_frame(log, kind):
    return next(f for f, evs in log if any(k == kind for k, _ in evs))


@pytest.mark.parametrize("drive", ["step", "step_scan"])
def test_drain_lag_matches_jax(drive):
    logs, unstamped = [], []
    for kind in ("jax", "port"):
        eng, building = _corpse_scene(kind)
        log = _record_drains(eng)
        getattr(eng, drive)(306)
        logs.append(log)
        unstamped.append(building not in eng._structures)
    jlog, tlog = logs
    assert tlog == jlog
    assert all(unstamped)
    if drive == "step":
        assert _first_frame(tlog, "attack_start") == 12
        assert _first_frame(tlog, "entity_death") == 18
        assert _first_frame(tlog, "entity_removed") == 186


def test_step_scan_one_segment_matches_jax():
    """No war and no seek flock: the whole window is one segment, its
    events drained once."""
    (t, tu), (j, ju) = _build("port", True), _build("jax", True)
    tlog, jlog = _record_drains(t), _record_drains(j)
    for eng, uids in ((t, tu), (j, ju)):
        assert eng.move(uids, (430.0, 150.0))    # near: they arrive
        eng.step_scan(240)
    assert t._frame == int(j.state.tick) == t.state.tick == 240
    assert tlog == jlog and tlog
    assert t.events == j.events
    np.testing.assert_allclose(_host(t.state.ents.pos),
                               _host(j.state.ents.pos), atol=1e-3)


_SYNCING = {"aten::_local_scalar_dense", "aten::item", "aten::is_nonzero",
            "aten::nonzero", "aten::masked_select", "aten::_unique2",
            "aten::unique_dim", "aten::unique_consecutive", "aten::bincount",
            "aten::repeat_interleave", "aten::equal", "aten::allclose",
            "aten::lift_fresh"}
_INDEXING = {"aten::index", "aten::index_put", "aten::index_put_",
             "aten::_index_put_impl_"}


class _CaptureAudit(TorchDispatchMode):
    """Records every op that could not be captured in a CUDA graph: ops
    that synchronize with the host, boolean-mask indexing, and tensor
    inputs that no op made (host data brought in during the tick)."""

    def __init__(self):
        super().__init__()
        self.known = {id(o): weakref.ref(o) for o in gc.get_objects()
                      if isinstance(o, torch.Tensor)}
        self.bad = []

    def _is_known(self, t) -> bool:
        ref = self.known.get(id(t))
        return ref is not None and ref() is t

    def opaque(self, fn):
        """`fn` run unaudited, its outputs known: a kernel launched through
        ctypes (K1 on the card) is no torch op at all."""
        def run(*args, **kw):
            with _disable_current_modes():
                out = fn(*args, **kw)
            self.known[id(out)] = weakref.ref(out)
            return out
        return run

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        if name in _SYNCING:
            self.bad.append(name)
        if name in _INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] or ()):
            self.bad.append(f"{name} with a boolean index")
        for t in tree_flatten((args, kwargs))[0]:
            if isinstance(t, torch.Tensor) and not self._is_known(t):
                self.bad.append(f"{name}: an input no op made")
        out = func(*args, **kwargs)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.known[id(t)] = weakref.ref(t)
        return out


def test_tick_is_capturable(monkeypatch):
    """Every frame of the cadence period, with every substep (the
    shadowcaster fog, skinning, combat and projectiles at war) runs no op a
    CUDA graph capture would refuse (after a warm-up that builds the
    per-device constants, as the graph cache does). K1 stands opaque, as
    its kernel launch is on the card; its plain version is not audited."""
    _assert_capturable(monkeypatch, max_flocks=4)


def test_tick_is_capturable_at_1024_flocks(monkeypatch):
    """``test_tick_is_capturable`` with a flock table of 1,024 rows, where
    the cohesion stage sorts the units' (flock, cell) keys instead of
    filling its dense table."""
    _assert_capturable(monkeypatch, max_flocks=1024)


def _assert_capturable(monkeypatch, max_flocks: int) -> None:
    cfg = EngineConfig(max_ents=48, chunks_r=1, chunks_c=2, num_layers=2,
                       max_flocks=max_flocks, max_projectiles=16,
                       field_slab_slots=8, los_slab_slots=8, skin_joints=12)
    eng = Engine(_tcfg(cfg), device="cpu")
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(3)
    for f, x0 in ((0, 100.0), (1, 130.0)):
        eng.spawn_batch((np.array([x0, 100.0]) + rng.random((8, 2)) * 20
                         ).astype(np.float32), faction=f,
                        is_ranged=rng.random(8) < 0.5, attack_range=30.0)
    heights = torch.from_numpy(
        rng.random((cfg.tiles_h, cfg.tiles_w)).astype(np.float32) * 12.0)
    period = cadence_period(eng.cfg)
    assert period == 60
    scan = make_tick_scan(eng.cfg, heights,
                          skin_bank=make_procedural_bank(12, device="cpu"))
    state, acc = scan(eng.state, period)          # the warm-up
    audit = _CaptureAudit()
    monkeypatch.setattr(step_mod, "hrvo_select",
                        audit.opaque(step_mod.hrvo_select))
    with audit:
        state, acc = scan(state, period, acc)
    assert not audit.bad, sorted(set(audit.bad))
    assert state.tick == int(state.anim.tick) == 2 * period
