"""PyTorch port vs the JAX package: a whole game scenario through ``pf``.

``demos/rts_demo.py``'s scenario (its world from the port's copy of the
demo, ``permafrost_engine_tpu_torch/demos/rts_demo.py``): two factions at war, a worker economy
(a harvester gathering Wood into a storage site), six knights in a RANK
formation against six grunts, two scouts garrisoning a tower, a session
saved and loaded mid-march and again at the end, and the demo's last call,
``pf.dump_framebuffer``, here to a ``.npy`` file. It runs through the JAX
``pf`` and through the port's (on the CPU), the same script for both, with
the demo's own assertions. The two dumped frames are held to
``tests/test_torch_scene.py``'s frame tolerance. Held equal: the death events and the frames
they came at, the Wood stored each second, who is garrisoned, the
engine's event log, every hp and the frame. Positions are compared every
second: within 1e-3 world units (the tolerance of the port's other engine
parity tests) until the first attack starts, and within ``MELEE_POS_ATOL``
in the melee after it.

Why the melee has its own limit: the two engines first differ at the first
movement substep, by one f32 ulp of the separation force (its sum over the
neighbour window adds in another order in XLA than in PyTorch). The crowd
carries such ulps along, and in the melee a unit that halts one substep
earlier or later keeps the difference: 0.0183 world units at most in this
run. ``test_rts_demo_one_frame_differences_are_rounding`` shows that no
step of the port adds more than rounding: stepped frame by frame through
the march and the melee, with the port's float entity columns set to the
JAX engine's after every frame, one frame never moves a float column more
than ``ONE_FRAME_ATOL`` apart, and every integer column and event stays
equal.

Then two ``pf.step`` windows with a fog-of-war toggle between them, stepped
micro-batched (fused segments) and frame by frame: both give the JAX
engine's fog state after each window.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

import permafrost_engine_tpu.script.pf as jpf
from permafrost_engine_tpu.core.config import EngineConfig
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig
from permafrost_engine_tpu_torch.demos import rts_demo as rts_demo_port
from permafrost_engine_tpu_torch.script import pf as tpf

from test_torch_scene import assert_frames_close

POS_ATOL = 1e-3
MELEE_POS_ATOL = 0.05   # 0.0183 measured (see the module docstring)
ONE_FRAME_ATOL = 1e-4   # 3.05e-5 measured: two f32 ulps at 256-512 units


def _init(pf, cfg):
    if pf is tpf:
        return pf.init(TorchConfig(**dataclasses.asdict(cfg)), device="cpu")
    return pf.init(cfg)


def demo_setup(pf, tmp):
    """The port's ``demos/rts_demo.py`` world (``rts_demo.setup``, which
    takes either ``pf``) on an engine with the demo's config, up to the
    knights' move order, with a handler that records each death's frame."""
    _init(pf, EngineConfig(**rts_demo_port.CONFIG))
    pf.context().basedir = str(tmp)
    w = rts_demo_port.setup(pf)
    deaths = []

    def on_death(ev):
        deaths.append((pf.context().engine._frame, ev["uid"]))

    pf.register_event_handler(pf.EVENT_ENTITY_DEATH, on_death)
    return dict(w, deaths=deaths, on_death=on_death)


def rts_demo(pf, tmp) -> dict:
    """demos/rts_demo.py's main(), dumping its frame to .npy; returns what
    it observed."""
    w = demo_setup(pf, tmp)
    humans, worker, knights, grunts = (w["humans"], w["worker"],
                                       w["knights"], w["grunts"])
    tower, scouts, deaths = w["tower"], w["scouts"], w["deaths"]
    on_death = w["on_death"]
    pending = list(scouts)

    pf.move_in_formation(knights, (300, 0, 280), pf.FORMATION_RANK)
    pf.step(120)

    assert pf.save_session("rts_demo_mid.bin")
    assert pf.load_session("rts_demo_mid.bin")
    # the harness lives outside the restored script layer: re-register
    pf.register_event_handler(pf.EVENT_ENTITY_DEATH, on_death)

    tracked = knights + grunts + [worker] + scouts

    def positions():
        return np.asarray([e.pos for e in tracked if not e.zombie],
                          np.float64)

    # positions each second, each marked with whether an attack has started
    # by then (see the module docstring)
    trace = [(False, positions())]
    seconds = []
    for second in range(30):
        pf.step(60)
        trace.append((any(k == "attack_start"
                          for k, _ in pf.context().engine.events),
                      positions()))
        pending = [s for s in pending if not s.garrison(tower)]
        wood = pf.get_resource_stored(humans, "Wood")
        orc_alive = sum(0 if g.zombie else (1 if g.hp > 0 else 0)
                        for g in grunts)
        seconds.append((wood, orc_alive, len(deaths)))
        if orc_alive == 0 and wood >= 16:
            break

    assert pf.get_resource_stored(humans, "Wood") >= 16, "economy failed"
    assert any(u in [g.uid for g in grunts] for _f, u in deaths), \
        "no orcs died"
    garrisoned = tower.garrisoned_units
    assert len(garrisoned) == 2, f"garrison failed: {garrisoned}"

    assert pf.save_session("rts_demo_save.bin")
    assert pf.load_session("rts_demo_save.bin")
    # the demo's last call: a frame from the active camera
    assert pf.dump_framebuffer(str(tmp / "frame.npy"))
    frame = np.load(tmp / "frame.npy")
    eng = pf.context().engine
    living = [e for e in tracked if not e.zombie]
    return dict(
        exact=dict(deaths=deaths, seconds=seconds,
                   wood=pf.get_resource_stored(humans, "Wood"),
                   garrisoned=garrisoned, events=eng.events,
                   frame=eng._frame, alive=[e.uid for e in living],
                   hp=[e.hp for e in living
                       if isinstance(e, pf.CombatableEntity)], idle=sorted(
                       e.uid for e in pf.get_idle_units(humans))),
        trace=trace, frame=frame)


def test_rts_demo_matches_jax(tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    try:
        want = rts_demo(jpf, tmp_path / "jax")
    finally:
        jpf._context = None
    try:
        got = rts_demo(tpf, tmp_path / "torch")
    finally:
        tpf._context = None
    assert got["exact"]["deaths"], "the knights killed grunts"
    assert got["exact"] == want["exact"]
    assert len(got["trace"]) == len(want["trace"]) >= 3
    melee = 0.0
    for i, ((g_atk, g), (w_atk, w)) in enumerate(zip(got["trace"],
                                                     want["trace"])):
        assert g_atk == w_atk
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=MELEE_POS_ATOL if w_atk else POS_ATOL,
                                   err_msg=f"second {i}")
        if w_atk:
            melee = max(melee, float(np.abs(g - w).max()))
    # the comparison reached the melee, and drifted there as it was measured
    assert got["trace"][-1][0] and 0.0 < melee <= MELEE_POS_ATOL
    # the dumped frames: the port's renderer over the port's state (the
    # demo's default camera sees mostly sky; the HUD minimap shows units)
    assert got["frame"].shape == (384, 640, 3)
    assert len(np.unique(got["frame"].reshape(-1, 3), axis=0)) > 1
    assert_frames_close(got["frame"], want["frame"])


ONE_FRAME_FRAMES = 600   # the first attack starts at frame 264, the first death at 276


def _columns(eng):
    """The engine's entity columns as numpy arrays, by name."""
    ents = eng.state.ents
    return {f.name: (getattr(ents, f.name).numpy()
                     if isinstance(getattr(ents, f.name), torch.Tensor)
                     else np.asarray(getattr(ents, f.name)))
            for f in dataclasses.fields(ents)}


def test_rts_demo_one_frame_differences_are_rounding(tmp_path):
    """The rts_demo world stepped frame by frame on both engines, through
    the march and into the melee; after every frame the port's float entity
    columns are set to the JAX engine's, so each frame starts from equal
    state. One frame never moves a float column more than ONE_FRAME_ATOL
    apart, and the integer columns and the event log stay equal."""
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    try:
        worlds = [demo_setup(pf, tmp_path / side)
                  for pf, side in ((jpf, "jax"), (tpf, "torch"))]
        for pf, w in zip((jpf, tpf), worlds):
            pf.move_in_formation(w["knights"], (300, 0, 280),
                                 pf.FORMATION_RANK)
        ej, et = jpf.context().engine, tpf.context().engine
        worst = 0.0
        for _ in range(ONE_FRAME_FRAMES):
            jpf.step(1)
            tpf.step(1)
            want, got = _columns(ej), _columns(et)
            for name, w in want.items():
                g = got[name]
                if w.dtype.kind == "f":
                    d = float(np.abs(g.astype(np.float64) - w).max())
                    assert d <= ONE_FRAME_ATOL, (ej._frame, name, d)
                    worst = max(worst, d)
                    setattr(et.state.ents, name, torch.from_numpy(w.copy()))
                else:
                    np.testing.assert_array_equal(
                        g.astype(np.int64), w.astype(np.int64),
                        err_msg=f"frame {ej._frame}: {name}")
            assert et.events == ej.events, ej._frame
        kinds = [k for k, _ in ej.events]
        assert "attack_start" in kinds and "entity_death" in kinds
        assert worst > 0.0
    finally:
        jpf._context = None
        tpf._context = None


FOG_WINDOW = 30


def fog_windows(pf, micro: bool = True) -> list:
    """Two armies in sight of each other; a window stepped, fog disabled,
    a window, fog enabled, a window: the fog state after each."""
    from permafrost_engine_tpu.core.config import EngineConfig
    _init(pf, EngineConfig(max_ents=32, chunks_r=2, chunks_c=2, num_layers=1,
                           max_flocks=8, max_projectiles=32,
                           field_slab_slots=16, los_slab_slots=16))
    eng = pf.context().engine
    eng.micro_batching = micro
    a = pf.add_faction("A")
    b = pf.add_faction("B")
    for i in range(4):
        pf.MovableEntity("u.pfobj", f"a{i}", pos=(100 + 8 * i, 0, 100),
                         faction_id=a, speed=30.0, vision_range=50.0)
        pf.MovableEntity("u.pfobj", f"b{i}", pos=(380 + 8 * i, 0, 400),
                         faction_id=b, speed=30.0, vision_range=50.0)
    u = pf.MovableEntity("u.pfobj", "walker", pos=(120, 0, 120), faction_id=a,
                         speed=40.0, vision_range=40.0)
    u.move((300, 0, 300))

    def fog():
        f = eng.state.fog
        st = f.state.cpu().numpy() if pf is tpf else np.asarray(f.state)
        en = bool(f.enabled.item()) if pf is tpf else bool(np.asarray(
            f.enabled))
        return st.copy(), en

    out = []
    pf.step(FOG_WINDOW)
    out.append(fog())
    pf.disable_fog_of_war()
    pf.step(FOG_WINDOW)
    out.append(fog())
    pf.explore_map(b)
    pf.enable_fog_of_war()
    pf.step(FOG_WINDOW)
    out.append(fog())
    return out


@pytest.mark.parametrize("micro", [True, False], ids=["fused", "per_frame"])
def test_fog_toggle_between_windows_matches_jax(micro):
    try:
        want = fog_windows(jpf)
    finally:
        jpf._context = None
    try:
        got = fog_windows(tpf, micro)
    finally:
        tpf._context = None
    assert [en for _, en in got] == [True, False, True]
    # disabled fog shows every tile VISIBLE; enabled hides some again
    assert (got[1][0] == 2).all() and not (got[2][0] == 2).all()
    for (gs, ge), (ws, we) in zip(got, want):
        assert ge == we
        np.testing.assert_array_equal(gs, ws)
