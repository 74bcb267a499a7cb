"""PyTorch port vs the JAX package: the host subsystems' own copies.

Each case feeds the same inputs (numpy-seeded where random) and the same
calls to the JAX package's module and to the port's copy, and holds the
results equal:

* ``core/settings.py``: registration, commit hooks, validation and type
  errors, and a file saved by either store loaded by the other;
* ``core/sched.py``: ``tests/test_core.py``'s task programs (send,
  receive and reply through the name server; sleep and yield; await an
  event) and a snapshot/restore mid-run, with equal traces tick by tick;
  ``demos/pong.py``'s paddle tasks on both schedulers, equal scores, score
  events, ball and paddles after 600 ticks;
* ``core/audio.py``: the offline mixdown, byte-equal WAV files, and equal
  clocks and snapshots;
* ``game/region.py`` and ``game/selection.py``: enter and exit events over
  a numpy-seeded walk, click/box selection and pruning of the dead;
* ``render/anim_system.py``: ``tick`` (clip clocks and ANIM_FINISHED
  events) and ``pose_palettes`` on a synthetic 8-joint model, within the
  1e-4 of ``tests/test_torch_skin.py`` (XLA contracts multiply-adds on the
  CPU, so the last bits differ).
"""

import types
import wave

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core import audio as jaudio
from permafrost_engine_tpu.core import events as jevents
from permafrost_engine_tpu.core import sched as jsched
from permafrost_engine_tpu.core import settings as jsettings
from permafrost_engine_tpu.game import region as jregion
from permafrost_engine_tpu.game import selection as jselection
from permafrost_engine_tpu.render import anim_system as janim
from permafrost_engine_tpu_torch.core import audio as taudio
from permafrost_engine_tpu_torch.core import events as tevents
from permafrost_engine_tpu_torch.core import sched as tsched
from permafrost_engine_tpu_torch.core import settings as tsettings
from permafrost_engine_tpu_torch.core.config import EntityFlags
from permafrost_engine_tpu_torch.game import region as tregion
from permafrost_engine_tpu_torch.game import selection as tselection
from permafrost_engine_tpu_torch.render import anim_system as tanim

TOL = 1e-4
SIDES = {"jax": (jsettings, jsched, jevents, jaudio, jregion, jselection,
                 janim),
         "port": (tsettings, tsched, tevents, taudio, tregion, tselection,
                  tanim)}


# -- settings ------------------------------------------------------------------


def _settings_trace(mod, path, load_from=None):
    s = mod.Settings()
    trace = []
    if load_from:
        s.load_from_file(load_from)
    s.create("pf.video.vsync", mod.SettingType.BOOL, True,
             commit=lambda v: trace.append(("commit", v)))
    s.create("pf.game.movement_hz", mod.SettingType.INT, 20,
             validate=lambda v: v in (20, 10, 5, 1))
    s.create("pf.video.resolution", mod.SettingType.VEC2, [1920, 1080])
    s.set("pf.video.vsync", False)
    for name, value in (("pf.game.movement_hz", 7),
                        ("pf.game.movement_hz", "20"),
                        ("pf.video.resolution", [1, 2, 3]), ("pf.nope", 1)):
        try:
            s.set(name, value)
        except mod.SettingsError as e:
            trace.append(("error", str(e)))
    s.set("pf.game.movement_hz", 10)
    s.save_to_file(path)
    trace.append(("snapshot", s.snapshot(), s.names()))
    return trace


def test_settings_round_trip_matches_jax(tmp_path):
    jp, tp = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    assert (_settings_trace(tsettings, tp)
            == _settings_trace(jsettings, jp))
    assert open(tp).read() == open(jp).read()
    # each store loads the other's file, applied at registration
    assert (_settings_trace(tsettings, tp, load_from=jp)
            == _settings_trace(jsettings, jp, load_from=tp))


# -- the scheduler (tests/test_core.py's programs) ------------------------------


def _prog_send_receive(S, log):
    def server(task):
        yield S.Register("echo")
        while True:
            msg, sender = yield S.Receive()
            log.append(("server", msg, sender))
            if msg == "quit":
                return "bye"
            yield S.Reply(sender, msg * 2)

    def client(task):
        tid = yield S.WhoIs("echo")
        reply = yield S.Send(tid, 21)
        log.append(("client", reply))
        yield S.Send(tid, "quit")
    return [server, client]


def _prog_sleep_yield(S, log):
    def sleeper(task):
        log.append("a")
        yield S.Sleep(3)
        log.append("b")
        yield S.Yield()
        log.append("c")
    return [sleeper]


def _prog_await_event(S, log):
    def waiter(task):
        arg = yield S.AwaitEvent(10)       # MOTION_END in both enums
        log.append(arg)
        task.state["n"] = task.state.get("n", 0) + 1
        arg = yield S.AwaitEvent(11)
        log.append(arg)
    return [waiter]


def _run_sched(side: str, program, posts=(), snapshot_at=None):
    _, S, E = SIDES[side][:3]
    bus = E.EventBus()
    finished = []
    bus.subscribe(int(E.EventType.SCRIPT_TASK_FINISHED), finished.append)
    sched = S.Scheduler(bus)
    log = []
    for fn in program(S, log):
        sched.create(fn)
    trace = []
    for t in range(10):
        if t == snapshot_at:
            # a fresh scheduler replays the logs of the live tasks
            snap = sched.snapshot()
            sched = S.Scheduler(bus)
            trace.append(("resumed", sched.restore(snap)))
        for when, ev, arg in posts:
            if when == t:
                sched.post_event(ev, arg)
        runs = sched.tick()
        bus.service_queue()
        trace.append((t, runs, list(log), sorted(sched.tasks)))
    return trace, finished


@pytest.mark.parametrize("snapshot_at", [None, 2], ids=["live", "restored"])
@pytest.mark.parametrize("program,posts", [
    (_prog_send_receive, ()),
    (_prog_sleep_yield, ()),
    (_prog_await_event, ((3, 10, {"uid": 5}), (5, 11, {"uid": 6}))),
], ids=["send_receive_reply", "sleep_yield", "await_event"])
def test_scheduler_programs_match_jax(program, posts, snapshot_at):
    got = _run_sched("port", program, posts, snapshot_at)
    assert got == _run_sched("jax", program, posts, snapshot_at)
    trace, _ = got
    assert trace[-1][3] == [], "every task ran to its end"


def test_sched_send_receive_reply_result():
    """The port's scheduler alone gives tests/test_core.py's results."""
    trace, finished = _run_sched("port", _prog_send_receive)
    assert ("client", 42) in trace[-1][2]
    assert (1, "bye") in finished


# -- demos/pong.py's paddle tasks ---------------------------------------------------

W, H, PADDLE_H, BALL_SPEED, PADDLE_SPEED = 60.0, 20.0, 4.0, 0.8, 0.6


class Pong:
    """demos/pong.py's game on one engine package's scheduler and bus."""

    def __init__(self, side: str):
        _, S, E = SIDES[side][:3]
        self.E = E
        self.bus = E.EventBus()
        self.sched = S.Scheduler(self.bus)
        self.Yield = S.Yield
        self.ball = [W / 2, H / 2]
        self.vel = [BALL_SPEED, BALL_SPEED * 0.37]
        self.paddles = {0: H / 2, 1: H / 2}
        self.score = [0, 0]
        self.sched.create(self.paddle_task, 0, name="paddle_left")
        self.sched.create(self.paddle_task, 1, name="paddle_right")

    def paddle_task(self, task, side):
        while True:
            by = self.ball[1]
            py = self.paddles[side]
            if abs(by - py) > 0.5:
                self.paddles[side] = py + PADDLE_SPEED * (1 if by > py else -1)
            yield self.Yield()

    def tick(self):
        self.sched.tick()
        b, v = self.ball, self.vel
        b[0] += v[0]
        b[1] += v[1]
        if b[1] <= 0 or b[1] >= H:
            v[1] = -v[1]
        for side, x in ((0, 1.0), (1, W - 1.0)):
            if (side == 0 and b[0] <= x) or (side == 1 and b[0] >= x):
                if abs(b[1] - self.paddles[side]) <= PADDLE_H / 2:
                    v[0] = -v[0]
                    b[0] = x + (1 if side == 0 else -1) * 0.5
                else:
                    self.score[1 - side] += 1
                    self.bus.notify(self.E.EventType.SCRIPT_BASE + 1,
                                    tuple(self.score))
                    b[:] = [W / 2, H / 2]
        self.bus.service_queue()


def test_pong_matches_jax():
    out = []
    for side in ("jax", "port"):
        game = Pong(side)
        scores = []
        game.bus.subscribe(game.E.EventType.SCRIPT_BASE + 1, scores.append)
        for _ in range(600):
            game.tick()
        out.append((game.score, scores, game.ball, game.paddles))
    assert out[0] == out[1]
    # the paddle tasks ran: both paddles left the centre line
    assert all(p != H / 2 for p in out[1][3].values())


# -- audio ----------------------------------------------------------------------


def _mix(side, path):
    A = SIDES[side][3]
    au = A.AudioSystem()
    au.add_tracks(["theme", "battle"])
    au.play_music("theme")
    au.play_global_effect("horn")
    au.tick(30)
    au.play_global_effect("bell", channel=2)
    au.play_effect("clang", (30.0, 0.0))
    au.play_effect("thud", (-80.0, 40.0), uid=3)
    au.tick(60)
    n = au.render_wav(path, seconds=1.0, listener_pos=(0.0, 10.0, 0.0))
    au.pause()
    au.tick(500)
    snap = au.snapshot()
    return n, snap, [c.name for c in au.channels], len(au.positional)


def test_audio_mixdown_matches_jax(tmp_path):
    jp, tp = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    assert _mix("port", tp) == _mix("jax", jp)
    with open(tp, "rb") as a, open(jp, "rb") as b:
        data = a.read()
        assert data == b.read()
    with wave.open(tp, "rb") as w:
        assert w.getnchannels() == 2 and w.getnframes() > 0


# -- regions and selection -------------------------------------------------------


def _regions_and_selection(side):
    E, A, R, Sel = (SIDES[side][2], SIDES[side][3], SIDES[side][4],
                    SIDES[side][5])
    bus = E.EventBus()
    got = []
    for ev in ("REGION_ENTERED", "REGION_EXITED", "SELECTION_CHANGED"):
        bus.subscribe(getattr(E.EventType, ev),
                      lambda a, ev=ev: got.append((ev, a)))
    regions = R.RegionSystem(bus)
    regions.add_circle("gate", (50.0, 50.0), 20.0)
    regions.add_rect("bridge", (120.0, 80.0), 30.0, 10.0)
    rng = np.random.default_rng(7)
    n = 24
    uids = np.arange(1, n + 1, dtype=np.int32)
    pos = (rng.random((n, 2)) * 160).astype(np.float32)
    alive = np.ones(n, bool)
    steps = []
    for t in range(12):
        pos = (pos + rng.normal(0, 12, (n, 2))).astype(np.float32)
        alive[rng.integers(0, n)] = t % 3 != 0
        regions.update(uids, pos, alive)
        bus.service_queue()
        steps.append({k: regions.ents_in(k) for k in ("gate", "bridge")})
    sel = Sel.SelectionSystem(bus)
    flags = np.full(n, int(EntityFlags.SELECTABLE), np.int64)
    flags[::5] = 0
    rad = np.full(n, 6.0, np.float32)
    picks = [sel.click_select(tuple(pos[3]), uids, pos, rad, flags, alive),
             sel.box_select((0.0, 0.0), (90.0, 90.0), uids, pos, flags, alive,
                            additive=True),
             sel.update_hovered(tuple(pos[7]), uids, pos, rad, flags, alive)]
    sel.prune_dead({int(u) for u in uids[::2]})
    picks.append(list(sel.selection))
    bus.service_queue()
    return got, steps, picks


def test_regions_and_selection_match_jax():
    got = _regions_and_selection("port")
    assert got == _regions_and_selection("jax")
    events = [e for e, _ in got[0]]
    assert "REGION_ENTERED" in events and "REGION_EXITED" in events
    assert "SELECTION_CHANGED" in events


# -- the animation system on a synthetic 8-joint model ----------------------------


def _model(rng, joints=8):
    def quats(shape):
        q = rng.normal(size=shape + (4,)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    def clip(frames):
        return types.SimpleNamespace(
            frames=frames,
            trans=rng.normal(0, 0.5, (frames, joints, 3)).astype(np.float32),
            rots=quats((frames, joints)),
            scales=(1 + rng.normal(0, 0.05, (frames, joints, 3))
                    ).astype(np.float32))

    return types.SimpleNamespace(
        num_joints=joints,
        joint_parents=np.array([-1, 0, 1, 2, 1, 4, 0, 6], np.int32),
        bind_trans=rng.normal(0, 0.5, (joints, 3)).astype(np.float32),
        bind_rots=quats((joints,)),
        bind_scales=np.ones((joints, 3), np.float32),
        clips={"idle": clip(12), "walk": clip(20), "wave": clip(9)})


def _anim(side):
    E, Anim = SIDES[side][2], SIDES[side][6]
    eng = types.SimpleNamespace(bus=E.EventBus(), device=torch.device("cpu"))
    finished = []
    eng.bus.subscribe(E.EventType.ANIM_FINISHED, finished.append)
    anim = Anim.AnimSystem(eng)
    anim.load_model("rig", _model(np.random.default_rng(11)))
    for uid in range(1, 7):
        anim.register(uid, model="rig")
    anim.play(2, "walk")
    anim.play(3, "wave", Anim.AnimMode.ONCE)
    anim.play(5, "nope")
    clocks = []
    for _ in range(9):
        anim.tick(12 / 60)
        eng.bus.service_queue()
        clocks.append([(u, s.clip, s.t) for u, s in anim.states.items()])
    return clocks, finished, anim.pose_palettes("rig"), anim


def test_anim_system_matches_jax():
    tclocks, tfin, tpal, tanim_sys = _anim("port")
    jclocks, jfin, jpal, _ = _anim("jax")
    assert tclocks == jclocks and tfin == jfin
    assert tfin == [{"uid": 3, "clip": "wave"}]
    assert tpal.shape == (6, 8, 4, 4) and np.isfinite(tpal).all()
    np.testing.assert_allclose(tpal, np.asarray(jpal), rtol=TOL, atol=TOL)
    assert tanim_sys.pose_palettes("none") is None
