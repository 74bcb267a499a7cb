"""PyTorch port vs the JAX package: the modules beneath ``pf``.

Parametrised cases, each the same inputs through the JAX module and the
port's copy, held equal:

* ``constants``: every numeric name ``pf`` exports, and the SDL tables;
* ``ui`` and ``ui_style``: the four scenarios of ``tests/test_ui_style.py``
  (typed style attributes, a scoped button style landing on its widget,
  global widget styles, persistence), and ``layout_window``'s placed
  widgets for a window of every widget kind;
* ``camera``: view, projection, frustum planes, ``screen_ray``,
  ``world_to_screen`` and ``ground_point`` at seeded poses, exactly;
* ``task``: the seven scenarios of ``tests/test_task_replay.py``, through
  each package's scheduler and ``pf.Task``, the last through
  ``pf.save_session`` and ``pf.load_session``;
* ``pfmap``: ``parse_pfmap`` and ``write_pfmap`` on
  ``assets/maps/demo.pfmap`` and on ``make_battle_map()``: equal arrays and
  text;
* ``pfobj`` and the bake cache: equal parses of a seeded model, and the
  port's cache never returns an object of the JAX package;
* ``ops/collision``: the five geometric cases of ``tests/test_collision.py``
  on seeded batches, within 1e-6;
* the ``Engine`` parts ``pf`` calls: ``Engine(cfg=None)``'s config,
  ``height_at`` at seeded points, ``render_alpha`` frame by frame, and
  ``prewarm_nav``, which builds nothing on the CPU.
"""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

import jax.numpy as jnp
import permafrost_engine_tpu.script.pf as jpf
from permafrost_engine_tpu.assets import cache as jcache
from permafrost_engine_tpu.assets import pfmap as jpfmap
from permafrost_engine_tpu.assets import pfobj as jpfobj
from permafrost_engine_tpu.core import sched as jsched
from permafrost_engine_tpu.core.events import EventBus as JaxBus
from permafrost_engine_tpu.ops import collision as jcol
from permafrost_engine_tpu.render import camera as jcam
from permafrost_engine_tpu.script import constants as jconst
from permafrost_engine_tpu.script import ui as jui
from permafrost_engine_tpu.script import ui_style as jstyle
from permafrost_engine_tpu_torch.assets import cache as tcache
from permafrost_engine_tpu_torch.assets import pfmap as tpfmap
from permafrost_engine_tpu_torch.assets import pfobj as tpfobj
from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
from permafrost_engine_tpu_torch.core import sched as tsched
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig
from permafrost_engine_tpu_torch.core.events import EventBus as TorchBus
from permafrost_engine_tpu_torch.ops import collision as tcol
from permafrost_engine_tpu_torch.render import camera as tcam
from permafrost_engine_tpu_torch.script import constants as tconst
from permafrost_engine_tpu_torch.script import pf as tpf
from permafrost_engine_tpu_torch.script import ui as tui
from permafrost_engine_tpu_torch.script import ui_style as tstyle

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLLISION_ATOL = 1e-6

SIDES = {"jax": dict(pf=jpf, ui=jui, style=jstyle, sched=jsched, bus=JaxBus,
                     pfmap=jpfmap, pfobj=jpfobj, cache=jcache, cam=jcam),
         "torch": dict(pf=tpf, ui=tui, style=tstyle, sched=tsched,
                       bus=TorchBus, pfmap=tpfmap, pfobj=tpfobj, cache=tcache,
                       cam=tcam)}


def _small_cfg(side: str):
    kw = dict(max_ents=16, chunks_r=1, chunks_c=1, num_layers=1, max_flocks=4,
              max_projectiles=4, field_slab_slots=4, los_slab_slots=4)
    if side == "torch":
        return TorchConfig(**kw)
    from permafrost_engine_tpu.core.config import EngineConfig
    return EngineConfig(**kw)


def _init(side: str):
    pf = SIDES[side]["pf"]
    if side == "torch":
        return pf.init(_small_cfg(side), device="cpu")
    return pf.init(_small_cfg(side))


def _reset_styles(style) -> None:
    fresh = style.make_default_styles()
    for k, v in style.STYLES.items():
        v.from_dict(fresh[k].to_dict())


def _both(run):
    """run(side) on each side; returns (jax result, torch result)."""
    return run("jax"), run("torch")


# -- constants -------------------------------------------------------------------


def case_constants():
    def run(side):
        pf, mod = SIDES[side]["pf"], (jconst if side == "jax" else tconst)
        return dict(
            exported={n: getattr(pf, n) for n in dir(pf)
                      if (n.isupper() or n == "_CURSOR_MAX")
                      and isinstance(getattr(pf, n), (int, float))},
            tables=(mod.SDL_SCANCODES, mod.SDL_KEYCODES, mod.SDL_EVENTS))
    want, got = _both(run)
    assert len(want["exported"]) >= 781
    return want, got


# -- ui and ui_style ---------------------------------------------------------------


DISABLED_BG = (40, 40, 40, 255)


class _ScopedButtonStyle:
    """scripts/common/button_style_ctx.ButtonStyle over a given pf."""

    def __init__(self, pf, **kw):
        self.pf, self.kw, self.saved = pf, kw, {}

    def __enter__(self):
        for attr in self.pf.button_style.attrs():
            self.saved[attr] = getattr(self.pf.button_style, attr)
        for attr, val in self.kw.items():
            setattr(self.pf.button_style, attr, val)

    def __exit__(self, *exc):
        for attr, val in self.saved.items():
            setattr(self.pf.button_style, attr, val)
        return False


def case_ui_typed_style_attributes():
    def run(side):
        pf, style = SIDES[side]["pf"], SIDES[side]["style"]
        _init(side)
        out = []
        try:
            assert isinstance(pf.button_style, pf.UIButtonStyle)
            pf.button_style.normal = (1, 2, 3)
            out.append(pf.button_style.normal)
            pf.button_style.padding = (5, 6)
            out.append(pf.button_style.padding)
            pf.button_style.normal = "assets/icon.png"
            out.append(pf.button_style.normal)
            with pytest.raises(AttributeError):
                pf.button_style.no_such_knob = 1
            with pytest.raises(AttributeError):
                _ = pf.slider_style.text_normal
            out.append([name for name in dir(pf) if name.endswith("_style")])
            out.append(style.styles_to_dict(style.STYLES))
        finally:
            _reset_styles(style)
            pf._context = None
        return out
    return _both(run)


def case_ui_scoped_button_style():
    def run(side):
        pf, style = SIDES[side]["pf"], SIDES[side]["style"]
        ctx = _init(side)
        try:
            default_bg = pf.button_style.normal

            class Pad(pf.Window):
                def __init__(self):
                    super().__init__("Pad", (0, 0, 800, 200),
                                     pf.NK_WINDOW_BORDER)

                def update(self):
                    self.layout_row_static(80, 300, 2)
                    with _ScopedButtonStyle(pf, normal=DISABLED_BG,
                                            hover=DISABLED_BG,
                                            active=DISABLED_BG,
                                            text_normal=(60, 60, 60, 255)):
                        self.button_label("disabled")
                    self.button_label("enabled")

            win = Pad()
            win.show()
            win._render()
            assert pf.button_style.normal == default_bg
            styles = [item[2] for item in win.draw_list if item[0] == "button"]
            assert styles[0]["normal"] == DISABLED_BG
            assert styles[1]["normal"] == default_bg
            placed = SIDES[side]["ui"].layout_window(win, win.draw_list)
            return dict(draw=win.draw_list, placed=placed,
                        windows=sorted(ctx.ui_windows))
        finally:
            _reset_styles(style)
            pf._context = None
    return _both(run)


def case_ui_global_widget_styles():
    def run(side):
        pf, style = SIDES[side]["pf"], SIDES[side]["style"]
        _init(side)
        try:
            pf.checkbox_style.cursor_normal = (250, 10, 10)
            pf.progress_style.cursor_normal = (10, 250, 10)

            class W(pf.Window):
                def __init__(self):
                    super().__init__("W", (0, 0, 800, 300),
                                     pf.NK_WINDOW_BORDER)

                def update(self):
                    self.layout_row_static(80, 300, 1)
                    self._widget_state[("check", "cb")] = True
                    self.checkbox("cb", True)
                    self.layout_row_static(80, 300, 1)
                    self.progress(100, 100)

            w = W()
            w.show()
            w._render()
            return dict(draw=w.draw_list,
                        styles=style.styles_to_dict(style.STYLES))
        finally:
            _reset_styles(style)
            pf._context = None
    return _both(run)


def case_ui_styles_persist():
    def run(side):
        pf, style = SIDES[side]["pf"], SIDES[side]["style"]
        _init(side)
        try:
            pf.button_style.normal = (9, 9, 9, 9)
            data = style.styles_to_dict(style.STYLES)
            fresh = style.make_default_styles()
            style.styles_from_dict(fresh, data)
            assert fresh["button_style"].normal == (9, 9, 9, 9)
            return style.styles_to_dict(fresh)
        finally:
            _reset_styles(style)
            pf._context = None
    return _both(run)


def case_ui_layout_window():
    def run(side):
        ui = SIDES[side]["ui"]

        class Every(ui.Window):
            def update(self):
                self.layout_row_dynamic(30, 3)
                self.label("Units:")
                self.label_colored("red", 255, 0, 0)
                self.button_label("Go")
                self.layout_row_static(40, 120, 2)
                self.checkbox("flag", True)
                self.option_label("opt", False)
                self.selectable_label("sel", 0, True)
                self.slider_float(0.0, 5.0, 10.0, 0.5)
                self.layout_row_dynamic(24, 4)
                self.progress(3, 10)
                self.text_edit("name", "abc")
                self.spacer(2)
                self.image("icon.png")
                self.group("g")

        _init(side)
        try:
            w = Every("every", (100, 100, 400, 300), flags=ui.WINDOW_TITLE)
            w.show()
            placed = ui.layout_window(w)
            system = ui.UISystem()
            routed = system.route_click({"every": w}, (130.0, 150.0),
                                        system.virtual_resolution)
            return dict(placed=placed, routed=routed,
                        drawn=system.render_all({"every": w}))
        finally:
            SIDES[side]["pf"]._context = None
    return _both(run)


# -- camera ---------------------------------------------------------------------------


def case_camera():
    rng = np.random.default_rng(7)
    poses = [dict(pos=rng.uniform([0, 40, 0], [1024, 300, 1024]),
                  pitch=float(rng.uniform(-89, -20)),
                  yaw=float(rng.uniform(-180, 180)),
                  fov=float(rng.uniform(0.5, 1.2)), mode=int(m))
             for m in (0, 1, 2, 1)]
    pixels = rng.uniform([0, 0], [1920, 1080], size=(8, 2))
    worlds = rng.uniform([0, 0, 0], [1024, 20, 1024], size=(8, 3))

    def run(side):
        cam_mod = SIDES[side]["cam"]
        out = []
        for p in poses:
            cam = cam_mod.Camera(**dict(p, pos=p["pos"].copy()))
            out.append([cam.view_matrix(), cam.proj_matrix(),
                        cam.frustum_planes(), cam.direction(), cam.basis()]
                       + [cam.screen_ray(x, y, 1920, 1080) for x, y in pixels]
                       + [cam.ground_point(x, y, 1920, 1080) for x, y in pixels]
                       + [cam.world_to_screen(w, 1920, 1080) for w in worlds])
            cam.pan(3.0, -2.0)
            cam.zoom(5.0)
            cam.move_within_bounds_and_face((300.0, 200.0))
            out.append(cam.pos.copy())
        return out
    return _both(run)


# -- tasks (tests/test_task_replay.py) ---------------------------------------------------


def _task_fns(S) -> dict:
    """tests/test_task_replay.py's task functions over scheduler module S,
    published under module-level names so their records pickle by
    reference (the importability rule of the scheduler's snapshot)."""
    def counter_task(task, start):
        total = start            # LOCAL variable: only replay can restore it
        while True:
            msg, _sender = yield S.Receive()
            if msg == "stop":
                return total
            total += msg
            task.state["last_total"] = total

    def effect_task(task):
        task.effect(SIDE_EFFECTS.append, "spawned")
        yield S.Yield()
        b = task.effect(len, SIDE_EFFECTS)
        task.state["len"] = b
        yield S.Receive()
        return b

    def flaky_task(task):
        if FLAKY_MODE["branch"]:
            yield S.Sleep(5)
        else:
            yield S.Yield()
        task.state["ran"] = task.state.get("ran", 0) + 1
        yield S.Receive()

    def waiting_task(task):
        arg = yield S.AwaitEvent(777)
        task.state["woke"] = arg
        yield S.Receive()

    def spinner_task(task):
        while True:
            yield S.Yield()

    side = "jax" if S is jsched else "torch"
    fns = {}
    for fn in (counter_task, effect_task, flaky_task, waiting_task,
               spinner_task):
        fn.__name__ = fn.__qualname__ = f"{fn.__name__}_{side}"
        globals()[fn.__name__] = fn
        fns[fn.__name__.rsplit("_", 1)[0]] = fn
    return fns


SIDE_EFFECTS = []
FLAKY_MODE = {"branch": False}
TASK_FNS = {side: _task_fns(SIDES[side]["sched"]) for side in SIDES}


def _roundtrip(sched, S, bus=None):
    snap = pickle.loads(pickle.dumps(sched.snapshot(), protocol=4))
    s2 = S.Scheduler(bus) if bus is not None else S.Scheduler()
    return snap, s2, s2.restore(snap)


def task_replay_restores_local_variables(side):
    S, fn = SIDES[side]["sched"], TASK_FNS[side]
    sched = S.Scheduler()
    tid = sched.create(fn["counter_task"], 100, name="counter")
    sched.tick()
    for v in (7, 5):
        sched.send(tid, v)
        sched.tick()
    snap, s2, resumed = _roundtrip(sched, S)
    assert resumed == 1
    s2.send(tid, "stop")
    s2.tick()
    t = s2.tasks.get(tid)
    assert t is None or t.status == 6
    assert snap["tasks"][0]["state"]["last_total"] == 112
    return resumed, snap["tasks"][0]["state"], t is None


def task_replay_result_continuity(side):
    S, fn = SIDES[side]["sched"], TASK_FNS[side]
    sched = S.Scheduler()
    tid = sched.create(fn["counter_task"], 1000, name="c")
    sched.tick()
    for v in (3, 9, 27):
        sched.send(tid, v)
        sched.tick()
    _snap, s2, resumed = _roundtrip(sched, S)
    assert resumed == 1
    s2.send(tid, "stop")
    t = s2.tasks[tid]
    s2.tick()
    assert t.result == 1000 + 3 + 9 + 27
    return t.result


def task_effects_execute_exactly_once(side):
    S, fn = SIDES[side]["sched"], TASK_FNS[side]
    SIDE_EFFECTS.clear()
    sched = S.Scheduler()
    tid = sched.create(fn["effect_task"], name="fx")
    sched.tick()
    sched.tick()
    assert SIDE_EFFECTS == ["spawned"]
    _snap, s2, resumed = _roundtrip(sched, S)
    assert resumed == 1 and SIDE_EFFECTS == ["spawned"]
    s2.send(tid, ("go",))
    t = s2.tasks[tid]
    s2.tick()
    assert t.result == 1
    return t.result, list(SIDE_EFFECTS)


def task_nondeterministic_falls_back_to_restart(side):
    S, fn = SIDES[side]["sched"], TASK_FNS[side]
    FLAKY_MODE["branch"] = False
    sched = S.Scheduler()
    tid = sched.create(fn["flaky_task"], name="flaky")
    sched.tick()
    sched.tick()
    snap = pickle.loads(pickle.dumps(sched.snapshot(), protocol=4))
    FLAKY_MODE["branch"] = True
    try:
        s2 = S.Scheduler()
        restored = s2.restore(snap)
    finally:
        FLAKY_MODE["branch"] = False
    assert restored == 0
    t = s2.tasks[tid]
    assert t.status != 6 and t.state.get("ran") == 1
    return restored, t.status, dict(t.state)


def task_blocked_event_state_survives(side):
    S, Bus, fn = SIDES[side]["sched"], SIDES[side]["bus"], TASK_FNS[side]
    sched = S.Scheduler(Bus())
    tid = sched.create(fn["waiting_task"], name="w")
    sched.tick()
    _snap, s2, resumed = _roundtrip(sched, S, Bus())
    assert resumed == 1
    s2.post_event(777, {"hello": 1})
    s2.tick()
    assert s2.tasks[tid].state["woke"] == {"hello": 1}
    return dict(s2.tasks[tid].state)


def task_log_cap_degrades_to_restart(side):
    S, fn = SIDES[side]["sched"], TASK_FNS[side]
    sched = S.Scheduler()
    tid = sched.create(fn["spinner_task"], name="spin")
    for _ in range(S.REPLAY_LOG_CAP + 5):
        sched.tick()
    t = sched.tasks[tid]
    assert not t.replayable and not t.resume_log
    _snap, s2, restored = _roundtrip(sched, S)
    assert restored == 0 and s2.alive(tid)
    return restored, S.REPLAY_LOG_CAP


def _quest_run(self):
    progress = 0             # local, not in self.state
    while progress < 3:
        yield self.sleep(2)
        progress += 1
    self.state["done_at"] = progress
    yield self.receive()


class JaxQuest(jpf.Task):
    __run__ = _quest_run


class TorchQuest(tpf.Task):
    __run__ = _quest_run


def task_pf_task_mid_execution_through_session(side, tmp_path):
    pf = SIDES[side]["pf"]
    ctx = _init(side)
    try:
        ctx.basedir = str(tmp_path)
        quest = JaxQuest if side == "jax" else TorchQuest
        q = quest()
        for _ in range(5):
            ctx.engine.sched.tick()
        assert "done_at" not in q.state
        pf.save_session("quest.sav")
        pf.load_session("quest.sav")
        eng2 = ctx.engine
        q2 = ctx.tasks[q.tid]
        assert isinstance(q2, quest) and q2 is not q
        for _ in range(6):
            eng2.sched.tick()
        assert q2.state["done_at"] == 3
        return q.tid, dict(q2.state), q2.completed
    finally:
        pf._context = None


TASKS = [task_replay_restores_local_variables, task_replay_result_continuity,
         task_effects_execute_exactly_once,
         task_nondeterministic_falls_back_to_restart,
         task_blocked_event_state_survives, task_log_cap_degrades_to_restart,
         task_pf_task_mid_execution_through_session]


# -- pfmap, pfobj and the bake cache --------------------------------------------------


def _map_arrays(m):
    return {f.name: (v.tobytes(), v.dtype.str, v.shape)
            if isinstance(v := getattr(m, f.name), np.ndarray) else v
            for f in dataclasses.fields(m)}


def case_pfmap_demo():
    with open(os.path.join(_REPO, "assets", "maps", "demo.pfmap")) as f:
        text = f.read()

    def run(side):
        P = SIDES[side]["pfmap"]
        m = P.parse_pfmap(text)
        out = P.write_pfmap(m)
        return _map_arrays(m), out, _map_arrays(P.parse_pfmap(out))
    return _both(run)


def case_pfmap_battle():
    text = tpfmap.write_pfmap(make_battle_map())

    def run(side):
        P = SIDES[side]["pfmap"]
        m = P.parse_pfmap(text)
        cost, heights = P.compile_nav_costs(m)
        return (_map_arrays(m), P.write_pfmap(m), cost.tobytes(),
                heights.tobytes())
    want, got = _both(run)
    assert got[1] == text
    return want, got


def _seeded_pfobj_text() -> str:
    J, F, V = 3, 4, 6
    rng = np.random.default_rng(0)
    rots = rng.normal(size=(F, J, 4)).astype(np.float32)
    rots /= np.linalg.norm(rots, axis=-1, keepdims=True)
    clip = jpfobj.AnimClip("walk", F, rng.normal(size=(F, J, 3)).astype(
        np.float32), rots, np.ones((F, J, 3), np.float32),
        bboxes=rng.normal(size=(F, 2, 3)).astype(np.float32))
    bind = rng.normal(size=(J, 4)).astype(np.float32)
    bind /= np.linalg.norm(bind, axis=-1, keepdims=True)
    m = jpfobj.PFObj(
        verts=rng.normal(size=(V, 3)).astype(np.float32),
        uvs=rng.random((V, 2)).astype(np.float32),
        normals=rng.normal(size=(V, 3)).astype(np.float32),
        weight_joints=rng.integers(0, J, (V, 4)).astype(np.int32),
        weight_vals=rng.random((V, 4)).astype(np.float32),
        vert_mat=np.zeros(V, np.int32),
        materials=[jpfobj.Material("skin", 0.5, (1, 0, 0), (0, 0, 1),
                                   "skin.png")],
        joint_parents=np.array([-1, 0, 1], np.int32),
        joint_names=["root", "mid", "tip"],
        bind_trans=rng.normal(size=(J, 3)).astype(np.float32),
        bind_rots=bind, bind_scales=np.ones((J, 3), np.float32),
        clips={"walk": clip}, bbox=None)
    return jpfobj.write_pfobj(m)


def _obj_plain(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _obj_plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _obj_plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_obj_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return (x.tobytes(), x.dtype.str, x.shape)
    return x


def case_pfobj():
    text = _seeded_pfobj_text()

    def run(side):
        O = SIDES[side]["pfobj"]
        m = O.parse_pfobj(text)
        return _obj_plain(m), O.write_pfobj(m)
    return _both(run)


def case_bake_cache(tmp_path):
    """The port's cache parses to the port's classes and keys apart from the
    JAX cache's, so a JAX bake in the same directory is never handed out."""
    m = tpfmap.make_flat_map(1, 1)
    m.base_height[:, 16:] = 4
    text = tpfmap.write_pfmap(m)
    d = str(tmp_path)
    calls = []

    def parser(t):
        calls.append(1)
        return tpfmap.parse_pfmap(t)

    # the JAX cache bakes the same text first, into the same directory
    j = jcache.cached_parse("pfmap", text, jpfmap.parse_pfmap, cache_dir=d)
    assert tcache._key("pfmap", text) != jcache._key("pfmap", text)
    a = tcache.cached_parse("pfmap", text, parser, cache_dir=d)
    b = tcache.cached_parse("pfmap", text, parser, cache_dir=d)
    assert len(calls) == 1
    assert type(a) is tpfmap.MapData and type(b) is tpfmap.MapData
    obj_text = _seeded_pfobj_text()
    jcache.cached_parse("pfobj", obj_text, jpfobj.parse_pfobj, cache_dir=d)
    o = tcache.cached_parse("pfobj", obj_text, tpfobj.parse_pfobj, cache_dir=d)
    o2 = tcache.cached_parse("pfobj", obj_text, tpfobj.parse_pfobj, cache_dir=d)
    assert type(o) is tpfobj.PFObj and type(o2) is tpfobj.PFObj
    return ((_map_arrays(j), _obj_plain(jpfobj.parse_pfobj(obj_text))),
            (_map_arrays(a), _obj_plain(o)))


# -- ops/collision (tests/test_collision.py, on seeded batches) ---------------------------


def _collision_inputs(rng, n=64):
    d = rng.normal(size=3)
    center = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    return dict(
        origin=rng.uniform(-20, 20, 3).astype(np.float32),
        direction=(d / np.linalg.norm(d)).astype(np.float32),
        center=center,
        half=rng.uniform(0.5, 6, (n, 3)).astype(np.float32),
        yaw=rng.uniform(-np.pi, np.pi, n).astype(np.float32),
        lo=(center + rng.uniform(-9, 3, (n, 3))).astype(np.float32),
        sphere=rng.uniform(-30, 30, 3).astype(np.float32),
        p1=rng.uniform(-30, 30, 3).astype(np.float32))


def _collision_run(C, asarray, inp):
    a = {k: asarray(v) for k, v in inp.items()}
    hi = a["lo"] + a["half"]
    cam = jcam.Camera(pos=np.array([0.0, 50.0, 0.0]), pitch=-45.0, yaw=-90.0)
    planes = asarray(cam.frustum_planes().astype(np.float32))
    out = dict(
        ray_aabb=C.ray_aabb(a["origin"], a["direction"], a["lo"], hi),
        ray_obb=C.ray_obb(a["origin"], a["direction"], a["center"], a["half"],
                          a["yaw"]),
        sphere_obb=C.sphere_obb_test(a["sphere"], 7.5, a["center"], a["half"],
                                     a["yaw"]),
        frustum_obb=C.frustum_obb_test(planes, a["center"], a["half"],
                                       a["yaw"]),
        swept=C.swept_sphere_obb(a["sphere"], a["p1"], 2.0, a["center"],
                                 a["half"], a["yaw"], steps=8),
        aabb=C.aabb_aabb_test(a["lo"], hi, a["center"] - a["half"],
                              a["center"] + a["half"]),
        corners=C.obb_corners(a["center"], a["half"], a["yaw"]))
    flat = {}
    for k, v in out.items():
        if isinstance(v, tuple):
            flat[k + "_hit"], flat[k + "_t"] = v
        else:
            flat[k] = v
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in flat.items()}


def case_collision():
    rng = np.random.default_rng(11)
    inp = _collision_inputs(rng)
    want = _collision_run(jcol, jnp.asarray, inp)
    got = _collision_run(tcol, torch.from_numpy, inp)
    # the seeded batch holds hits and misses of every test
    for k in ("ray_obb_hit", "sphere_obb", "frustum_obb", "aabb"):
        assert want[k].any() and not want[k].all(), k
    return want, got


def case_collision_reference_scenes():
    """tests/test_collision.py's five cases, literally, on both."""
    def run(C, A):
        f = lambda *v: A(np.asarray(v, np.float32))  # noqa: E731
        cam = jcam.Camera(pos=np.array([0.0, 50.0, 0.0]), pitch=-45.0,
                          yaw=-90.0)
        res = [
            C.ray_aabb(f(0.0, 0, 0), f(1.0, 0, 0), f([5.0, -1, -1], [5.0, 2, 2]),
                       f([7.0, 1, 1], [7.0, 4, 4])),
            C.ray_obb(f(0.0, 0, 0), f(1.0, 0, 0), f([10.0, 0, 0]),
                      f([1.0, 1, 1]), f(np.pi / 4)),
            C.sphere_obb_test(f(0.0, 0, 2.4), 0.5, f([0.0, 0, 0]),
                              f([1.0, 1, 2]), f(0.0)),
            C.sphere_obb_test(f(0.0, 0, 2.6), 0.5, f([0.0, 0, 0]),
                              f([1.0, 1, 2]), f(0.0)),
            C.frustum_obb_test(A(cam.frustum_planes().astype(np.float32)),
                               f([0.0, 0.0, 50.0], [0.0, 0.0, -200.0]),
                               A(np.full((2, 3), 2.0, np.float32)),
                               A(np.zeros(2, np.float32))),
            C.swept_sphere_obb(f(-10.0, 0, 0), f(10.0, 0, 0), 0.5,
                               f([0.0, 0, 0]), f([1.0, 1, 1]), f(0.0),
                               steps=8),
            C.swept_sphere_obb(f(-10.0, 0, 10.0), f(10.0, 0, 10.0), 0.5,
                               f([0.0, 0, 0]), f([1.0, 1, 1]), f(0.0),
                               steps=8)]
        flat = []
        for r in res:
            flat += list(r) if isinstance(r, tuple) else [r]
        return [np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                for v in flat]
    want = run(jcol, jnp.asarray)
    got = run(tcol, torch.from_numpy)
    hit, t = got[0], got[1]
    assert hit[0] and not hit[1] and abs(t[0] - 5.0) < 1e-5
    assert got[2][0] and 8.4 < got[3][0] < 9.0
    assert got[4][0] and not got[5][0]
    assert got[6][0] and not got[6][1]
    assert got[7][0] and not got[8][0]
    return want, got


# -- the Engine parts pf calls ----------------------------------------------------------


def case_engine_additions():
    """``Engine(cfg=None)``, ``height_at`` at seeded points of a map with
    cliffs and a ramp, ``render_alpha`` frame by frame, and
    ``prewarm_nav`` (on the CPU it builds nothing)."""
    from permafrost_engine_tpu.core.config import EngineConfig
    from permafrost_engine_tpu.game.engine import Engine as JaxEngine
    from permafrost_engine_tpu_torch.game.engine import Engine
    from permafrost_engine_tpu_torch.ops import cuda_build

    default = Engine(device="cpu")
    assert dataclasses.asdict(default.cfg) == dataclasses.asdict(EngineConfig())
    rng = np.random.default_rng(3)
    points = rng.uniform(-20, 280, size=(64, 2))

    def run(side):
        P = SIDES[side]["pfmap"]
        m = P.make_flat_map(1, 1)
        m.base_height[:, 16:] = 4
        m.base_height[20:, :8] = -3
        m.tile_type[8, 15], m.ramp_height[8, 15] = 0x4, 4
        cfg = _small_cfg(side)
        eng = (JaxEngine(cfg) if side == "jax" else
               Engine(cfg, device="cpu"))
        eng.load_map_data(m)
        heights = [eng.height_at(tuple(p)) for p in points]
        alphas = []
        for _ in range(7):
            eng.step(1)
            alphas.append(eng.render_alpha)
        if side == "torch":
            libs = dict(cuda_build._LIBS)
            assert eng.prewarm_nav() is None and cuda_build._LIBS == libs
        return heights, alphas
    return _both(run)


def _equal(want, got, atol=None, path="") -> None:
    """want == got, recursively; arrays exactly, or within atol."""
    if isinstance(want, dict):
        assert want.keys() == got.keys(), path
        for k in want:
            _equal(want[k], got[k], atol, f"{path}.{k}")
    elif isinstance(want, (list, tuple)) and not isinstance(got, np.ndarray):
        assert len(want) == len(got), path
        for i, (a, b) in enumerate(zip(want, got)):
            _equal(a, b, atol, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        a, b = np.asarray(want), np.asarray(got)
        assert a.shape == b.shape, path
        if atol is None or a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=path)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=path)
    else:
        assert want == got, path


CASES = {
    "constants": case_constants,
    "ui_typed_style_attributes": case_ui_typed_style_attributes,
    "ui_scoped_button_style": case_ui_scoped_button_style,
    "ui_global_widget_styles": case_ui_global_widget_styles,
    "ui_styles_persist": case_ui_styles_persist,
    "ui_layout_window": case_ui_layout_window,
    "camera": case_camera,
    "pfmap_demo": case_pfmap_demo,
    "pfmap_battle": case_pfmap_battle,
    "pfobj": case_pfobj,
    "bake_cache": case_bake_cache,
    "collision": case_collision,
    "collision_reference_scenes": case_collision_reference_scenes,
    "engine_additions": case_engine_additions,
}
ATOL = {"collision": COLLISION_ATOL, "collision_reference_scenes":
        COLLISION_ATOL}


@pytest.mark.parametrize("name", list(CASES))
def test_support_module_matches_jax(name, tmp_path):
    case = CASES[name]
    args = (tmp_path,) if "tmp_path" in case.__code__.co_varnames[
        :case.__code__.co_argcount] else ()
    want, got = case(*args)
    _equal(want, got, ATOL.get(name))


@pytest.mark.parametrize("scenario", TASKS, ids=lambda f: f.__name__)
def test_task_scenario_matches_jax(scenario, tmp_path):
    args = (tmp_path,) if scenario.__code__.co_argcount == 2 else ()
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = scenario("jax", *[a / "jax" for a in args])
    got = scenario("torch", *[a / "torch" for a in args])
    _equal(want, got)
