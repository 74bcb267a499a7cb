"""The `pf` scripting module — the engine's Python API surface.

Mirrors the reference's embedded `pf` module (ref: src/script/py_script.c:
305-1044 method table; docs/python_api.txt), re-exposing all function
groups over the engine: world/scene, events/tasks, cameras,
profiling, video, input/UI, files, fog/regions, selection, economy,
factions/diplomacy, tiles, minimap, click-mode orders, storage/garrison UI,
settings, sim-state/session, cursors, spatial queries, audio,
combat/movement orders, and sprites.

Usage:
    from permafrost_engine_tpu_torch.script import pf
    pf.init()                      # or pf.init(engine=my_engine)
    ent = pf.MovableEntity("mage.pfobj", "mage", pos=(10, 0, 10))
    ent.move((100, 0, 100))
    pf.step(60)

Port of ``permafrost_engine_tpu/script/pf.py``. ``pf.init`` builds its
``Engine`` on the card unless the caller passes ``device="cpu"``. Queries
over the arena (selection, idle units, spatial queries, tiles under an
object) take their columns through ``Engine.ents_host`` and the faction
queries through ``Engine.host_copies``: one synchronization per call.
Writes between segments (fog toggles, factions, projectiles) go in place
into the engine's tensors, so a CUDA graph replays them in its next
segment. Deliberate differences: ``get_render_info`` and
``prev_frame_gpu_stats`` name the torch device, and the version string
ends in ``-cuda``. ``dump_framebuffer`` renders through the port's
rasterizer (``render/scene.py``) on the engine's device.
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
import random as _random
import sys
import time as _time

import numpy as np
import torch

from permafrost_engine_tpu_torch.core.config import (
    CombatStance,
    DiplomacyState,
    EngineConfig,
    EntityFlags,
    FogState,
    MoveState,
    NavDomain,
    SimState,
)
from permafrost_engine_tpu_torch.core.events import ES_ALL, ES_RUNNING, EventType
from permafrost_engine_tpu_torch.game.engine import Engine
from permafrost_engine_tpu_torch.game.formation import FormationType
from permafrost_engine_tpu_torch.render.camera import Camera, CameraMode
from permafrost_engine_tpu_torch.script.ui import UISystem, Window  # noqa: F401

# re-export the entity classes and Task on the module (pf.Entity, ...)
from permafrost_engine_tpu_torch.script.entity import (  # noqa: F401
    AirEntity,
    AnimEntity,
    BuildableEntity,
    BuilderEntity,
    CombatableEntity,
    Entity,
    GarrisonableEntity,
    GarrisonEntity,
    HarvesterEntity,
    MovableEntity,
    PopulationContributorEntity,
    PopulationLimitContributorEntity,
    ResourceEntity,
    StorageSiteEntity,
    WaterEntity,
)
from permafrost_engine_tpu_torch.script.task import Task  # noqa: F401

__version__ = "1.16.0-cuda"

# ---------------------------------------------------------------------------
# Exported constants (the reference exposes ~781 via PY_EXPOSE_ENUM,
# ref: src/script/py_constants.c)
# ---------------------------------------------------------------------------

for _e in EventType:
    globals()[f"EVENT_{_e.name}"] = int(_e)
for _e in CombatStance:
    globals()[f"COMBAT_STANCE_{_e.name}"] = int(_e)
for _e in DiplomacyState:
    globals()[f"DIPLOMACY_STATE_{_e.name}"] = int(_e)
for _e in FormationType:
    globals()[f"FORMATION_{_e.name}"] = int(_e)
for _e in SimState:
    globals()[f"G_{_e.name}"] = int(_e)
for _e in NavDomain:
    globals()[f"NAV_DOMAIN_{_e.name}"] = int(_e)
for _e in FogState:
    globals()[f"FOG_{_e.name}"] = int(_e)

ANIM_LOOP, ANIM_ONCE = 0, 1
CAM_MODE_FPS = CameraMode.FPS
CAM_MODE_RTS = CameraMode.RTS
CAM_MODE_FREE = CameraMode.FREE

# The full constant surface — SDL scancodes/keycodes/keymods/events,
# cursor kinds, tile types, nuklear UI enums, engine enum families
# (ref: src/script/py_constants.c exposes ~781 names; constants.py
# generates the same tables).
from permafrost_engine_tpu_torch.script import constants as _constants  # noqa: E402

_constants.export_into(globals())

# Reference spellings for the tick/region/selection events whose internal
# enum names differ (Python identifiers can't start with a digit):
EVENT_60HZ_TICK = int(EventType.TICK_60HZ)
EVENT_30HZ_TICK = int(EventType.TICK_30HZ)
EVENT_20HZ_TICK = int(EventType.TICK_20HZ)
EVENT_15HZ_TICK = int(EventType.TICK_15HZ)
EVENT_10HZ_TICK = int(EventType.TICK_10HZ)
EVENT_5HZ_TICK = int(EventType.TICK_5HZ)
EVENT_1HZ_TICK = int(EventType.TICK_1HZ)
EVENT_HALFHZ_TICK = int(EventType.TICK_HALFHZ)
EVENT_ENTERED_REGION = int(EventType.REGION_ENTERED)
EVENT_EXITED_REGION = int(EventType.REGION_EXITED)
EVENT_UNIT_SELECTION_CHANGED = int(EventType.SELECTION_CHANGED)
EVENT_BUILDING_FOUNDED = int(EventType.BUILDING_FOUNDED)
EVENT_BUILDING_COMPLETED = int(EventType.BUILDING_COMPLETED)

# ANCHOR_* values come from ui.py (our canonical layout-anchor bits)
from permafrost_engine_tpu_torch.script import ui as _ui  # noqa: E402

ANCHOR_X_LEFT = _ui.ANCHOR_X_LEFT
ANCHOR_X_RIGHT = _ui.ANCHOR_X_RIGHT
ANCHOR_X_CENTER = _ui.ANCHOR_X_CENTER
ANCHOR_X_MASK = ANCHOR_X_LEFT | ANCHOR_X_RIGHT | ANCHOR_X_CENTER
ANCHOR_Y_TOP = _ui.ANCHOR_Y_TOP
ANCHOR_Y_BOT = _ui.ANCHOR_Y_BOT
ANCHOR_Y_CENTER = _ui.ANCHOR_Y_CENTER
ANCHOR_Y_MASK = ANCHOR_Y_TOP | ANCHOR_Y_BOT | ANCHOR_Y_CENTER
ANCHOR_DEFAULT = _ui.ANCHOR_DEFAULT

# Per-widget-class UI style mirror (ref: py_ui_style.c:6382-6512): the
# style classes plus one live module-level instance per widget, exactly
# the names the reference registers (scripts do
# `setattr(pf.button_style, ...)` / `with ButtonStyle(...)`).
from permafrost_engine_tpu_torch.script import ui_style  # noqa: E402
from permafrost_engine_tpu_torch.script.ui_style import (  # noqa: F401,E402
    UIButtonStyle,
    UIComboStyle,
    UIEditStyle,
    UIHeaderStyle,
    UIPropertyStyle,
    UIProgressStyle,
    UIScrollbarStyle,
    UISelectableStyle,
    UISliderStyle,
    UIToggleStyle,
    UIWindowStyle,
)

button_style = ui_style.STYLES["button_style"]
contextual_button_style = ui_style.STYLES["contextual_button_style"]
menu_button_style = ui_style.STYLES["menu_button_style"]
selectable_style = ui_style.STYLES["selectable_style"]
combo_style = ui_style.STYLES["combo_style"]
option_style = ui_style.STYLES["option_style"]
checkbox_style = ui_style.STYLES["checkbox_style"]
scrollbar_horizontal_style = ui_style.STYLES["scrollbar_horizontal_style"]
scrollbar_vertical_style = ui_style.STYLES["scrollbar_vertical_style"]
edit_style = ui_style.STYLES["edit_style"]
property_style = ui_style.STYLES["property_style"]
slider_style = ui_style.STYLES["slider_style"]
progress_style = ui_style.STYLES["progress_style"]
window_style = ui_style.STYLES["window_style"]
window_header_style = ui_style.STYLES["window_header_style"]


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClickModes:
    move: bool = False
    attack: bool = False
    build: bool = False
    gather: bool = False
    pick_up: bool = False
    drop_off: bool = False
    transport: bool = False
    evict: bool = False
    rally_point: bool = False
    click_move_enabled: bool = True


class PfContext:
    def __init__(self, engine: Engine, basedir: str = "."):
        self.engine = engine
        self.basedir = basedir
        self.entities: dict[int, object] = {}   # uid -> weakref(Entity)
        self.tasks: dict[int, Task] = {}
        self.ui = UISystem()
        self.ui_windows: dict[str, Window] = {}
        self.cameras = [Camera(mode=CameraMode.RTS), Camera(mode=CameraMode.FPS)]
        self.active_camera = 0
        self.rts_zoom_enabled = True
        self.click_modes = ClickModes()
        self.player_faction = 0
        self.mouse_pos = (0, 0)
        self.keys_down: set[int] = set()
        self.cursor = {"rts_mode": False, "active": "default", "named": {}}
        self.minimap = {"position": (10, 950), "size": 256,
                        "border_clr": (0, 0, 0, 255), "render_all": False,
                        "resize_mask": 0, "shown": True}
        self.healthbars = True
        self.unit_icons = True
        self.show_regions_flag = False
        self.skybox = None
        self.lighting = {"ambient": (1.0, 1.0, 1.0),
                         "emit_color": (1.0, 1.0, 1.0),
                         "emit_pos": (120.0, 150.0, 120.0)}
        self.storage_ui = {"style": {}, "border_color": (0, 0, 0, 255),
                           "font_color": (255, 255, 255, 255), "shown": {}}
        self.garrison_ui = {"style": {}, "font_color": (255, 255, 255, 255),
                            "icon": None, "shown": {}}
        self.console_shown = False
        self.highlight_size = 1
        self.session_stack = []
        self.models: dict[str, object] = {}
        self.start_ticks = _time.monotonic()
        self._register_settings()

    def _register_settings(self) -> None:
        """The reference registers ~60 pf.* settings across subsystems
        (SURVEY Appendix B)."""
        from permafrost_engine_tpu_torch.core.settings import SettingType as T
        s = self.engine.settings
        video = [("pf.video.aspect_ratio", T.FLOAT, 16 / 9),
                 ("pf.video.display_mode", T.INT, 0),
                 ("pf.video.resolution", T.VEC2, [1920, 1080]),
                 ("pf.video.vsync", T.BOOL, True),
                 ("pf.video.shadows_enabled", T.BOOL, True),
                 ("pf.video.lod_enabled", T.BOOL, True),
                 ("pf.video.lod_dist1", T.FLOAT, 200.0),
                 ("pf.video.lod_dist2", T.FLOAT, 400.0),
                 ("pf.video.use_batch_rendering", T.BOOL, True),
                 ("pf.video.water_reflection", T.BOOL, True),
                 ("pf.video.water_refraction", T.BOOL, True),
                 ("pf.video.water_prune_radius", T.FLOAT, 300.0),
                 ("pf.video.water_rt_scale", T.FLOAT, 1.0),
                 ("pf.video.window_always_on_top", T.BOOL, False)]
        game = [("pf.game.camera_projection", T.INT, 0),
                ("pf.game.camera_tilt", T.FLOAT, -65.0),
                ("pf.game.combat_hz", T.INT, 10),
                ("pf.game.default_camera_zoom", T.FLOAT, 120.0),
                ("pf.game.fog_of_war_enabled", T.BOOL, True),
                ("pf.game.healthbar_mode", T.INT, 1),
                ("pf.game.movement_hz", T.INT, 20),
                ("pf.game.movement_use_gpu", T.BOOL, True),
                ("pf.game.show_map_foliage", T.BOOL, True),
                ("pf.game.storage_site_ui_mode", T.INT, 0)]
        audio = [("pf.audio.master_volume", T.FLOAT, 1.0),
                 ("pf.audio.music_volume", T.FLOAT, 1.0),
                 ("pf.audio.effect_volume", T.FLOAT, 1.0),
                 ("pf.audio.music_playback_mode", T.INT, 0),
                 ("pf.audio.mute_on_focus_loss", T.BOOL, False)]
        debug = [(f"pf.debug.{name}", T.BOOL, False) for name in (
            "show_nav_cost_base", "show_nav_islands", "show_nav_portals",
            "show_nav_blockers", "show_flow_fields", "show_enemy_seek_fields",
            "show_arrival_fields", "show_formations", "show_combat_ranges",
            "show_combat_targets", "show_harvester_state",
            "show_automation_state", "show_hrvo_debug", "show_faction_vision",
            "show_chunk_boundaries", "trace_gpu", "trace_gpu_stalls",
            "trace_python", "log_call_graphs", "log_mem_stats", "log_python",
            "paused_frame_step_enabled")] + [
            ("pf.debug.navigation_layer", T.INT, 0),
            ("pf.debug.formation_cell_index", T.INT, 0),
            ("pf.debug.enemy_seek_fields_faction_id", T.INT, 0),
            ("pf.debug.render_log_mask", T.INT, 0)]
        for name, t, v in video + game + audio + debug:
            s.create(name, t, v)


_context: PfContext | None = None


def init(cfg: EngineConfig | None = None, *, engine: Engine | None = None,
         basedir: str = ".", device="cuda") -> PfContext:
    """Start the script layer over `engine`, or over a new ``Engine(cfg)``
    on `device` (the card unless the caller asks for ``"cpu"``)."""
    global _context
    _context = PfContext(engine or Engine(cfg, device=device), basedir=basedir)
    return _context


def context() -> PfContext:
    if _context is None:
        init()
    return _context


def step(n_frames: int = 1) -> None:
    """Advance the engine (the script-side frame loop)."""
    ctx = context()
    ctx.engine.step(n_frames)
    ctx.ui.render_all(ctx.ui_windows)


def _eng() -> Engine:
    return context().engine


def _ent_obj(uid: int):
    ref = context().entities.get(uid)
    ent = ref() if ref is not None else None
    if ent is None and uid in _eng().uid_to_slot:
        ent = Entity.__new__(Entity)
        ent.uid = uid
        ent.name = ""
        ent.pfobj_path = ""
        ent.tags = set()
    return ent


# ---------------------------------------------------------------------------
# World / scene
# ---------------------------------------------------------------------------


def load_map(path: str) -> bool:
    from permafrost_engine_tpu_torch.assets.cache import cached_parse
    from permafrost_engine_tpu_torch.assets.pfmap import parse_pfmap
    with open(os.path.join(context().basedir, path)) as f:
        _eng().load_map_data(cached_parse("pfmap", f.read(), parse_pfmap))
    _eng().bus.notify(int(EventType.NEW_GAME), path)
    return True


def load_map_string(text: str) -> bool:
    from permafrost_engine_tpu_torch.assets.pfmap import parse_pfmap
    _eng().load_map_data(parse_pfmap(text))
    _eng().bus.notify(int(EventType.NEW_GAME), None)
    return True


def load_scene(path: str, classes: dict | None = None) -> list:
    """Load a .pfscene: one entity per line,
    `<ClassName> <name> <pfobj> <x> <y> <z> [key=value ...]`
    (the reference's attr-record scene format reduced to its content).
    `classes` maps scene class names to game-script entity classes (the
    reference resolves attr-record class names against the loaded script
    modules the same way); pf's own classes are the fallback."""
    out = []
    classes = classes or {}
    with open(os.path.join(context().basedir, path)) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cls = classes.get(parts[0]) or globals().get(parts[0], Entity)
            kw = {}
            for kv in parts[6:]:
                k, v = kv.split("=")
                try:
                    kw[k] = float(v) if "." in v else int(v)
                except ValueError:
                    kw[k] = v
            ent = cls(parts[2], parts[1],
                      pos=(float(parts[3]), float(parts[4]), float(parts[5])),
                      **kw)
            out.append(ent)
    return out


def preload_pfobj(path: str) -> bool:
    from permafrost_engine_tpu_torch.assets.cache import cached_parse
    from permafrost_engine_tpu_torch.assets.pfobj import parse_pfobj
    full = os.path.join(context().basedir, path)
    with open(full) as f:
        model = cached_parse("pfobj", f.read(), parse_pfobj)
    context().models[path] = model
    _eng().anim.load_model(path, model)
    return True


def set_skybox(dirname: str) -> None:
    context().skybox = dirname


def set_ambient_light_color(rgb) -> None:
    context().lighting["ambient"] = tuple(rgb)


def set_emit_light_color(rgb) -> None:
    context().lighting["emit_color"] = tuple(rgb)


def set_emit_light_pos(xyz) -> None:
    context().lighting["emit_pos"] = tuple(xyz)


def map_add_splat(base: int, accent: int) -> None:
    md = _eng().map_data
    if md is not None:
        md.splats.append((base, accent))


def map_remove_splat(base: int, accent: int) -> None:
    md = _eng().map_data
    if md is not None and (base, accent) in md.splats:
        md.splats.remove((base, accent))


# ---------------------------------------------------------------------------
# Events / tasks
# ---------------------------------------------------------------------------


def register_event_handler(event: int, handler, arg=None) -> None:
    wrapped = (lambda a, h=handler, x=arg: h(x, a)) if arg is not None else handler
    _eng().bus.subscribe(event, wrapped, mask=ES_RUNNING)


def register_ui_event_handler(event: int, handler, arg=None) -> None:
    wrapped = (lambda a, h=handler, x=arg: h(x, a)) if arg is not None else handler
    _eng().bus.subscribe(event, wrapped, mask=ES_ALL)


def unregister_event_handler(event: int, handler) -> None:
    _eng().bus.unsubscribe(event, handler)


def global_event(event: int, arg=None) -> None:
    _eng().bus.notify(event, arg)


def flush_tasks() -> None:
    sched = _eng().sched
    for _ in range(1000):
        if not sched.tasks or sched.tick() == 0:
            break


def get_ticks() -> int:
    return int(_eng().state.tick)


def ticks_delta(a: int, b: int) -> int:
    return b - a


# ---------------------------------------------------------------------------
# Cameras
# ---------------------------------------------------------------------------


def get_active_camera() -> Camera:
    ctx = context()
    return ctx.cameras[ctx.active_camera]


def set_active_camera(cam: Camera) -> None:
    # identity, not ==: Camera is a dataclass with ndarray fields, whose
    # __eq__ returns arrays (ambiguous truth value)
    ctx = context()
    for i, c in enumerate(ctx.cameras):
        if c is cam:
            ctx.active_camera = i
            return
    ctx.cameras.append(cam)
    ctx.active_camera = len(ctx.cameras) - 1


def set_rts_camera_zoom_enabled(on: bool) -> None:
    context().rts_zoom_enabled = bool(on)


def get_rts_camera_zoom_enabled() -> bool:
    return context().rts_zoom_enabled


# ---------------------------------------------------------------------------
# Profiling / memory (ref: pf.prev_frame_* py_script.c:396-433)
# ---------------------------------------------------------------------------


def prev_frame_ms() -> float:
    return _eng().perf.prev_frame_ms()


def prev_frame_perfstats() -> list:
    return _eng().perf.prev_frame_perfstats()


def prev_frame_memstats() -> dict:
    import resource
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"host_rss_kb": ru.ru_maxrss}


def prev_frame_vramstats() -> dict:
    from permafrost_engine_tpu_torch.state.schema import state_byte_size
    return {"hbm_state_bytes": state_byte_size(_eng().state)}


def prev_frame_gpu_stats() -> dict:
    return {"device": _eng().device.type, "counters": dict(_eng().perf.counters)}


def prev_frame_mem_accounting() -> dict:
    """Per-subsystem byte accounting (ref: mem.h PF_MALLOC_TAGGED)."""
    from permafrost_engine_tpu_torch.state.schema import state_mem_accounting
    return {**prev_frame_memstats(),
            "hbm_by_subsystem": state_mem_accounting(_eng().state)}


def prev_frame_gpu_mem_accounting() -> dict:
    return prev_frame_vramstats()


def mem_audit() -> dict:
    return {**prev_frame_memstats(), **prev_frame_vramstats()}


def prev_frame_allocd_bytes() -> int:
    return prev_frame_vramstats()["hbm_state_bytes"]


def get_nav_perfstats() -> dict:
    """Field-cache hit rates (ref: struct fc_stats, nav.h:55-70)."""
    return dict(_eng().nav.stats, **_eng().nav.flow_cache.stats)


# ---------------------------------------------------------------------------
# Video / window
# ---------------------------------------------------------------------------


def get_resolution():
    return tuple(_eng().settings.get("pf.video.resolution"))


def get_native_resolution():
    return (1920, 1080)


def get_render_info() -> dict:
    d = _eng().device
    name = torch.cuda.get_device_name(d) if d.type == "cuda" else "cpu"
    return {"renderer": f"torch:{d.type}", "device": f"{d} ({name})",
            "version": torch.__version__}


def get_render_settings() -> dict:
    s = _eng().settings
    return {k: s.get(k) for k in s.names() if k.startswith("pf.video.")}


def dump_framebuffer(path: str, minimap: bool = False) -> bool:
    """Dump a rendered frame from the active camera through the
    rasterizer (render/scene.py; pass minimap=True for the top-down
    minimap raster instead). Writes a real image when the extension is
    one (png/bmp/jpg, ref: stb_image_write; needs Pillow), else .npy."""
    if minimap:
        from permafrost_engine_tpu_torch.render.draw import minimap_raster
        frame = minimap_raster(_eng())
    else:
        from permafrost_engine_tpu_torch.render.scene import render_frame
        frame = render_frame(_eng(), get_active_camera())
    if path.lower().endswith((".png", ".bmp", ".jpg", ".jpeg", ".tga")):
        from permafrost_engine_tpu_torch.utils.image import write_image
        write_image(path, frame)
    else:
        np.save(path, frame)
    return True


def get_version_string() -> str:
    return __version__


# ---------------------------------------------------------------------------
# Input / UI
# ---------------------------------------------------------------------------


def get_mouse_pos():
    return context().mouse_pos


def mouse_over_ui() -> bool:
    x, y = context().mouse_pos
    for w in context().ui_windows.values():
        wx, wy, ww, wh = w.rect
        if w.shown and wx <= x <= wx + ww and wy <= y <= wy + wh:
            return True
    return False


def ui_text_edit_has_focus() -> bool:
    return context().ui.text_edit_focus


def get_active_window() -> str | None:
    names = [n for n, w in context().ui_windows.items() if w.shown]
    return names[0] if names else None


def shift_pressed() -> bool:
    return globals()["SDL_SCANCODE_LSHIFT"] in context().keys_down


def ctrl_pressed() -> bool:
    return globals()["SDL_SCANCODE_LCTRL"] in context().keys_down


def get_key_name(scancode: int) -> str:
    for k, v in _constants.SDL_SCANCODES.items():
        if v == scancode:
            return k
    return f"KEY_{scancode}"


# ---------------------------------------------------------------------------
# Input injection — the SDL-event pipeline analogue (ref: main.c
# process_sdl_events -> ui/event dispatch -> G_Sel_Update / move orders).
# Coordinates are in the UI virtual resolution (the engine's one screen
# space; real front-ends scale their window into it).
# ---------------------------------------------------------------------------


def _ground_under(x: float, y: float):
    ctx = context()
    vw, vh = ctx.ui.virtual_resolution
    return get_active_camera().ground_point(x, y, vw, vh)


def _sel_arrays():
    h = _eng().ents_host("pos", "sel_radius", "flags", "alive")
    return (_eng()._slot_uid, h["pos"], h["sel_radius"], h["flags"],
            h["alive"])


def inject_mouse_motion(x: float, y: float) -> None:
    """Move the cursor: updates mouse_pos and the hovered entity."""
    ctx = context()
    ctx.mouse_pos = (x, y)
    wp = _ground_under(x, y)
    if wp is not None and ctx.engine is not None:
        uids, pos, rad, flags, alive = _sel_arrays()
        ctx.engine.selection.update_hovered((wp[0], wp[2]), uids, pos, rad,
                                            flags, alive)
    _eng().bus.notify_immediate(SDL_MOUSEMOTION, {"pos": (x, y)},
                                simstate=_eng().sim_state)


def inject_mouse_click(x: float, y: float, button: int = 1) -> str:
    """Dispatch a click: UI first (widget routing), then armed click-mode
    orders, then unit selection / click-move. Returns what consumed it:
    'ui' | 'order:<mode>' | 'select' | 'move' | 'none'. Script handlers
    registered on SDL_MOUSEBUTTONDOWN see every click (with the consumed
    verdict), mirroring the reference's SDL event fan-out."""
    consumed = _inject_mouse_click_impl(x, y, button)
    _notify_mouse_button(x, y, button, consumed)
    return consumed


def _inject_mouse_click_impl(x: float, y: float, button: int = 1) -> str:
    ctx = context()
    ctx.mouse_pos = (x, y)
    if ctx.ui.route_click(ctx.ui_windows, (x, y), ctx.ui.virtual_resolution):
        return "ui"
    eng = ctx.engine
    wp = _ground_under(x, y)
    if eng is None or wp is None:
        return "none"
    xz = (wp[0], wp[2])
    sel = list(eng.selection.selection)
    from permafrost_engine_tpu_torch.core.events import EventType

    if button == 1:
        armed = [m for m in ("move", "attack", "build", "gather", "pick_up",
                             "drop_off", "transport", "evict", "rally_point")
                 if getattr(ctx.click_modes, m, False)]
        if armed:
            mode = armed[0]
            setattr(ctx.click_modes, mode, False)     # one-shot arm
            hovered = eng.selection.hovered
            eng.bus.notify(EventType.ORDER_ISSUED,
                           {"mode": mode, "pos": wp, "target": hovered,
                            "selection": sel})
            if sel:
                if mode == "move":
                    eng.move(sel, xz)
                elif mode == "attack":
                    eng.seek_enemies(sel)
            return f"order:{mode}"
        uids, pos, rad, flags, alive = _sel_arrays()
        if eng.selection.enabled:
            eng.selection.click_select(xz, uids, pos, rad, flags, alive,
                                       additive=shift_pressed())
        return "select"

    if button == 3 and getattr(ctx.click_modes, "click_move_enabled", True) \
            and sel:
        movable = [u for u in sel
                   if eng.uid_to_slot.get(u) is not None]
        if movable:
            eng.move(movable, xz)
            eng.bus.notify(EventType.ORDER_ISSUED,
                           {"mode": "move", "pos": wp, "target": None,
                            "selection": movable})
            return "move"
    return "none"


def _notify_mouse_button(x: float, y: float, button: int,
                         consumed: str) -> None:
    _eng().bus.notify_immediate(
        SDL_MOUSEBUTTONDOWN,
        {"pos": (x, y), "button": button, "consumed": consumed},
        simstate=_eng().sim_state)


def inject_mouse_drag(x0: float, y0: float, x1: float, y1: float) -> list:
    """Box selection between two virtual-resolution corners
    (ref: G_Sel drag box, src/game/selection.c)."""
    ctx = context()
    eng = ctx.engine
    a = _ground_under(x0, y0)
    b = _ground_under(x1, y1)
    if eng is None or a is None or b is None or not eng.selection.enabled:
        return []
    uids, pos, rad, flags, alive = _sel_arrays()
    return eng.selection.box_select(
        (a[0], a[2]), (b[0], b[2]), uids, pos, flags, alive,
        additive=shift_pressed())


def inject_key_down(scancode: int) -> None:
    """Press a key: updates the modifier set and dispatches SDL_KEYDOWN to
    registered script handlers, event payload (scancode,) — the tuple shape
    the reference's handlers index as event[0] (ref: scripts/rts/main.py
    toggle_camera/toggle_pause)."""
    context().keys_down.add(int(scancode))
    _eng().bus.notify_immediate(SDL_KEYDOWN, (int(scancode),),
                                simstate=_eng().sim_state)
    # paused frame-stepping (ref: main.c:337-350 — with
    # pf.debug.paused_frame_step_enabled, SPACE while paused advances
    # exactly one simulation frame)
    from permafrost_engine_tpu_torch.core.config import SimState
    from permafrost_engine_tpu_torch.script.constants import SDL_SCANCODES

    eng = _eng()
    try:
        step_on = bool(eng.settings.get("pf.debug.paused_frame_step_enabled"))
    except Exception:
        step_on = False
    if (step_on and int(scancode) == SDL_SCANCODES["SPACE"]
            and eng.sim_state != SimState.RUNNING):
        prev = eng.sim_state
        eng.sim_state = SimState.RUNNING
        try:
            eng.step(1)
        finally:
            eng.sim_state = prev


def inject_key_up(scancode: int) -> None:
    context().keys_down.discard(int(scancode))
    _eng().bus.notify_immediate(SDL_KEYUP, (int(scancode),),
                                simstate=_eng().sim_state)


def inject_text_input(text: str) -> bool:
    """Feed typed characters to the focused UI text edit ('\\b' erases,
    newline commits/unfocuses)."""
    ctx = context()
    any_routed = False
    for ch in text:
        any_routed = ctx.ui.route_char(ch) or any_routed
    return any_routed


def get_active_font() -> str:
    return context().ui.active_font


def set_active_font(name: str) -> bool:
    context().ui.fonts.add(name)
    context().ui.active_font = name
    return True


def draw_text(text: str, rect, color=(255, 255, 255, 255)) -> None:
    context().ui_windows.setdefault(
        "__overlay__", Window("__overlay__", (0, 0, 1920, 1080), 0))
    # overlay draw list records raw text draws
    w = context().ui_windows["__overlay__"]
    w.shown = True
    w.draw_list.append(("text", text, tuple(rect), tuple(color)))


def show_console() -> None:
    context().console_shown = True


def console_eval(source: str) -> str:
    """In-game interactive console (ref: py_console.c): evaluate source
    against a namespace with `pf` bound."""
    import code
    buf = io.StringIO()
    ns = {"pf": __import__("permafrost_engine_tpu_torch.script.pf",
                           fromlist=["pf"])}
    try:
        try:
            result = eval(source, ns)  # noqa: S307 - interactive console
            if result is not None:
                buf.write(repr(result))
        except SyntaxError:
            exec(source, ns)  # noqa: S102
    except Exception as e:  # pragma: no cover - console surface
        buf.write(f"{type(e).__name__}: {e}")
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------


def get_basedir() -> str:
    return context().basedir


def get_file_size(path: str) -> int:
    return os.path.getsize(os.path.join(context().basedir, path))


def get_files_in_dir(path: str) -> list[str]:
    return sorted(os.listdir(os.path.join(context().basedir, path)))


def get_time_str() -> str:
    return _time.strftime("%Y-%m-%d %H:%M:%S")


def ensure_directory(path: str) -> bool:
    os.makedirs(os.path.join(context().basedir, path), exist_ok=True)
    return True


def delete_user_file(path: str) -> bool:
    try:
        os.remove(os.path.join(context().basedir, path))
        return True
    except OSError:
        return False


def open_url(url: str) -> None:
    pass  # zero-egress environment; parity no-op


# ---------------------------------------------------------------------------
# Fog of war / regions
# ---------------------------------------------------------------------------


# the fog writes are in place: ``fog.enabled`` stays a bool tensor on the
# engine's device, the buffer a captured segment reads


def enable_fog_of_war() -> None:
    _eng().state.fog.enabled.fill_(True)


def disable_fog_of_war() -> None:
    _eng().state.fog.enabled.fill_(False)


def explore_map(faction_id: int) -> None:
    _eng().state.fog.state[faction_id].clamp_(min=int(FogState.IN_FOG))


def show_regions() -> None:
    context().show_regions_flag = True


def hide_regions() -> None:
    context().show_regions_flag = False


class Region:
    """pf.Region — named dynamic region (ref: py_region.c)."""

    def __init__(self, name: str, pos, *, radius: float | None = None,
                 dims: tuple | None = None):
        sys = _eng().regions
        xz = (pos[0], pos[2]) if len(pos) == 3 else tuple(pos)
        if radius is not None:
            sys.add_circle(name, xz, radius)
        else:
            sys.add_rect(name, xz, dims[0], dims[1])
        self.name = name

    @property
    def entities(self) -> list[int]:
        return _eng().regions.ents_in(self.name)

    def delete(self) -> None:
        _eng().regions.remove(self.name)


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------


def enable_unit_selection() -> None:
    _eng().selection.enabled = True


def disable_unit_selection() -> None:
    _eng().selection.enabled = False


def clear_unit_selection() -> None:
    _eng().selection.clear()


def get_unit_selection() -> list:
    return [_ent_obj(u) for u in _eng().selection.selection]


def set_unit_selection(ents: list) -> None:
    _eng().selection.set_selection(
        [e.uid if hasattr(e, "uid") else int(e) for e in ents])


def get_hovered_unit():
    h = _eng().selection.hovered
    return _ent_obj(h) if h is not None else None


def get_idle_units(faction_id: int | None = None) -> list:
    h = _eng().ents_host("alive", "movestate", "combatstate", "faction",
                         "flags", "uid")
    idle = h["alive"] & (h["movestate"] == int(MoveState.ARRIVED)) & \
        (h["combatstate"] == 0) & ((h["flags"] & int(EntityFlags.MOVABLE)) != 0)
    if faction_id is not None:
        idle &= h["faction"] == faction_id
    return [_ent_obj(int(u)) for u in h["uid"][idle]]


def entities_for_tag(tag: str) -> list:
    out = []
    for uid, ref in context().entities.items():
        ent = ref()
        if ent is not None and tag in ent.tags:
            out.append(ent)
    return out


def hide_healthbars() -> None:
    context().healthbars = False


def show_healthbars() -> None:
    context().healthbars = True


def hide_unit_icons() -> None:
    context().unit_icons = False


def show_unit_icons() -> None:
    context().unit_icons = True


# ---------------------------------------------------------------------------
# Resources / economy
# ---------------------------------------------------------------------------


def get_resource_list() -> list[str]:
    return _eng().economy.resource_names()


def get_resource_stored(faction_id: int, name: str) -> int:
    return _eng().economy.stored_of(faction_id, name)


def get_resource_capacity(faction_id: int, name: str) -> int:
    return _eng().economy.capacity_of(faction_id, name)


def set_resource_icon(name: str, icon: str) -> None:
    _eng().economy.resource_icons[name] = icon


def get_resource_icon(name: str) -> str | None:
    return _eng().economy.resource_icons.get(name)


# ---------------------------------------------------------------------------
# Factions / diplomacy / population
# ---------------------------------------------------------------------------

_faction_meta: dict[int, dict] = {}


def _factions(*names: str) -> dict[str, np.ndarray]:
    """Host copies of faction-table fields, one synchronization."""
    eng = _eng()
    return eng.host_copies(eng.state.factions, *names)


def get_factions_list() -> list[dict]:
    ft = _factions("active", "controllable")
    out = []
    for f in np.nonzero(ft["active"])[0]:
        meta = _faction_meta.get(int(f), {})
        out.append({"id": int(f), "name": meta.get("name", f"faction{f}"),
                    "color": meta.get("color", (255, 255, 255)),
                    "controllable": bool(ft["controllable"][f])})
    return out


def add_faction(name: str, color=(255, 255, 255), controllable=True) -> int:
    eng = _eng()
    fid = int(np.argmin(_factions("active")["active"]))
    eng.add_faction(fid, controllable)
    _faction_meta[fid] = {"name": name, "color": tuple(color)}
    return fid


def remove_faction(fid: int) -> None:
    _eng().state.factions.active[fid] = False
    _faction_meta.pop(fid, None)


def update_faction(fid: int, name: str, color) -> None:
    _faction_meta[fid] = {"name": name, "color": tuple(color)}


def set_faction_controllable(fid: int, on: bool) -> None:
    _eng().state.factions.controllable[fid] = bool(on)


def set_diplomacy_state(f1: int, f2: int, state: int) -> None:
    _eng().set_diplomacy(f1, f2, state)


def get_diplomacy_state(f1: int, f2: int) -> int:
    return int(_eng().state.factions.diplomacy[f1, f2].item())


def get_population(fid: int) -> int:
    return _eng().economy.population_of(fid)


def get_population_limit(fid: int) -> int:
    return _eng().economy.population_limit_of(fid)


def get_allied_population(fid: int) -> int:
    ft = _factions("diplomacy", "active")
    dip, active = ft["diplomacy"], ft["active"]
    total = 0
    for g in np.nonzero(active)[0]:
        if g == fid or dip[fid, g] == int(DiplomacyState.PEACE):
            total += get_population(int(g))
    return total


def get_enemy_population(fid: int) -> int:
    ft = _factions("diplomacy", "active")
    dip, active = ft["diplomacy"], ft["active"]
    return sum(get_population(int(g)) for g in np.nonzero(active)[0]
               if dip[fid, g] == int(DiplomacyState.WAR))


def get_player_population() -> int:
    return get_population(context().player_faction)


def get_player_population_limit() -> int:
    return get_population_limit(context().player_faction)


# ---------------------------------------------------------------------------
# Tiles / map queries
# ---------------------------------------------------------------------------


def get_tile(chunk_rc, tile_rc) -> dict | None:
    md = _eng().map_data
    if md is None:
        return None
    from permafrost_engine_tpu_torch.core.config import TILES_PER_CHUNK
    r = chunk_rc[0] * TILES_PER_CHUNK + tile_rc[0]
    c = chunk_rc[1] * TILES_PER_CHUNK + tile_rc[1]
    return {"type": int(md.tile_type[r, c]),
            "base_height": int(md.base_height[r, c]),
            "ramp_height": int(md.ramp_height[r, c]),
            "top_mat_idx": int(md.top_mat[r, c]),
            "sides_mat_idx": int(md.side_mat[r, c]),
            "pathable": bool(md.pathable[r, c])}


def update_tile(chunk_rc, tile_rc, tile: dict) -> bool:
    md = _eng().map_data
    if md is None:
        return False
    from permafrost_engine_tpu_torch.core.config import TILES_PER_CHUNK
    r = chunk_rc[0] * TILES_PER_CHUNK + tile_rc[0]
    c = chunk_rc[1] * TILES_PER_CHUNK + tile_rc[1]
    for key, arr in (("type", md.tile_type), ("base_height", md.base_height),
                     ("ramp_height", md.ramp_height), ("top_mat_idx", md.top_mat),
                     ("sides_mat_idx", md.side_mat), ("pathable", md.pathable)):
        if key in tile:
            arr[r, c] = tile[key]
    _eng().load_map_data(md)   # recompile nav costs + invalidate caches
    return True


def update_tiles(updates: list) -> bool:
    """Batched tile edits: [(chunk_rc, tile_rc, tile_dict), ...] applied
    with ONE nav recompile (the reference marks touched chunks dirty and
    re-bakes once per frame, ref: src/map/map.c M_AL_UpdateTile batching;
    a per-tile reload would recompile costs 25x for a 5x5 brush)."""
    md = _eng().map_data
    if md is None or not updates:
        return False
    from permafrost_engine_tpu_torch.core.config import TILES_PER_CHUNK
    for chunk_rc, tile_rc, tile in updates:
        r = chunk_rc[0] * TILES_PER_CHUNK + tile_rc[0]
        c = chunk_rc[1] * TILES_PER_CHUNK + tile_rc[1]
        for key, arr in (("type", md.tile_type),
                         ("base_height", md.base_height),
                         ("ramp_height", md.ramp_height),
                         ("top_mat_idx", md.top_mat),
                         ("sides_mat_idx", md.side_mat),
                         ("pathable", md.pathable)):
            if key in tile:
                arr[r, c] = tile[key]
    _eng().load_map_data(md)
    return True


def tiles_under_obj(ent) -> list[tuple[int, int]]:
    from permafrost_engine_tpu_torch.core.config import TILES_PER_CHUNK, UNITS_PER_TILE
    eng = _eng()
    slot = eng.uid_to_slot[ent.uid]
    e = eng.state.ents
    x, z, rad = torch.cat([e.pos[slot], e.radius[slot:slot + 1]]).tolist()
    p = np.asarray([x, z], np.float32)
    out = []
    for r in range(int((p[1] - rad) // UNITS_PER_TILE),
                   int((p[1] + rad) // UNITS_PER_TILE) + 1):
        for c in range(int((p[0] - rad) // UNITS_PER_TILE),
                       int((p[0] + rad) // UNITS_PER_TILE) + 1):
            out.append((r, c))
    return out


def set_map_highlight_size(n: int) -> None:
    context().highlight_size = n


def map_pos_over_water(xz) -> bool:
    return _eng().height_at(_pos2(xz)) < 0


def map_pos_over_land(xz) -> bool:
    return not map_pos_over_water(xz)


def map_height_at_point(xz) -> float:
    return _eng().height_at(_pos2(xz))


def _nearest_pathable(xz, layer: int):
    from permafrost_engine_tpu_torch.core.config import COST_IMPASSABLE, NAV_TILE_SIZE
    eng = _eng()
    cost = eng.nav.cost_base[layer]
    r0 = int(np.clip(xz[1] // NAV_TILE_SIZE, 0, eng.cfg.field_h - 1))
    c0 = int(np.clip(xz[0] // NAV_TILE_SIZE, 0, eng.cfg.field_w - 1))
    ok = np.argwhere(cost != COST_IMPASSABLE)
    if len(ok) == 0:
        return None
    d = np.abs(ok - [r0, c0]).max(axis=1)
    r, c = ok[np.argmin(d)]
    return ((c + 0.5) * NAV_TILE_SIZE, (r + 0.5) * NAV_TILE_SIZE)


def map_nearest_pathable(xz):
    return _nearest_pathable(_pos2(xz), 0)


def map_nearest_pathable_water(xz):
    from permafrost_engine_tpu_torch.core.config import NUM_FOOTPRINTS
    return _nearest_pathable(_pos2(xz), 1 * NUM_FOOTPRINTS)


def map_nearest_pathable_air(xz):
    from permafrost_engine_tpu_torch.core.config import NUM_FOOTPRINTS
    return _nearest_pathable(_pos2(xz), 2 * NUM_FOOTPRINTS)


def map_pos_under_cursor():
    """Mouse ray -> terrain intersection (ref: map/raycast.c). Headless:
    intersect the active camera's cursor ray with the height plane."""
    cam = get_active_camera()
    d = cam.direction()
    if d[1] >= -1e-4:
        return None
    t = -cam.pos[1] / d[1]
    hit = cam.pos + d * t
    return (float(hit[0]), 0.0, float(hit[2]))


def _pos2(p):
    return (p[0], p[2]) if len(p) == 3 else tuple(p)


# ---------------------------------------------------------------------------
# Minimap
# ---------------------------------------------------------------------------


def get_minimap_position():
    return context().minimap["position"]


def set_minimap_position(x, y) -> None:
    context().minimap["position"] = (x, y)


def set_minimap_resize_mask(mask: int) -> None:
    context().minimap["resize_mask"] = mask


def get_minimap_size() -> int:
    return context().minimap["size"]


def set_minimap_size(n: int) -> None:
    context().minimap["size"] = n


def set_minimap_border_clr(r, g, b, a) -> None:
    context().minimap["border_clr"] = (r, g, b, a)


def set_minimap_render_all_ents(on: bool) -> None:
    context().minimap["render_all"] = bool(on)


def mouse_over_minimap() -> bool:
    mx, my = context().mouse_pos
    x, y = context().minimap["position"]
    s = context().minimap["size"]
    return x <= mx <= x + s and y <= my <= y + s


# ---------------------------------------------------------------------------
# Click-mode orders
# ---------------------------------------------------------------------------


def _click_setter(field):
    def setter(on: bool = True) -> None:
        setattr(context().click_modes, field, bool(on))
    return setter


set_move_on_left_click = _click_setter("move")
set_attack_on_left_click = _click_setter("attack")
set_build_on_left_click = _click_setter("build")
set_gather_on_left_click = _click_setter("gather")
set_pick_up_on_left_click = _click_setter("pick_up")
set_drop_off_on_left_click = _click_setter("drop_off")
set_transport_on_left_click = _click_setter("transport")
set_evict_on_left_click = _click_setter("evict")
set_position_rally_point_on_left_click = _click_setter("rally_point")


def set_click_move_enabled(on: bool) -> None:
    context().click_modes.click_move_enabled = bool(on)


# ---------------------------------------------------------------------------
# Storage / garrison UI
# ---------------------------------------------------------------------------


def set_storage_site_ui_style(style: dict) -> None:
    context().storage_ui["style"] = dict(style)


def set_storage_site_ui_border_color(rgba) -> None:
    context().storage_ui["border_color"] = tuple(rgba)


def set_storage_site_ui_font_color(rgba) -> None:
    context().storage_ui["font_color"] = tuple(rgba)


def storage_site_show_ui(ent, on: bool = True) -> None:
    context().storage_ui["shown"][ent.uid] = bool(on)


def set_garrison_ui_font_color(rgba) -> None:
    context().garrison_ui["font_color"] = tuple(rgba)


def set_garrison_ui_icon(icon: str) -> None:
    context().garrison_ui["icon"] = icon


def set_garrison_ui_style(style: dict) -> None:
    context().garrison_ui["style"] = dict(style)


def garrison_show_ui(ent, on: bool = True) -> None:
    context().garrison_ui["shown"][ent.uid] = bool(on)


# ---------------------------------------------------------------------------
# Settings
# ---------------------------------------------------------------------------


def settings_get(name: str):
    return _eng().settings.get(name)


def settings_set(name: str, value) -> None:
    eng = _eng()
    eng.settings.set(name, value)
    if name in ("pf.debug.trace_python", "pf.debug.log_python"):
        # the bus caches the trace flag per frame (events.py:_dispatch);
        # re-sample immediately so toggles take effect mid-frame too
        eng.bus.refresh_trace()


def settings_create(name: str, value) -> None:
    from permafrost_engine_tpu_torch.core.settings import SettingType as T
    t = {bool: T.BOOL, int: T.INT, float: T.FLOAT, str: T.STRING}.get(
        type(value), T.VEC2)
    _eng().settings.create(name, t, value)


def settings_delete(name: str) -> None:
    _eng().settings.delete(name)


def settings_flush() -> None:
    _eng().settings.save_to_file(
        os.path.join(context().basedir, "pf_settings.json"))


# ---------------------------------------------------------------------------
# Sim state / session
# ---------------------------------------------------------------------------


def get_simstate() -> int:
    return int(_eng().sim_state)


def set_simstate(state: int) -> None:
    eng = _eng()
    prev = int(eng.sim_state)
    eng.sim_state = int(state)
    if prev != int(state):
        eng.bus.notify(int(EventType.GAME_SIMSTATE_CHANGED), int(state))


def _script_by_value(basedir: str):
    """by-value policy for session pickles: game-script modules must never
    be re-imported (and re-executed) by a fresh-process load, so their
    functions/classes/modules ship by value (ref: the reference pickles
    whole script modules by value, py_pickle.c module handler)."""
    base = os.path.abspath(basedir)

    def by_value(mod_name: str) -> bool:
        root = mod_name.partition(".")[0]
        if root in ("permafrost_engine_tpu_torch",):
            return False            # the engine itself is import-safe
        if mod_name in ("__main__", "__mp_main__") or root == "scripts":
            return True
        m = sys.modules.get(mod_name)
        f = getattr(m, "__file__", None) if m is not None else None
        return bool(f and os.path.abspath(f).startswith(base + os.sep))

    return by_value


def _collect_script_state(ctx) -> dict:
    """Image of the script layer for the session blob: event handlers,
    entity wrappers, UI windows/system, cameras, click modes, presentation
    state. pf.Task instances ride inside the scheduler snapshot (their
    _entry bound methods) and are re-bound on load; the GraphPickler memo
    keeps wrapper identity shared between here and there."""
    import weakref as _weakref

    from permafrost_engine_tpu_torch.core import pickling as graphpickle
    eng = ctx.engine
    entities = {}
    for uid, ref in list(ctx.entities.items()):
        obj = ref() if isinstance(ref, _weakref.ref) else ref
        if obj is not None:
            entities[uid] = obj
    return {
        "handlers": {k: list(v) for k, v in eng.bus._handlers.items() if v},
        "queue": list(eng.bus._queue),
        "entities": entities,
        "ui": ctx.ui,
        "ui_windows": dict(ctx.ui_windows),
        "cameras": ctx.cameras,
        "active_camera": ctx.active_camera,
        "rts_zoom_enabled": ctx.rts_zoom_enabled,
        "click_modes": ctx.click_modes,
        "player_faction": ctx.player_faction,
        "mouse_pos": ctx.mouse_pos,
        "keys_down": set(ctx.keys_down),
        "cursor": ctx.cursor,
        "minimap": ctx.minimap,
        "healthbars": ctx.healthbars,
        "unit_icons": ctx.unit_icons,
        "show_regions_flag": ctx.show_regions_flag,
        "skybox": ctx.skybox,
        "lighting": ctx.lighting,
        "storage_ui": ctx.storage_ui,
        "garrison_ui": ctx.garrison_ui,
        "console_shown": ctx.console_shown,
        "highlight_size": ctx.highlight_size,
        "ui_styles": ui_style.styles_to_dict(ui_style.STYLES),
        "models": {k: v for k, v in ctx.models.items()
                   if graphpickle.picklable(v)},
    }


def _apply_script_state(ctx, st: dict) -> None:
    import weakref as _weakref
    from collections import defaultdict

    eng = ctx.engine
    eng.bus._handlers = defaultdict(
        list, {k: list(v) for k, v in st["handlers"].items()})
    eng.bus._queue = list(st.get("queue", []))
    # restored wrappers must outlive this call in a fresh process where no
    # script module holds them — the context retains them strongly (the
    # reference's unpickled module graph is what holds them there)
    ctx._retained_entities = list(st["entities"].values())
    ctx.entities = {uid: _weakref.ref(obj)
                    for uid, obj in st["entities"].items()}
    ctx.ui = st["ui"]
    ctx.ui_windows = dict(st["ui_windows"])
    ctx.cameras = st["cameras"]
    ctx.active_camera = st["active_camera"]
    ctx.rts_zoom_enabled = st["rts_zoom_enabled"]
    ctx.click_modes = st["click_modes"]
    ctx.player_faction = st["player_faction"]
    ctx.mouse_pos = st["mouse_pos"]
    ctx.keys_down = set(st["keys_down"])
    ctx.cursor = st["cursor"]
    ctx.minimap = st["minimap"]
    ctx.healthbars = st["healthbars"]
    ctx.unit_icons = st["unit_icons"]
    ctx.show_regions_flag = st["show_regions_flag"]
    ctx.skybox = st["skybox"]
    ctx.lighting = st["lighting"]
    ctx.storage_ui = st["storage_ui"]
    ctx.garrison_ui = st["garrison_ui"]
    ctx.console_shown = st["console_shown"]
    ctx.highlight_size = st["highlight_size"]
    ui_style.styles_from_dict(ui_style.STYLES, st.get("ui_styles"))
    ctx.models.update(st.get("models", {}))


def save_session(path: str) -> bool:
    """Save the full session: engine + the whole script layer (handlers,
    entity wrappers, UI, live pf.Task fibers). A fresh process can rebuild
    everything from the file alone (ref: src/session.c:176-233 +
    py_pickle.c whole-interpreter pickling)."""
    from permafrost_engine_tpu_torch.core.session import save_session_bytes
    ctx = context()
    try:
        blob = save_session_bytes(
            ctx.engine,
            script_state=_collect_script_state(ctx),
            extra_tokens={id(ctx): "CONTEXT"},
            by_value=_script_by_value(ctx.basedir))
        with open(os.path.join(ctx.basedir, path), "wb") as f:
            f.write(blob)
    except Exception:
        ctx.engine.bus.notify(int(EventType.SESSION_FAIL_SAVE), path)
        raise
    ctx.engine.bus.notify(int(EventType.SESSION_SAVED), path)
    return True


def load_session(path: str) -> bool:
    """Restore a session saved by save_session — in-process or in a FRESH
    process: handlers, UI views, entity wrappers and mid-execution pf.Task
    fibers are rebuilt from the blob alone (the py_pickle.c capability;
    fibers resume via the scheduler's deterministic replay)."""
    from permafrost_engine_tpu_torch.core.session import load_session_bytes
    ctx = context()
    try:
        with open(os.path.join(ctx.basedir, path), "rb") as f:
            data = f.read()
        # on the device of the engine it replaces
        engine, script = load_session_bytes(
            data, device=ctx.engine.device,
            extra_resolve=lambda eng: {"CONTEXT": ctx}, return_script=True)
    except Exception:
        ctx.engine.bus.notify(int(EventType.SESSION_FAIL_LOAD), path)
        raise
    ctx.engine = engine
    if script is not None:
        _apply_script_state(ctx, script)
    # rebind restored pf.Task instances (their _entry bound methods came
    # back through the scheduler snapshot, replayed to their yield point)
    ctx.tasks = {}
    for tid, t in ctx.engine.sched.tasks.items():
        owner = getattr(t.fn, "__self__", None)
        if isinstance(owner, Task):
            owner.tid = tid
            owner.state = t.state
            owner._task = t
            ctx.tasks[tid] = owner
    return True


def exec_(path: str) -> None:
    full = os.path.join(context().basedir, path)
    with open(full) as f:
        exec(compile(f.read(), full, "exec"), {"pf": globals()})  # noqa: S102


def exec_push(path: str) -> None:
    from permafrost_engine_tpu_torch.core.session import SubsessionStack
    ctx = context()
    if not isinstance(ctx.session_stack, SubsessionStack):
        stack = SubsessionStack(device=ctx.engine.device)
        stack._stack = list(ctx.session_stack)
        ctx.session_stack = stack
    ctx.session_stack.push(ctx.engine)
    ctx.engine = Engine(ctx.engine.cfg, device=ctx.engine.device)
    exec_(path)


def exec_pop() -> None:
    ctx = context()
    ctx.engine = ctx.session_stack.pop()
    ctx.engine.bus.notify(int(EventType.SESSION_POPPED), None)


def exec_pop_to_root() -> None:
    ctx = context()
    ctx.engine = ctx.session_stack.pop_to_root()
    ctx.engine.bus.notify(int(EventType.SESSION_POPPED), None)


def session_stack_depth() -> int:
    stack = context().session_stack
    return stack.depth if hasattr(stack, "depth") else len(stack)


def pickle_object(obj) -> bytes:
    """Serialize ANY script object graph — closures, lambdas, dynamic
    classes, bound methods, weakrefs, modules — not just the stock-pickle
    subset (ref: src/script/py_pickle.c:278-369; conformance suite:
    tests/test_pickle.py, mirroring the reference's scripts/test_pickle.py)."""
    from permafrost_engine_tpu_torch.core import pickling as graphpickle
    ctx = _context
    if ctx is not None:
        return graphpickle.dumps(
            obj,
            tokens={id(ctx.engine): "ENGINE", id(ctx): "CONTEXT"},
            by_value=_script_by_value(ctx.basedir))
    return graphpickle.dumps(obj)


def unpickle_object(data: bytes):
    from permafrost_engine_tpu_torch.core import pickling as graphpickle
    ctx = _context
    resolve = {}
    if ctx is not None:
        resolve = {"ENGINE": ctx.engine, "CONTEXT": ctx}
    return graphpickle.loads(data, resolve=resolve)


# ---------------------------------------------------------------------------
# Cursor
# ---------------------------------------------------------------------------


def set_system_cursor(kind: str) -> None:
    context().cursor["active"] = kind


def set_named_cursor(name: str, path: str, hot_x: int = 0, hot_y: int = 0) -> None:
    context().cursor["named"][name] = (path, hot_x, hot_y)


def activate_system_cursor(kind: str) -> None:
    context().cursor["active"] = kind


def activate_named_cursor(name: str) -> None:
    context().cursor["active"] = name


def set_cursor_rts_mode(on: bool) -> None:
    context().cursor["rts_mode"] = bool(on)


def get_cursor_rts_mode() -> bool:
    return context().cursor["rts_mode"]


# ---------------------------------------------------------------------------
# Spatial queries
# ---------------------------------------------------------------------------


def nearest_ent(xz, max_range: float = 1e30, pred=None):
    h = _eng().ents_host("alive", "pos", "uid")
    d = np.linalg.norm(h["pos"] - np.asarray(_pos2(xz)), axis=-1)
    d[~h["alive"]] = np.inf
    order = np.argsort(d)
    for slot in order:
        if d[slot] > max_range or not np.isfinite(d[slot]):
            return None
        ent = _ent_obj(int(h["uid"][slot]))
        if pred is None or pred(ent):
            return ent
    return None


def ents_in_circle(xz, radius: float) -> list:
    h = _eng().ents_host("alive", "pos", "uid")
    d = np.linalg.norm(h["pos"] - np.asarray(_pos2(xz)), axis=-1)
    hit = h["alive"] & (d <= radius)
    return [_ent_obj(int(u)) for u in h["uid"][hit]]


def ents_in_rect(lo_xz, hi_xz) -> list:
    h = _eng().ents_host("alive", "pos", "uid")
    pos = h["pos"]
    lo = np.minimum(_pos2(lo_xz), _pos2(hi_xz))
    hi = np.maximum(_pos2(lo_xz), _pos2(hi_xz))
    hit = h["alive"] & (pos[:, 0] >= lo[0]) & (pos[:, 0] <= hi[0]) & \
        (pos[:, 1] >= lo[1]) & (pos[:, 1] <= hi[1])
    return [_ent_obj(int(u)) for u in h["uid"][hit]]


# ---------------------------------------------------------------------------
# Audio
# ---------------------------------------------------------------------------


def play_music(name: str) -> bool:
    return _eng().audio.play_music(name)


def curr_music() -> str | None:
    return _eng().audio.curr_music()


def get_all_music() -> list[str]:
    return _eng().audio.all_music()


def play_effect(name: str, pos) -> bool:
    return _eng().audio.play_effect(name, _pos2(pos))


def play_global_effect(name: str, interrupt: bool = False,
                       channel: int = 0) -> bool:
    return _eng().audio.play_global_effect(name, interrupt, channel)


def dump_audio(path: str, seconds: float = 2.0) -> int:
    """Mix the currently-audible sources into a stereo WAV from the active
    camera's listening position — the offline render of the OpenAL output
    path (device playback has no analogue in a headless container)."""
    cam = get_active_camera()
    return _eng().audio.render_wav(
        path, seconds, listener_pos=tuple(cam.pos),
        search_dirs=(context().basedir,))


# ---------------------------------------------------------------------------
# Combat / movement orders
# ---------------------------------------------------------------------------


def spawn_projectile(ent, dir_xyz, speed: float, damage: float) -> bool:
    """Manual projectile launch (ref: pf.spawn_projectile), written into
    the engine's projectile pool in place."""
    from permafrost_engine_tpu_torch.ops import projectile as proj_ops
    eng = _eng()
    slot = eng.uid_to_slot[ent.uid]
    pos = eng.pos_of(ent.uid)
    d = np.asarray(dir_xyz, np.float32)
    d2 = np.array([d[0], d[2]] if len(d) == 3 else d)
    n = np.linalg.norm(d2)
    if n < 1e-6:
        return False
    target = pos + d2 / n * speed   # one-second lead point
    n, dev = eng.cfg.max_ents, eng.device
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[slot] = True
    proj_ops.spawn_projectiles(
        eng.cfg, eng.state.projectiles, mask, eng.state.ents.pos,
        eng._to_device(np.tile(target, (n, 1))), eng.state.ents.faction,
        torch.full((n,), float(damage), device=dev))
    return True


def formation_arrange(ents: list, ftype: int) -> bool:
    uids = [e.uid for e in ents]
    eng = _eng()
    pos = eng.ents_host("pos")["pos"]
    center = np.mean([pos[eng.uid_to_slot[u]] for u in uids], axis=0)
    return eng.move_in_formation(uids, tuple(center), FormationType(ftype))


def move_in_formation(ents: list, pos, ftype: int) -> bool:
    return _eng().move_in_formation(
        [e.uid for e in ents], _pos2(pos), FormationType(ftype))


def attack_in_formation(ents: list, pos, ftype: int) -> bool:
    ok = move_in_formation(ents, pos, ftype)
    _eng().set_stance([e.uid for e in ents], int(CombatStance.AGGRESSIVE))
    return ok


def formation_preferred_for_set(ents: list) -> int:
    return int(FormationType.RANK if len(ents) >= 8 else FormationType.COLUMN)


# ---------------------------------------------------------------------------
# Sprites / misc
# ---------------------------------------------------------------------------

_sprites: list[dict] = []


def spawn_sprite_static(image: str, pos, width: float, height: float,
                        duration_ticks: int = -1) -> int:
    _sprites.append({"image": image, "pos": tuple(pos), "w": width,
                     "h": height, "until": duration_ticks, "animated": False})
    return len(_sprites) - 1


def spawn_sprite_animated(sheet: str, pos, width: float, height: float,
                          rows: int, cols: int, fps: float,
                          duration_ticks: int = -1) -> int:
    _sprites.append({"image": sheet, "pos": tuple(pos), "w": width,
                     "h": height, "rows": rows, "cols": cols, "fps": fps,
                     "until": duration_ticks, "animated": True})
    return len(_sprites) - 1


def multiply_quaternions(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return (
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    )


def rand(mod: int) -> int:
    return _random.randrange(mod)
