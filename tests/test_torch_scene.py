"""PyTorch port vs the JAX package: whole frames (``render/scene.py``).

One scene is built through both ``pf`` modules with the same calls (the
port's engine on the CPU): two factions' units, a wounded unit, a
building, a storage site, a lake (water reflection and refraction),
flat grass (foliage), a sprite, and a unit drawn as a skinned PFObj model.
The port's device state is then set to the JAX engine's
(``state/convert.state_from_numpy``), so both renderers draw one state.

Frames are held to: at least ``FRAME_SHARE`` of the pixels within
``FRAME_LEVELS`` u8 levels of JAX's frame (measured: every case of this
file differs from JAX on at most 1 pixel of 12,288, by 8 levels, and the
fog point-of-view frames are equal). The JAX
renderer is given the port's shadow pass (JAX's own ``_raster_pass`` with
``budget=0``; see below), since the two differ there by design.

The shadow pass is a deliberate divergence (``SceneRenderer._shadow_pass``,
ROADMAP queue 3): JAX's compacts to ``raster_budget`` live triangles and,
with the sun seeing the whole terrain, drops the entities at the back of
the soup, so ``tests/test_raster.py::test_scene_shadows_darken_ground``
fails there. The port's pass keeps every triangle: on that test's scene
it darkens 292 ground pixels and brightens none, and its depth map equals
JAX's ``raster_budget=0`` shadow pass on every finite texel within
``SHADOW_ATOL`` (1.2e-7 measured).
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import permafrost_engine_tpu.script.pf as jpf
from permafrost_engine_tpu.core.config import EngineConfig, EntityFlags
from permafrost_engine_tpu.render import scene as jscene
from permafrost_engine_tpu.render.camera import Camera as JCamera
from permafrost_engine_tpu_torch.core.config import EngineConfig as TConfig
from permafrost_engine_tpu_torch.render import scene as tscene
from permafrost_engine_tpu_torch.render.camera import Camera as TCamera
from permafrost_engine_tpu_torch.script import pf as tpf
from permafrost_engine_tpu_torch.state.convert import state_from_numpy

FRAME_SHARE = 0.995
FRAME_LEVELS = 2
SHADOW_ATOL = 1e-5

CFG = EngineConfig(max_ents=32, chunks_r=1, chunks_c=1, num_layers=1,
                   max_flocks=4, max_projectiles=8, field_slab_slots=8,
                   los_slab_slots=8)
W, H = 128, 96
CAM = dict(pos=np.array([120.0, 90.0, 220.0]), pitch=-40.0, yaw=90.0,
           aspect=W / H)


def jax_renderer(eng, *a, **kw):
    """JAX's SceneRenderer with the port's shadow pass: JAX's own
    ``_raster_pass`` over the whole soup (``budget=0``)."""
    r = jscene.SceneRenderer(eng, *a, **kw)

    def shadow(verts):
        return jscene._raster_pass(
            verts, jnp.zeros(verts.shape[:2] + (9,), verts.dtype),
            r._light_vp, h=r.shadow_res, w=r.shadow_res, k=160, kbig=64,
            budget=0)[0]
    r._shadow_pass = shadow
    return r


def arm_model(pfobj):
    """tests/test_raster.py's 2-joint arm: a tall box, every vertex on
    joint 1, which a 9-frame clip swings 90 degrees about z."""
    soup = (jscene._box_mesh().reshape(-1, 3)
            * np.array([1.0, 3.0, 1.0])).astype(np.float32)
    v = len(soup)
    frames = 9
    rots = np.zeros((frames, 2, 4), np.float32)
    rots[:, 0] = [0, 0, 0, 1]
    for f in range(frames):
        half = np.radians(90.0 * f / (frames - 1)) / 2
        rots[f, 1] = [0, 0, np.sin(half), np.cos(half)]
    clip = pfobj.AnimClip("swing", frames, np.zeros((frames, 2, 3), np.float32),
                          rots, np.ones((frames, 2, 3), np.float32))
    return pfobj.PFObj(
        verts=soup, uvs=np.zeros((v, 2), np.float32),
        normals=np.zeros((v, 3), np.float32),
        weight_joints=np.concatenate(
            [np.ones((v, 1), np.int32), np.full((v, 3), -1, np.int32)], 1),
        weight_vals=np.concatenate(
            [np.ones((v, 1), np.float32), np.zeros((v, 3), np.float32)], 1),
        vert_mat=np.zeros(v, np.int32),
        materials=[pfobj.Material("m", 1.0, (0.8, 0.1, 0.8), (0, 0, 0), "")],
        joint_parents=np.array([-1, 0], np.int32), joint_names=["r", "arm"],
        bind_trans=np.zeros((2, 3), np.float32),
        bind_rots=np.tile(np.array([0, 0, 0, 1], np.float32), (2, 1)),
        bind_scales=np.ones((2, 3), np.float32),
        clips={"swing": clip, "idle": clip}, bbox=None)


def build(pf):
    """The scene, through one pf module; returns its handles."""
    if pf is tpf:
        pf.init(TConfig(**dataclasses.asdict(CFG)), device="cpu")
        from permafrost_engine_tpu_torch.assets import pfobj
    else:
        pf.init(CFG)
        from permafrost_engine_tpu.assets import pfobj
    eng = pf.context().engine
    hts = np.full((CFG.field_h, CFG.field_w), 3.0, np.float32)
    hts[:, 40:] = -2.0                               # a lake to the east
    yy = np.arange(CFG.field_h, dtype=np.float32)[:, None]
    hts[:, :24] += np.sin(yy / 5.0) * 0.3            # gentle, still grassy
    eng.heights = hts
    a = pf.add_faction("A")
    b = pf.add_faction("B")
    units = [pf.CombatableEntity("u.pfobj", f"u{i}",
                                 pos=(96.0 + 6 * i, 0.0, 140.0 + 3 * i),
                                 hp=100.0, base_dmg=1.0, faction_id=a)
             for i in range(5)]
    foes = [pf.CombatableEntity("u.pfobj", f"f{i}",
                                pos=(140.0 + 6 * i, 0.0, 150.0),
                                hp=80.0, base_dmg=1.0, faction_id=b)
            for i in range(3)]
    units[1].hp = 40.0                               # a wounded unit
    tower = pf.BuildableEntity("b.pfobj", "tower", pos=(100.0, 0.0, 160.0),
                               radius=12.0, sel_radius=12.0, faction_id=a)
    hut = pf.StorageSiteEntity("h.pfobj", "hut", pos=(80.0, 0.0, 130.0),
                               faction_id=a)
    hut.set_capacity("Wood", 100)
    arm = pf.CombatableEntity("a.pfobj", "arm", pos=(120.0, 0.0, 170.0),
                              hp=50.0, base_dmg=1.0, faction_id=a)
    eng.anim.load_model("arm", arm_model(pfobj))
    eng.anim.register(arm.uid, model="arm", idle_clip="swing")
    pf._sprites.clear()
    pf.spawn_sprite_static("puff", (110.0, 8.0, 175.0), 10.0, 10.0)
    pf.set_unit_selection(units[:2])
    pf.step(2)
    eng.anim.states[arm.uid].t = 9 / 24.0 * 0.5      # mid-swing
    return dict(eng=eng, units=units, foes=foes, tower=tower, hut=hut,
                arm=arm)


@pytest.fixture(scope="module")
def worlds():
    try:
        jw = build(jpf)
        tw = build(tpf)
        # both renderers draw one state
        tw["eng"].state = state_from_numpy(jax.device_get(jw["eng"].state),
                                           "cpu")
        assert tw["eng"].uid_to_slot == jw["eng"].uid_to_slot
        jr = jax_renderer(jw["eng"], W, H, shadow_res=64)
        tr = tscene.SceneRenderer(tw["eng"], W, H, shadow_res=64)
        yield jw, tw, jr, tr
    finally:
        jpf._context = None
        tpf._context = None
        jpf._sprites.clear()
        tpf._sprites.clear()


def assert_frames_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int)).max(-1)
    share = float((d <= FRAME_LEVELS).mean())
    assert share >= FRAME_SHARE, (share, int(d.max()))


def both(worlds, fn):
    """fn(pf, renderer, camera) on the JAX side, then on the port's."""
    _jw, _tw, jr, tr = worlds
    return (fn(jpf, jr, JCamera(**CAM)), fn(tpf, tr, TCamera(**CAM)))


def setting(pf, name, value):
    pf.settings_set(name, value)


@pytest.mark.parametrize("log_mask", [0, 3], ids=["fused", "pass_by_pass"])
@pytest.mark.parametrize("pov", [None, 0], ids=["no_fog", "fog_pov"])
def test_frame_matches_jax(worlds, log_mask, pov):
    def frame(pf, r, cam):
        setting(pf, "pf.debug.render_log_mask", log_mask)
        try:
            return r.render(cam, faction_pov=pov)
        finally:
            setting(pf, "pf.debug.render_log_mask", 0)
    want, got = both(worlds, frame)
    assert_frames_close(got, want)
    tr = worlds[3]
    assert tr.reflections and len(np.asarray(tr.f_verts)) > 100
    if log_mask:
        rec = tr.render_log[-1]
        for k in ("soup_ms", "raster_ms", "shade_ms", "water_ms",
                  "overlays_ms", "triangles", "live_main", "live_mirror"):
            assert k in rec, rec
        assert 0 < rec["live_main"] <= rec["triangles"] * 2


# tests/test_hud_settings.py's settings, each set on both sides in turn:
# (name, value) pairs applied before the frame, restored after it
SETTINGS = {
    "refraction_off": [("pf.video.water_refraction", False)],
    "reflection_off": [("pf.video.water_reflection", False)],
    "rt_scale_half": [("pf.video.water_rt_scale", 0.5)],
    "shadows_off": [("pf.video.shadows_enabled", False)],
    "healthbars_always": [("pf.game.healthbar_mode", 0)],
    "healthbars_never": [("pf.game.healthbar_mode", 2)],
    "storage_ui_never": [("pf.game.storage_site_ui_mode", 2)],
}


@pytest.mark.parametrize("case", sorted(SETTINGS))
def test_render_settings_match_jax(worlds, case):
    def frame(pf, r, cam):
        old = [(n, pf.settings_get(n)) for n, _ in SETTINGS[case]]
        for n, v in SETTINGS[case]:
            setting(pf, n, v)
        try:
            return r.render(cam)
        finally:
            for n, v in old:
                setting(pf, n, v)
    want, got = both(worlds, frame)
    assert_frames_close(got, want)
    base = worlds[3].render(TCamera(**CAM))
    assert (got != base).any(), "the setting changes the port's frame"


def demo_window(pf):
    """tests/test_ui_input.py's DemoWin over the given pf's UI classes."""
    if pf is tpf:
        from permafrost_engine_tpu_torch.script.ui import WINDOW_TITLE, Window
    else:
        from permafrost_engine_tpu.script.ui import WINDOW_TITLE, Window

    class DemoWin(Window):
        def __init__(self):
            super().__init__("demo", (100, 100, 400, 300), flags=WINDOW_TITLE)
            self.flag = True
            self.speed = 5.0
            self.name_text = ""

        def update(self):
            self.layout_row_dynamic(30, 2)
            self.label("Units:")
            self.label_colored("42", 255, 0, 0)
            self.layout_row_dynamic(30, 1)
            self.button_label("Attack")
            self.layout_row_dynamic(30, 1)
            self.flag = self.checkbox("fog", self.flag)
            self.layout_row_dynamic(30, 1)
            self.speed = self.slider_float(0.0, self.speed, 10.0, 0.5)
            self.layout_row_dynamic(30, 1)
            self.name_text = self.text_edit("name", self.name_text)
    return DemoWin()


def test_hud_minimap_cursor_and_ui_match_jax(worlds):
    """Scripted minimap styling, the cursor glyph and a UI window, as
    tests/test_hud_settings.py and tests/test_ui_input.py set them."""
    def frame(pf, r, cam):
        c = pf.context()
        pf.set_minimap_size(200)
        pf.set_minimap_position(40, 700)
        pf.set_minimap_border_clr(255, 0, 0, 255)
        c.cursor["compose"] = True
        pf.inject_mouse_motion(960, 540)
        pf.activate_system_cursor("attack")
        win = demo_window(pf)
        win.show()
        c.ui_windows["demo"] = win
        try:
            img = r.render(cam)
            return img, c.minimap["screen_rect"]
        finally:
            c.ui_windows.clear()
            c.cursor["compose"] = False
    (want, wrect), (got, grect) = both(worlds, frame)
    assert grect == wrect
    px, py, s, _ = grect
    assert (got[py, px:px + s] == (255, 0, 0)).all()
    assert_frames_close(got, want)


def test_skinned_model_renders_and_animates():
    """tests/test_raster.py::test_skinned_model_renders_and_animates on
    the port: the PFObj mesh is visible, skinned by the pose palettes, and
    advancing the clip moves its silhouette."""
    from permafrost_engine_tpu_torch.assets import pfobj
    from permafrost_engine_tpu_torch.game.engine import Engine
    cfg = TConfig(max_ents=8)
    eng = Engine(cfg, device="cpu")
    eng.add_faction(0)
    uids = eng.spawn_batch(np.array([[450.0, 450.0]], np.float32), faction=0)
    eng.anim.load_model("arm", arm_model(pfobj))
    eng.anim.register(int(uids[0]), model="arm", idle_clip="swing")
    cam = TCamera(pos=np.array([450.0, 10.0, 480.0]), pitch=-10.0, yaw=90.0,
                  aspect=1.0)
    r = tscene.SceneRenderer(eng, 128, 128, shadows=False, reflections=False)

    def purple(img):
        return ((img[..., 0] > 120) & (img[..., 2] > 120)
                & (img[..., 1] < 110))
    img0 = r.render(cam)
    assert purple(img0).sum() > 10
    eng.anim.states[int(uids[0])].t = 9 / 24.0 * 0.99   # end of swing
    img1 = r.render(cam)
    assert purple(img1).sum() > 10
    assert (purple(img0) != purple(img1)).sum() > 20


def _shadow_scene(E, Config, **kw):
    """tests/test_raster.py::test_scene_shadows_darken_ground's scene."""
    eng = E(Config(max_ents=8), **kw)
    eng.add_faction(0)
    eng.spawn_batch(np.array([[450.0, 450.0]], np.float32), faction=0,
                    flags=int(EntityFlags.BUILDING), radius=10.0,
                    sel_radius=10.0)
    eng.step(1)
    return eng


def test_shadows_darken_ground_and_depth_equals_unbudgeted_jax():
    from permafrost_engine_tpu.game.engine import Engine as JEngine
    from permafrost_engine_tpu_torch.game.engine import Engine
    eng = _shadow_scene(Engine, TConfig, device="cpu")
    cam = dict(pos=np.array([450.0, 160.0, 452.0]), pitch=-89.0, yaw=90.0,
               aspect=1.0)
    r_sh = tscene.SceneRenderer(eng, 128, 128, shadow_res=256, shadows=True)
    r_no = tscene.SceneRenderer(eng, 128, 128, shadow_res=256, shadows=False)
    lum_sh = r_sh.render(TCamera(**cam)).astype(int).sum(-1)
    lum_no = r_no.render(TCamera(**cam)).astype(int).sum(-1)
    darker = (lum_no - lum_sh) > 60
    assert darker.sum() > 20
    assert (lum_sh <= lum_no + 1).all()

    je = _shadow_scene(JEngine, EngineConfig)
    jr = jscene.SceneRenderer(je, 128, 128, shadow_res=256, raster_budget=0)
    jverts, _ = jr.scene_soup(JCamera(**cam))
    tverts, _ = r_sh.scene_soup(TCamera(**cam))
    np.testing.assert_array_equal(tverts.numpy(), np.asarray(jverts))
    want = np.asarray(jr._shadow_pass(jverts))
    got = r_sh._shadow_pass(tverts).numpy()
    fin = np.isfinite(want)
    assert fin.sum() > 1000
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], atol=SHADOW_ATOL)
