"""PyTorch port vs the JAX package: the presentation stack around the
rasterizer.

The same seeded inputs go through the JAX modules and the port's (on the
CPU). What is held, with the worst case measured when it was set:

* ``utils/noise.py``, ``utils/image.py`` (a PNG round trip; Pillow is
  installed here), ``ops/quilt.py`` on ``tests/test_quilt.py``'s inputs,
  and ``render/textures.py`` (detail maps, quilted too, and the atlas):
  bit-equal.
* ``render/draw.py``: ``cull_and_emit`` on seeded arrays and
  ``draw_buffers`` on an engine state, within ``DRAW_ATOL`` plus numpy's
  default 1e-7 relative (measured: masks, LODs and health equal, the
  matrices' translations 1.5e-5 apart at up to 256 world units, one f32
  ulp of the interpolated position); ``minimap_raster`` with
  and without a fog point of view: equal.
* ``render/ui_compose.py``, ``render/hud.py`` (minimap, cursor, storage
  and garrison panels) and ``render/debug_overlays.py`` (every overlay of
  ``tests/test_debug_overlays.py``'s scene, composited on a blank frame):
  equal images; the overlays' geometry extractors: equal arrays.
* ``ops/skin.bank_from_pfobj``: the packed keyframes, clip lengths, loop
  flags and hierarchy equal; the inverse bind within ``INV_BIND_ATOL``
  (4.8e-7 measured: ``torch.linalg.inv`` and ``jnp.linalg.inv`` round
  differently).
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import permafrost_engine_tpu.script.pf as jpf
from permafrost_engine_tpu.core.config import EngineConfig
from permafrost_engine_tpu.render import debug_overlays as jdbg
from permafrost_engine_tpu.render import draw as jdraw
from permafrost_engine_tpu.render.camera import Camera as JCamera
from permafrost_engine_tpu_torch.core.config import EngineConfig as TConfig
from permafrost_engine_tpu_torch.render import debug_overlays as tdbg
from permafrost_engine_tpu_torch.render import draw as tdraw
from permafrost_engine_tpu_torch.render.camera import Camera as TCamera
from permafrost_engine_tpu_torch.script import pf as tpf
from permafrost_engine_tpu_torch.state.convert import state_from_numpy

from test_quilt import make_texture

DRAW_ATOL = 1e-5
INV_BIND_ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


# -- noise, image, quilt, textures -------------------------------------------


def test_noise_bit_equal():
    from permafrost_engine_tpu.utils import noise as jn
    from permafrost_engine_tpu_torch.utils import noise as tn
    rng = np.random.default_rng(0)
    x, y, z = rng.uniform(-40, 40, (3, 500))
    for fn, args in ((lambda m: m.perlin1(x, seed=3), ()),
                     (lambda m: m.perlin2(x, y, seed=4), ()),
                     (lambda m: m.perlin3(x, y, z, seed=5), ()),
                     (lambda m: m.octave2(x, y, 5, 0.6, 1.9, seed=6), ()),
                     (lambda m: m.tileable2(48, 32, 7.0, 3, seed=7), ())):
        got, want = fn(tn), fn(jn)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_image_png_round_trip(tmp_path):
    from permafrost_engine_tpu.utils import image as ji
    from permafrost_engine_tpu_torch.utils import image as ti
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (20, 30, 3)).astype(np.uint8)
    ti.write_image(str(tmp_path / "t.png"), rgb)
    ji.write_image(str(tmp_path / "j.png"), rgb)
    for ch in (1, 3, 4):
        got = ti.load_image(str(tmp_path / "t.png"), ch)
        assert (got == ji.load_image(str(tmp_path / "j.png"), ch)).all()
    assert (ti.load_image(str(tmp_path / "t.png"), 3) == rgb).all()
    assert (ti.resize_image(rgb, 13, 7) == ji.resize_image(rgb, 13, 7)).all()


@pytest.mark.parametrize("seed,n,out_seed", [(0, 128, 1), (3, 96, 2)])
def test_quilt_bit_equal(seed, n, out_seed):
    from permafrost_engine_tpu.ops import quilt as jq
    from permafrost_engine_tpu_torch.ops import quilt as tq
    src = make_texture(seed=seed)
    want = jq.image_quilt(src, n, n, block=32, overlap=6, stride=8,
                          seed=out_seed)
    got = tq.image_quilt(src, n, n, block=32, overlap=6, stride=8,
                         seed=out_seed, device="cpu")
    np.testing.assert_array_equal(got, want)
    err = np.random.default_rng(seed).random((32, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tq._vertical_seam(_t(err)).numpy(),
        np.asarray(jq._vertical_seam(jnp.asarray(err))))


def test_textures_and_atlas_bit_equal(tmp_path):
    from permafrost_engine_tpu.render import textures as jt
    from permafrost_engine_tpu.utils.image import write_image
    from permafrost_engine_tpu_torch.render import textures as tt
    png = str(tmp_path / "albedo.png")
    write_image(png, np.random.default_rng(2).integers(
        0, 256, (40, 24, 3)).astype(np.uint8))
    atlases = []
    for mod, kw in ((jt, {}), (tt, {"device": "cpu"})):
        a = mod.TextureAtlas()
        for i, kind in enumerate(("grass", "rock", "sand", "dirt")):
            a.add(kind, mod.detail_map(kind, seed=11 * i, **kw))
        a.add("quilted", mod.detail_map("rock", seed=5, quilt=True, **kw))
        a.add_file("albedo", png)
        atlases.append(a.build())
    for got, want in zip(atlases[1], atlases[0]):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# -- draw ---------------------------------------------------------------------


def test_cull_and_emit_matches_jax():
    rng = np.random.default_rng(4)
    n = 64
    cam_kw = dict(pos=np.array([128.0, 80.0, 260.0]), pitch=-40.0, yaw=80.0)
    planes = JCamera(**cam_kw).frustum_planes().astype(np.float32)
    flags = rng.choice([0, 1 << 3, 1 << 5], n).astype(np.uint32)
    args = [rng.uniform(0, 256, (n, 2)).astype(np.float32),
            rng.uniform(0, 256, (n, 2)).astype(np.float32), 0.37,
            rng.uniform(0, 5, n).astype(np.float32),
            rng.uniform(-3, 3, n).astype(np.float32),
            rng.uniform(0.5, 4, n).astype(np.float32), rng.random(n) < 0.8,
            flags, rng.uniform(0, 100, n).astype(np.float32),
            np.where(rng.random(n) < 0.2, 0.0, 100.0).astype(np.float32),
            planes, cam_kw["pos"].astype(np.float32),
            np.array([100.0, 200.0], np.float32)]
    want = jdraw.cull_and_emit(*[jnp.asarray(a) for a in args])
    got = tdraw.cull_and_emit(*[a if isinstance(a, float) else
                                _t(a.astype(np.int32) if a is flags else a)
                                for a in args])
    assert 0 < int(np.asarray(want[0]).sum()) < n
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=DRAW_ATOL)


def _small_cfg():
    return EngineConfig(max_ents=32, chunks_r=1, chunks_c=2, num_layers=1,
                        max_flocks=4, max_projectiles=8, field_slab_slots=8,
                        los_slab_slots=8)


def build_world(pf):
    """tests/test_debug_overlays.py's scene, plus a storage site, a
    garrison and a damaged unit, through one pf module."""
    cfg = _small_cfg()
    if pf is tpf:
        pf.init(TConfig(**dataclasses.asdict(cfg)), device="cpu")
    else:
        pf.init(cfg)
    ctx = pf.context()
    eng = ctx.engine
    eng.heights[:, 100:] = -1.5
    a = pf.add_faction("A")
    b = pf.add_faction("B")
    pf.set_diplomacy_state(a, b, pf.DIPLOMACY_STATE_WAR)
    ents = [pf.MovableEntity("u.pfobj", f"u{i}", pos=(40 + 8 * i, 0, 40),
                             speed=40.0, faction_id=a) for i in range(4)]
    foes = [pf.CombatableEntity("g.pfobj", f"g{i}", pos=(120 + 8 * i, 0, 60),
                                hp=80.0, base_dmg=2.0, faction_id=b)
            for i in range(3)]
    foes[0].hp = 30.0
    hut = pf.StorageSiteEntity("h.pfobj", "hut", pos=(90.0, 0.0, 90.0),
                               faction_id=a)
    hut.set_capacity("Wood", 100)
    tower = pf.GarrisonableEntity("t.pfobj", "tower", pos=(150, 0, 100),
                                  faction_id=a, garrison_capacity=4)
    pf.storage_site_show_ui(hut, True)
    pf.garrison_show_ui(tower, True)
    pf.move_in_formation(ents, (400.0, 0.0, 100.0), pf.FORMATION_RANK)
    pf.step(4)
    pf.set_unit_selection([e.uid for e in ents])
    eng.regions.add_circle("zone", (100.0, 100.0), 30.0)
    cam = ctx.cameras[ctx.active_camera]
    cam.pos = np.array([150.0, 120.0, 250.0])
    cam.pitch, cam.yaw = -45.0, 90.0
    return ctx


@pytest.fixture(scope="module")
def worlds():
    try:
        jctx = build_world(jpf)
        tctx = build_world(tpf)
        # the port's device state set to the JAX engine's: one state drawn
        tctx.engine.state = state_from_numpy(
            jax.device_get(jctx.engine.state), "cpu")
        assert tctx.engine.uid_to_slot == jctx.engine.uid_to_slot
        yield jctx, tctx
    finally:
        jpf._context = None
        tpf._context = None


def test_draw_buffers_matches_jax(worlds):
    jctx, tctx = worlds
    kw = dict(pos=np.array([150.0, 120.0, 250.0]), pitch=-45.0, yaw=90.0)
    want = jdraw.draw_buffers(jctx.engine, JCamera(**kw), alpha=0.5)
    got = tdraw.draw_buffers(tctx.engine, TCamera(**kw), alpha=0.5)
    assert got.keys() == want.keys()
    for k in ("visible", "model_mats", "health_frac", "lod", "faction"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=DRAW_ATOL, err_msg=k)
    assert got["selection"] == want["selection"]
    assert got["sprites"] == want["sprites"]


@pytest.mark.parametrize("pov", [None, 0, 1])
def test_minimap_raster_matches_jax(worlds, pov):
    jctx, tctx = worlds
    for size in (85, 256):
        want = jdraw.minimap_raster(jctx.engine, size, faction_pov=pov)
        got = tdraw.minimap_raster(tctx.engine, size, faction_pov=pov)
        np.testing.assert_array_equal(got, want)


def test_ui_compose_matches_jax():
    """tests/test_ui_input.py's DemoWin, composited on a flat frame."""
    from test_torch_scene import demo_window
    from permafrost_engine_tpu.render.ui_compose import compose_ui as jcompose
    from permafrost_engine_tpu_torch.render.ui_compose import (
        compose_ui as tcompose)
    frame = np.full((216, 384, 3), 120, np.uint8)
    outs = []
    for pf, compose in ((jpf, jcompose), (tpf, tcompose)):
        w = demo_window(pf)
        w.show()
        outs.append(compose(frame, {"demo": w}, (1920, 1080)))
    assert (outs[1] != frame).sum() > 500
    np.testing.assert_array_equal(outs[1], outs[0])


def test_hud_matches_jax(worlds):
    """Minimap (styled, with a fog point of view), the cursor glyph and
    the storage and garrison panels, on a flat frame."""
    from permafrost_engine_tpu.render.hud import compose_hud as jhud
    from permafrost_engine_tpu_torch.render.hud import compose_hud as thud
    outs = []
    for pf, ctx, hud, cam_t in ((jpf, worlds[0], jhud, JCamera),
                                (tpf, worlds[1], thud, TCamera)):
        ctx.minimap["shown"] = True
        pf.set_minimap_size(300)
        pf.set_minimap_position(1500, 700)
        pf.set_minimap_border_clr(255, 0, 0, 255)
        ctx.cursor["compose"] = True
        pf.inject_mouse_motion(700, 500)
        pf.activate_system_cursor("scroll_top_left")
        cam = cam_t(pos=np.array([150.0, 120.0, 250.0]), pitch=-45.0,
                    yaw=90.0)
        try:
            outs.append(hud(np.full((144, 256, 3), 90, np.uint8),
                            ctx.engine, cam))
        finally:
            ctx.cursor["compose"] = False
    assert (outs[1] != 90).any(-1).sum() > 200
    np.testing.assert_array_equal(outs[1], outs[0])


OVERLAYS = ("show_flow_fields", "show_nav_portals", "show_nav_islands",
            "show_nav_cost_base", "show_nav_blockers", "show_chunk_boundaries",
            "show_hrvo_debug", "show_formations", "show_combat_ranges",
            "show_combat_targets", "show_faction_vision",
            "show_enemy_seek_fields", "show_arrival_fields",
            "show_harvester_state")


@pytest.mark.parametrize("names", [OVERLAYS[:6], OVERLAYS[6:]],
                         ids=["nav", "units"])
def test_debug_overlays_match_jax(worlds, names):
    outs = []
    for pf, ctx, dbg, cam_t in ((jpf, worlds[0], jdbg, JCamera),
                                (tpf, worlds[1], tdbg, TCamera)):
        pf.show_regions()
        for n in names:
            pf.settings_set(f"pf.debug.{n}", True)
        cam = cam_t(pos=np.array([150.0, 120.0, 250.0]), pitch=-45.0,
                    yaw=90.0, aspect=160 / 96)
        try:
            outs.append(dbg.apply_debug_overlays(
                np.zeros((96, 160, 3), np.uint8), ctx.engine, cam, 160, 96))
        finally:
            for n in names:
                pf.settings_set(f"pf.debug.{n}", False)
            pf.hide_regions()
    assert (outs[1] > 0).any(-1).sum() > 100
    np.testing.assert_array_equal(outs[1], outs[0])


def test_debug_overlay_geometry_equal():
    from permafrost_engine_tpu.game.region import Region as JRegion
    from permafrost_engine_tpu.nav.portals import Portal as JP
    from permafrost_engine_tpu.nav.portals import PortalGraph as JG
    from permafrost_engine_tpu_torch.game.region import Region as TRegion
    from permafrost_engine_tpu_torch.nav.portals import Portal as TP
    from permafrost_engine_tpu_torch.nav.portals import PortalGraph as TG
    rng = np.random.default_rng(6)
    codes = rng.integers(0, 9, (16, 16)).astype(np.uint8)
    mask = rng.random((12, 12)) < 0.3
    isl = rng.integers(-1, 5, (10, 10))
    pos = rng.uniform(0, 50, (6, 2)).astype(np.float32)
    vel = rng.normal(size=(6, 2)).astype(np.float32)
    rad = rng.uniform(0.5, 2, 6).astype(np.float32)

    def graph(P, G):
        ps = [P(pid=0, chunk=(0, 0), side="E", lo=10, hi=19, paired=1),
              P(pid=1, chunk=(0, 1), side="W", lo=10, hi=19, paired=0),
              P(pid=2, chunk=(0, 1), side="S", lo=3, hi=7, paired=-1),
              P(pid=3, chunk=(1, 0), side="N", lo=0, hi=63, paired=-1)]
        return G(portals=ps, adj={}, by_chunk={})

    def cases(m, P, G, R):
        return [m.flow_arrows(codes, (10.0, 20.0), decimate=2),
                m.tile_mask_points(mask, (4.0, 8.0), decimate=1),
                m.island_points(isl, isl >= 0, decimate=1),
                m.portal_segments(graph(P, G)),
                m.hrvo_cones(pos, vel, rad, 0, np.arange(1, 6)),
                m.region_outline(R("r", "rect", (100.0, 50.0), half_x=10.0,
                                   half_z=5.0)),
                m.region_outline(R("c", "circle", (3.0, 4.0), radius=7.0)),
                m.chunk_boundary_lines(2, 3)]

    for got, want in zip(cases(tdbg, TP, TG, TRegion),
                         cases(jdbg, JP, JG, JRegion)):
        if isinstance(want, dict):
            assert got.keys() == want.keys()
            got, want = list(got.values()), list(want.values())
        elif not isinstance(want, tuple):
            got, want = [got], [want]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _rig(pfobj):
    """A 3-joint chain with a non-trivial bind pose and five clips."""
    rng = np.random.default_rng(8)

    def quats(n):
        q = rng.normal(size=(n, 3, 4)).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    clips = {}
    for name, f in (("idle", 4), ("walk", 6), ("strike", 3), ("death", 5),
                    ("dance", 2)):
        clips[name] = pfobj.AnimClip(
            name, f, rng.normal(size=(f, 3, 3)).astype(np.float32), quats(f),
            rng.uniform(0.5, 1.5, (f, 3, 3)).astype(np.float32))
    v = 6
    return pfobj.PFObj(
        verts=np.zeros((v, 3), np.float32), uvs=np.zeros((v, 2), np.float32),
        normals=np.zeros((v, 3), np.float32),
        weight_joints=np.zeros((v, 4), np.int32),
        weight_vals=np.zeros((v, 4), np.float32),
        vert_mat=np.zeros(v, np.int32), materials=[],
        joint_parents=np.array([-1, 0, 1], np.int32),
        joint_names=["a", "b", "c"],
        bind_trans=rng.normal(size=(3, 3)).astype(np.float32),
        bind_rots=quats(1)[0],
        bind_scales=rng.uniform(0.5, 1.5, (3, 3)).astype(np.float32),
        clips=clips, bbox=None)


@pytest.mark.parametrize("names", [None, ["dance", "walk"]],
                         ids=["aliases", "named"])
def test_bank_from_pfobj_matches_jax(names):
    from permafrost_engine_tpu.assets import pfobj as jobj
    from permafrost_engine_tpu.ops import skin as jskin
    from permafrost_engine_tpu_torch.assets import pfobj as tobj
    from permafrost_engine_tpu_torch.ops import skin as tskin
    want = jskin.bank_from_pfobj(_rig(jobj), names)
    got = tskin.bank_from_pfobj(_rig(tobj), names, device="cpu")
    for name in ("pack", "frames", "loop"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got.inv_bind.numpy(), np.asarray(want.inv_bind),
                               atol=INV_BIND_ATOL)
    assert (got.max_frames, got.levels, got.parents) == (
        want.max_frames, want.levels, want.parents)
