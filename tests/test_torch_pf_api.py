"""PyTorch port vs the JAX package: the ``pf`` script surface.

The scenarios of ``tests/test_pf_api.py`` (entities, orders and events,
tags and spatial queries, factions and diplomacy, population, harvesting
through entity classes, settings, the camera and cursor, regions, the task
protocol, pickling and the console, a session round trip, a map loaded from
text with its tiles, the misc surface, slope costs and ramp heights), and
one more for the writes a script makes between segments (entity setters,
the attack order, a manual projectile, formation orders, fog toggles,
faction edits) and the input paths that read the arena, run as cases of
one parametrised test: each scenario is one script, run against
the JAX ``pf`` and against the port's (``pf.init(..., device="cpu")``), with
the original test's assertions. Held equal between the two, exactly: every
observation a scenario returns (events with the frames they came at,
factions, diplomacy and population, tiles, settings, query results, what a
loaded session holds), except positions, which agree within 1e-3 world
units, the tolerance of the port's other engine parity tests
(``tests/test_torch_economy.py``, ``tests/test_torch_war.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

import permafrost_engine_tpu.script.pf as jpf
from permafrost_engine_tpu.assets import pfmap as jpfmap
from permafrost_engine_tpu.core.config import COST_IMPASSABLE, UNITS_PER_TILE
from permafrost_engine_tpu_torch.assets import pfmap as tpfmap
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig
from permafrost_engine_tpu_torch.script import pf as tpf
from test_engine_move import small_cfg

POS_ATOL = 1e-3

# the bus events a scenario's script can cause
_EVENTS = ("MOTION_START", "MOTION_END", "ENTITY_DEATH", "ATTACK_START",
           "PROJECTILE_HIT", "REGION_ENTERED", "REGION_EXITED", "NEW_GAME",
           "RESOURCE_PICKED_UP", "RESOURCE_DROPPED_OFF", "ORDER_ISSUED",
           "SESSION_SAVED", "SCRIPT_TASK_FINISHED")


def _init(pf, cfg=None):
    """pf.init on the small config: the port's on the CPU."""
    cfg = cfg or small_cfg()
    if pf is tpf:
        return pf.init(TorchConfig(**dataclasses.asdict(cfg)), device="cpu")
    return pf.init(cfg)


def _record(pf) -> list:
    """(frame, event, payload) of every bus event of `_EVENTS` from now on."""
    eng = pf.context().engine
    log = []
    for name in _EVENTS:
        ev = getattr(pf, f"EVENT_{name}")
        pf.register_event_handler(
            ev, lambda a, e=name, g=eng: log.append((g._frame, e, a)))
    return log


def _pos(ent):
    p = ent.pos
    return {"pos": np.asarray([p[0], p[1], p[2]], np.float64)}


# -- the scenarios: (pf, tmp_path) -> observations ------------------------------


def entity_spawn_move_query(pf, tmp):
    log = _record(pf)
    e = pf.MovableEntity("unit.pfobj", "grunt", pos=(50.0, 0.0, 50.0),
                         speed=120.0)
    assert e.uid in pf.context().engine.uid_to_slot
    assert e.pos[0] == 50.0 and e.pos[2] == 50.0
    assert not e.moving
    e.move((150.0, 0.0, 50.0))
    assert e.moving
    pf.step(240)
    assert not e.moving
    assert abs(e.pos[0] - 150.0) < 8.0
    p_first = _pos(e)["pos"]
    got = []
    pf.register_event_handler(pf.EVENT_MOTION_END, got.append)
    e.move((60.0, 0.0, 50.0))
    pf.step(300)
    assert any(g["uid"] == e.uid for g in got)
    return dict(exact=dict(log=log, got=got, moving=e.moving, speed=e.speed,
                           ticks=pf.get_ticks()),
                pos=dict(first=p_first, **_pos(e)))


def entity_tags_and_spatial_queries(pf, tmp):
    a = pf.Entity("a.pfobj", "a", pos=(10.0, 0.0, 10.0))
    b = pf.Entity("b.pfobj", "b", pos=(14.0, 0.0, 10.0))
    c = pf.Entity("c.pfobj", "c", pos=(400.0, 0.0, 400.0))
    a.tags.add("hero")
    assert [e.uid for e in pf.entities_for_tag("hero")] == [a.uid]
    near = {e.uid for e in pf.ents_in_circle((10.0, 0.0, 10.0), 10.0)}
    assert near == {a.uid, b.uid}
    box = {e.uid for e in pf.ents_in_rect((0.0, 0.0), (20.0, 20.0))}
    assert box == {a.uid, b.uid}
    nearest = pf.nearest_ent((395.0, 0.0, 395.0))
    assert nearest.uid == c.uid
    far = pf.nearest_ent((395.0, 0.0, 395.0), max_range=1.0)
    return dict(exact=dict(near=near, box=box, nearest=nearest.uid,
                           far=far, idle=[e.uid for e in pf.get_idle_units()],
                           tiles=pf.tiles_under_obj(b)),
                pos={})


def factions_and_diplomacy(pf, tmp):
    f0 = pf.add_faction("Humans", (255, 0, 0))
    f1 = pf.add_faction("Orcs", (0, 255, 0), controllable=False)
    facs = pf.get_factions_list()
    assert [f["name"] for f in facs] == ["Humans", "Orcs"]
    assert facs[1]["controllable"] is False
    pf.set_diplomacy_state(f0, f1, pf.DIPLOMACY_STATE_WAR)
    assert pf.get_diplomacy_state(f0, f1) == pf.DIPLOMACY_STATE_WAR
    assert pf.get_diplomacy_state(f1, f0) == pf.DIPLOMACY_STATE_WAR
    f2 = pf.add_faction("Elves")
    pf.set_faction_controllable(f2, False)
    pf.update_faction(f2, "Wood elves", (1, 2, 3))
    before_remove = pf.get_factions_list()
    pf.remove_faction(f1)
    return dict(exact=dict(facs=facs, before_remove=before_remove,
                           after=pf.get_factions_list(),
                           dip=[pf.get_diplomacy_state(i, j) for i in range(3)
                                for j in range(3)]),
                pos={})


def population_api(pf, tmp):
    pf.add_faction("A")
    pf.PopulationContributorEntity("u.pfobj", "u", pos=(5.0, 0.0, 5.0),
                                   population_cost=3)
    pf.PopulationLimitContributorEntity("h.pfobj", "h", pos=(9.0, 0.0, 5.0),
                                        population_provided=12)
    assert pf.get_player_population() == 3
    assert pf.get_player_population_limit() == 12
    b = pf.add_faction("B")
    pf.PopulationContributorEntity("v.pfobj", "v", pos=(50.0, 0.0, 5.0),
                                   population_cost=2, faction_id=b)
    pf.set_diplomacy_state(0, b, pf.DIPLOMACY_STATE_WAR)
    return dict(exact=dict(pop=pf.get_player_population(),
                           limit=pf.get_player_population_limit(),
                           allied=pf.get_allied_population(0),
                           enemy=pf.get_enemy_population(0)),
                pos={})


def harvest_through_entities(pf, tmp):
    pf.add_faction("A")
    log = _record(pf)
    tree = pf.ResourceEntity("tree.pfobj", "tree", pos=(140.0, 0.0, 100.0),
                             resource_name="Wood", resource_amount=40)
    store = pf.StorageSiteEntity("hut.pfobj", "hut", pos=(100.0, 0.0, 140.0))
    store.set_capacity("Wood", 100)
    w = pf.HarvesterEntity("w.pfobj", "w", pos=(100.0, 0.0, 100.0), speed=120.0)
    w.set_gather_speed("Wood", 5)
    w.set_max_carry("Wood", 10)
    pf.context().engine.economy_period = 3
    w.gather(tree)
    steps = 0
    for _ in range(80):
        pf.step(6)
        steps += 1
        if store.get_curr("Wood") >= 10:
            break
    assert store.get_curr("Wood") >= 10
    assert pf.get_resource_stored(0, "Wood") == store.get_curr("Wood")
    assert pf.get_resource_list() == ["Wood"]
    return dict(exact=dict(log=log, steps=steps, curr=store.get_curr("Wood"),
                           carried=w.carried("Wood"),
                           left=tree.resource_amount,
                           cap=pf.get_resource_capacity(0, "Wood")),
                pos=_pos(w))


def settings_api(pf, tmp):
    assert pf.settings_get("pf.game.movement_hz") == 20
    pf.settings_set("pf.video.vsync", False)
    assert pf.settings_get("pf.video.vsync") is False
    pf.settings_create("pf.mygame.difficulty", 2)
    assert pf.settings_get("pf.mygame.difficulty") == 2
    s = pf.context().engine.settings
    return dict(exact=dict(all={k: s.get(k) for k in s.names()},
                           render=pf.get_render_settings(),
                           res=pf.get_resolution()),
                pos={})


def camera_and_cursor_api(pf, tmp):
    cam = pf.get_active_camera()
    cam.move_within_bounds_and_face((300.0, 300.0))
    hit = pf.map_pos_under_cursor()
    assert hit is not None and abs(hit[0] - 300.0) < 1.0
    pf.set_cursor_rts_mode(True)
    assert pf.get_cursor_rts_mode()
    return dict(exact=dict(hit=hit, cursor=dict(pf.context().cursor)),
                pos={})


def region_class_and_events(pf, tmp):
    pf.context().engine.economy_period = 3
    log = _record(pf)
    zone = pf.Region("zone", (200.0, 0.0, 200.0), radius=30.0)
    u = pf.MovableEntity("u.pfobj", "u", pos=(150.0, 0.0, 200.0), speed=120.0)
    u.move((200.0, 0.0, 200.0))
    pf.step(300)
    assert u.uid in zone.entities
    inside = list(zone.entities)
    zone.delete()
    return dict(exact=dict(log=log, inside=inside), pos=_pos(u))


def task_protocol(pf, tmp):
    log = []

    class Pinger(pf.Task):
        def __run__(self):
            yield self.register("pinger")
            msg, sender = yield self.receive()
            log.append(msg)
            yield self.reply(sender, msg + 1)

    class Ponger(pf.Task):
        def __run__(self):
            tid = yield self.who_is("pinger")
            r = yield self.send(tid, 41)
            log.append(r)

    a, b = Pinger(), Ponger()
    pf.flush_tasks()
    assert log == [41, 42]
    return dict(exact=dict(log=log, tids=(a.tid, b.tid),
                           done=(a.completed, b.completed)),
                pos={})


def pickle_and_console(pf, tmp):
    data = pf.pickle_object({"a": [1, 2, 3]})
    assert pf.unpickle_object(data) == {"a": [1, 2, 3]}
    out = pf.console_eval("1 + 1")
    assert out == "2"
    assert "get_ticks" in pf.console_eval("dir(pf)")
    return dict(exact=dict(out=out, bad=pf.console_eval("1 +* 2")[:11]),
                pos={})


def session_roundtrip_via_pf(pf, tmp):
    pf.context().basedir = str(tmp)
    log = _record(pf)
    e = pf.MovableEntity("u.pfobj", "u", pos=(77.0, 0.0, 88.0))
    f = pf.MovableEntity("u.pfobj", "v", pos=(20.0, 0.0, 30.0), speed=60.0)
    f.move((200.0, 0.0, 120.0))
    pf.step(30)
    assert pf.save_session("save.bin")
    old_engine = pf.context().engine
    assert pf.load_session("save.bin")
    eng = pf.context().engine
    assert eng is not old_engine
    slot = eng.uid_to_slot[e.uid]
    p = eng.ents_host("pos")["pos"][slot] if pf is tpf else \
        np.asarray(eng.state.ents.pos)[slot]
    assert tuple(p) == (77.0, 88.0)
    pf.step(60)
    return dict(exact=dict(log=log, frame=eng._frame, moving=f.moving,
                           events=eng.events, uids=sorted(eng.uid_to_slot)),
                pos=dict(e=_pos(e)["pos"], f=_pos(f)["pos"]))


def map_load_string_and_tiles(pf, tmp):
    pfmap = tpfmap if pf is tpf else jpfmap
    log = _record(pf)
    m = pfmap.make_flat_map(2, 2)
    m.pathable[40, 40] = False
    m.base_height[50, 50] = -3
    text = pfmap.write_pfmap(m)
    assert pf.load_map_string(text)
    tile = pf.get_tile((1, 1), (8, 8))    # global tile (40, 40)
    assert tile["pathable"] is False
    assert pf.map_pos_over_water(
        (50.5 * UNITS_PER_TILE, 0.0, 50.5 * UNITS_PER_TILE))
    assert pf.map_pos_over_land((10.0, 0.0, 10.0))
    assert pf.map_height_at_point(
        (50.5 * UNITS_PER_TILE, 0.0, 50.5 * UNITS_PER_TILE)) < 0
    p = pf.map_nearest_pathable((40.2 * UNITS_PER_TILE, 0.0,
                                 40.2 * UNITS_PER_TILE))
    assert p is not None
    assert pf.update_tile((0, 0), (3, 4), {"pathable": False,
                                           "base_height": 2})
    assert pf.update_tiles([((0, 1), (5, 5), {"type": 3}),
                            ((1, 0), (6, 7), {"ramp_height": 2})])
    eng = pf.context().engine
    tiles = [pf.get_tile(cr, tr) for cr, tr in (((1, 1), (8, 8)),
                                                 ((0, 0), (3, 4)),
                                                 ((0, 1), (5, 5)),
                                                 ((1, 0), (6, 7)))]
    return dict(exact=dict(log=log, tiles=tiles, p=p,
                           h=pf.map_height_at_point((404.0, 0.0, 404.0)),
                           cost=np.asarray(eng.nav.cost_base).tobytes(),
                           heights=np.asarray(eng.heights).tobytes()),
                pos={})


def misc_surface(pf, tmp):
    assert pf.get_version_string().endswith(
        "cuda" if pf is tpf else "tpu")
    assert pf.rand(10) in range(10)
    q = pf.multiply_quaternions((0, 0, 0, 1), (0, 0, 0, 1))
    assert q == (0, 0, 0, 1)
    assert pf.play_music("theme")
    assert pf.curr_music() == "theme"
    assert pf.play_global_effect("horn")
    pf.set_minimap_size(128)
    assert pf.get_minimap_size() == 128
    w = pf.Window("test", (10, 10, 200, 100))
    w.show()
    assert pf.get_active_window() == "test"
    pf.set_move_on_left_click()
    assert pf.context().click_modes.move
    q2 = pf.multiply_quaternions((0.1, 0.2, 0.3, 0.9), (0.5, -0.1, 0.2, 0.8))
    # deliberate differences: the device named, and the state's bytes in
    # each package's own schema
    assert pf.prev_frame_gpu_stats()["device"] == (
        "cpu" if pf is tpf else "tpu")
    assert pf.prev_frame_vramstats()["hbm_state_bytes"] > 0
    return dict(exact=dict(q2=q2, minimap=dict(pf.context().minimap),
                           modes=dataclasses.asdict(pf.context().click_modes)),
                pos={})


def map_slope_costs_and_cliffs(pf, tmp):
    pfmap = tpfmap if pf is tpf else jpfmap
    m = pfmap.make_flat_map(2, 2)
    m.base_height[:, 32:] = 6          # sheer cliff at col 32
    m.tile_type[20:24, 31:33] = 0x3    # a ramp section bridging it
    cost, heights = pfmap.compile_nav_costs(m)
    ground = cost[0]
    assert ground[10 * 2, 32 * 2] == COST_IMPASSABLE
    rv = ground[21 * 2, 31 * 2 + 1]
    assert rv != COST_IMPASSABLE and rv > 1
    assert ground[10 * 2, 10 * 2] == 1
    assert heights[10 * 2, 40 * 2] > heights[10 * 2, 10 * 2]
    assert pf.load_map_string(pfmap.write_pfmap(m))
    eng = pf.context().engine
    return dict(exact=dict(cost=cost.tobytes(), heights=heights.tobytes(),
                           loaded=np.asarray(eng.nav.cost_base).tobytes(),
                           over_water=pf.map_pos_over_water((300.0, 0, 100.0)),
                           climb=pf.map_height_at_point((300.0, 0, 100.0))),
                pos={})


def ramp_heights_interpolate(pf, tmp):
    pfmap = tpfmap if pf is tpf else jpfmap
    m = pfmap.make_flat_map(1, 1)
    m.base_height[:, 16:] = 4
    m.tile_type[8, 15] = 0x4
    m.ramp_height[8, 15] = 4
    h = pfmap.nav_heights(m)
    assert h[16, 2] == 0.0 and h[16, 40] == 4.0
    west, east = h[16, 30], h[16, 31]
    assert 0.0 < west < east < 4.0
    cost, heights = pfmap.compile_nav_costs(m)
    assert heights[16, 30] == west * pfmap.HEIGHT_SCALE
    assert COST_IMPASSABLE not in (cost[0, 16, 30], cost[0, 16, 31])
    back = pfmap.parse_pfmap(pfmap.write_pfmap(m))
    return dict(exact=dict(h=h.tobytes(), cost=cost.tobytes(),
                           back=pfmap.nav_heights(back).tobytes()),
                pos={})


def writes_between_segments(pf, tmp):
    """The device writes a script makes between segments: entity setters
    and the attack order, a manual projectile, formation orders, fog
    toggles and exploration, faction edits, stop and zombiefy; and the
    input paths that read the arena (hover, box and click selection)."""
    log = _record(pf)
    eng = pf.context().engine
    a, b = pf.add_faction("A"), pf.add_faction("B")
    pf.set_diplomacy_state(a, b, pf.DIPLOMACY_STATE_WAR)

    class Soldier(pf.MovableEntity, pf.CombatableEntity):
        pass

    ours = [Soldier("s.pfobj", f"s{i}", pos=(100.0 + 6 * i, 0.0, 100.0),
                    faction_id=a, speed=40.0, vision_range=80.0)
            for i in range(4)]
    theirs = [Soldier("s.pfobj", f"t{i}", pos=(160.0 + 6 * i, 0.0, 130.0),
                      faction_id=b, speed=40.0, hp=60.0, vision_range=80.0)
              for i in range(3)]
    ours[0].speed = 55.5
    theirs[0].hp = 33.25
    ours[1].attack(theirs[1])
    ours[2].hold_position()
    assert pf.spawn_projectile(ours[3], (1.0, 0.0, 0.6), 60.0, 25.0)
    assert not pf.spawn_projectile(ours[3], (0.0, 0.0, 0.0), 60.0, 25.0)
    pf.step(30)
    assert pf.formation_arrange(ours[:2], pf.FORMATION_RANK)
    pf.attack_in_formation(theirs, (120.0, 0.0, 110.0), pf.FORMATION_COLUMN)
    pf.disable_fog_of_war()
    pf.step(30)
    fog_off = np.asarray(eng.state.fog.state.cpu() if pf is tpf
                         else eng.state.fog.state)
    pf.explore_map(b)
    pf.enable_fog_of_war()
    pf.step(30)
    fog_on = np.asarray(eng.state.fog.state.cpu() if pf is tpf
                        else eng.state.fog.state)
    assert (fog_off[:2] == 2).all() and not (fog_on[:2] == 2).all()
    pf.set_faction_controllable(b, False)
    ours[3].stop()
    theirs[2].zombiefy()
    assert theirs[2].zombie
    cam = pf.get_active_camera()
    cam.move_within_bounds_and_face((130.0, 110.0))
    vw, vh = pf.context().ui.virtual_resolution
    s0 = cam.world_to_screen((ours[0].pos[0], 0.0, ours[0].pos[2]), vw, vh)
    pf.inject_mouse_motion(*s0)
    hovered = pf.get_hovered_unit()
    clicked = pf.inject_mouse_click(*s0)
    lo = cam.world_to_screen((90.0, 0.0, 90.0), vw, vh)
    hi = cam.world_to_screen((140.0, 0.0, 120.0), vw, vh)
    boxed = pf.inject_mouse_drag(lo[0], lo[1], hi[0], hi[1])
    right = pf.inject_mouse_click(*cam.world_to_screen((200.0, 0.0, 90.0),
                                                       vw, vh), 3)
    pf.step(60)
    pf.remove_faction(b)
    living = [e for e in ours + theirs if not e.zombie]
    return dict(exact=dict(
        log=log, events=eng.events, frame=eng._frame,
        hovered=getattr(hovered, "uid", None), clicked=clicked,
        boxed=sorted(boxed), right=right, fog_off=fog_off.tobytes(),
        fog_on=fog_on.tobytes(), facs=pf.get_factions_list(),
        stances=[int(e.stance) for e in living],
        speeds=[e.speed for e in living], hp=[e.hp for e in living],
        sel=[e.uid for e in pf.get_unit_selection()]),
        pos=dict(pos=np.asarray([e.pos for e in living], np.float64)))


SCENARIOS = [entity_spawn_move_query, entity_tags_and_spatial_queries,
             factions_and_diplomacy, population_api, harvest_through_entities,
             settings_api, camera_and_cursor_api, region_class_and_events,
             task_protocol, pickle_and_console, session_roundtrip_via_pf,
             map_load_string_and_tiles, misc_surface,
             map_slope_costs_and_cliffs, ramp_heights_interpolate,
             writes_between_segments]


def _plain(x):
    """Observations with numpy scalars as Python numbers and enums as ints,
    so the two sides compare as plain data."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, set):
        return {_plain(v) for v in x}
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, int) and not isinstance(x, bool):
        return int(x)
    return x


def _run(pf, scenario, tmp):
    _init(pf)
    try:
        return scenario(pf, tmp)
    finally:
        pf._context = None


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_pf_scenario_matches_jax(scenario, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _run(jpf, scenario, tmp_path / "jax")
    got = _run(tpf, scenario, tmp_path / "torch")
    assert _plain(got["exact"]) == _plain(want["exact"])
    assert got["pos"].keys() == want["pos"].keys()
    for k in want["pos"]:
        np.testing.assert_allclose(got["pos"][k], want["pos"][k], rtol=0,
                                   atol=POS_ATOL, err_msg=k)
