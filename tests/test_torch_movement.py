"""PyTorch port vs the JAX package: the movement substep, op by op.

One scene, built by the JAX engine (a walled 2x2-chunk map, a moving squad
and a parked group, 30 or 90 frames into a move order), is fetched to numpy and
carried into the port with ``state_from_numpy``. Each op then takes the
same inputs on both sides. Tolerances: bucket indices and integer/bool
fields exactly equal; ``flow_velocity``/``dest_los`` within 1e-6; boids
forces and the integrator's floats within 1e-5 (the JAX side is compiled
by XLA, which contracts multiply-adds into FMAs; the port rounds each
operation); the formation keep force within 1e-3 of JAX's and 5e-5 of a
float64 evaluation (its test says why). The whole substep runs the JAX Pallas crowd kernel in
interpret mode, the counterpart of the port's kernel K1.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core.config import (
    CELL_ARRIVAL_RADIUS,
    CONTACT_CELL_SIZE,
    FORMATION_COHESION_FORCE,
    FORMATION_DRAG,
    MAX_FORCE,
    EntityFlags,
    MoveState,
)
from permafrost_engine_tpu.game import step as jstep
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu.ops import boids as jboids
from permafrost_engine_tpu.ops import grid as jgrid
from permafrost_engine_tpu.ops import integrate as jinteg
from permafrost_engine_tpu.ops import velocity as jvel
from permafrost_engine_tpu.ops.crowd_pallas import hrvo_select_pallas
from permafrost_engine_tpu.state.schema import empty_deltas as jempty
from permafrost_engine_tpu_torch.game import step as tstep
from permafrost_engine_tpu_torch.ops import boids as tboids
from permafrost_engine_tpu_torch.ops import grid as tgrid
from permafrost_engine_tpu_torch.ops import integrate as tinteg
from permafrost_engine_tpu_torch.ops import velocity as tvel
from permafrost_engine_tpu_torch.state.convert import state_from_numpy
from permafrost_engine_tpu_torch.state.schema import empty_deltas as tempty
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig
from test_engine_move import small_cfg, walled_cost


def _tcfg(cfg):
    """The port's EngineConfig with the same fields as a JAX one."""
    return TorchConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def _scene(frames: int = 30):
    cfg = small_cfg()
    eng = JaxEngine(cfg, cost_base=walled_cost(cfg))
    rng = np.random.default_rng(11)
    squad = (np.array([380.0, 90.0]) + rng.random((24, 2)) * 28).astype(np.float32)
    parked = (np.array([395.0, 150.0]) + rng.random((12, 2)) * 14).astype(np.float32)
    uids = eng.spawn_batch(squad, max_speed=40.0)
    eng.spawn_batch(parked, faction=1)
    assert eng.move(uids, (400.0, 400.0))
    eng.step(frames)
    return cfg, jax.device_get(eng.state)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return np.asarray(x)


def _grids_jax(cfg, e):
    collidable = e.alive & ((e.flags & jnp.uint32(EntityFlags.COLLISION)) != 0)
    ent_static = (((e.flags & jnp.uint32(EntityFlags.MOVABLE)) == 0)
                  | (e.movestate == MoveState.ARRIVED))
    payload = jnp.concatenate([
        e.vel, e.radius[:, None], ent_static.astype(jnp.float32)[:, None],
        e.flock.astype(jnp.float32)[:, None],
        (e.movestate == MoveState.ARRIVED).astype(jnp.float32)[:, None]], 1)
    kw = dict(cells_r=cfg.grid_cells_r, cells_c=cfg.grid_cells_c,
              cap=cfg.spatial_cell_cap, fine_r=cfg.contact_cells_r,
              fine_c=cfg.contact_cells_c, fine_cap=cfg.contact_cell_cap,
              fine_cell_size=CONTACT_CELL_SIZE)
    return collidable, payload, kw


def test_grid_pair_and_windows_exact():
    cfg, host = _scene()
    e = _j(host).ents
    collidable, payload, kw = _grids_jax(cfg, e)
    jsg, jcg = jgrid.build_grid_pair(e.pos, collidable, payload=payload,
                                     fine_payload=e.radius[:, None], **kw)
    tsg, tcg = tgrid.build_grid_pair(_t(e.pos), _t(collidable), payload=_t(payload),
                                     fine_payload=_t(e.radius[:, None]), **kw)
    np.testing.assert_array_equal(tsg.buckets.numpy(), _n(jsg.buckets))
    np.testing.assert_array_equal(tsg.bucket_xy.numpy(), _n(jsg.bucket_xy))
    np.testing.assert_array_equal(tsg.bucket_payload.numpy(), _n(jsg.bucket_payload))
    np.testing.assert_array_equal(tsg.cell_of.numpy(), _n(jsg.cell_of))
    np.testing.assert_array_equal(tcg.packed.numpy(), _n(jcg.packed))
    np.testing.assert_array_equal(tcg.cell_of.numpy(), _n(jcg.cell_of))
    assert (_n(jsg.buckets) >= 0).sum() == int(_n(collidable).sum())

    slots = jnp.arange(cfg.max_ents, dtype=jnp.int32)
    want = jgrid.window_candidates(jsg, e.pos, slots, window=3)
    got = tgrid.window_candidates(tsg, _t(e.pos), _t(slots), window=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _n(w))
    want = jgrid.contact_candidates(jcg, e.pos, slots)
    got = tgrid.contact_candidates(tcg, _t(e.pos), _t(slots))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _n(w))
    assert _n(want[3]).sum() > 20          # real contacts in the scene


def test_flow_velocity_and_dest_los():
    cfg, host = _scene()
    js = _j(host)
    ts = state_from_numpy(host, "cpu")
    e = js.ents
    kw = dict(chunks_r=cfg.chunks_r, chunks_c=cfg.chunks_c)
    gslot = jnp.full((cfg.max_ents,), -1, jnp.int32)
    wd, wh = jvel.flow_velocity(e.pos, e.flock, js.flocks.field_slot,
                                js.fields.flow, js.flocks.global_slot,
                                js.fields.global_flow, gslot, **kw)
    gd, gh = tvel.flow_velocity(ts.ents.pos, ts.ents.flock, ts.flocks.field_slot,
                                ts.fields.flow, ts.flocks.global_slot,
                                ts.fields.global_flow, _t(gslot), **kw)
    np.testing.assert_allclose(gd.numpy(), _n(wd), atol=1e-6)
    np.testing.assert_array_equal(gh.numpy(), _n(wh))
    assert _n(wh).sum() >= 20
    wl = jvel.dest_los(e.pos, e.flock, js.flocks.los_slot, js.fields.los, **kw)
    gl = tvel.dest_los(ts.ents.pos, ts.ents.flock, ts.flocks.los_slot,
                       ts.fields.los, **kw)
    np.testing.assert_array_equal(gl.numpy(), _n(wl))


def test_boids_preferred_velocity():
    cfg, host = _scene()
    js = _j(host)
    e = js.ents
    collidable, payload, kw = _grids_jax(cfg, e)
    jsg, _ = jgrid.build_grid_pair(e.pos, collidable, payload=payload,
                                   fine_payload=e.radius[:, None], **kw)
    slots = jnp.arange(cfg.max_ents, dtype=jnp.int32)
    cand, cpos, cpay, cvalid = jgrid.window_candidates(jsg, e.pos, slots, window=3)
    ck = dict(cells_r=cfg.grid_cells_r, cells_c=cfg.grid_cells_c,
              cell_size=jsg.cell_size, max_flocks=cfg.max_flocks)
    wc, wn = jboids.flock_cohesion_centroids(e.pos, e.flock, collidable, **ck)
    gc, gn = tboids.flock_cohesion_centroids(_t(e.pos), _t(e.flock),
                                             _t(collidable), **ck)
    np.testing.assert_allclose(gc.numpy(), _n(wc), atol=1e-5)
    np.testing.assert_array_equal(gn.numpy(), _n(wn))

    flow_dir, has_field = jvel.flow_velocity(
        e.pos, e.flock, js.flocks.field_slot, js.fields.flow,
        chunks_r=cfg.chunks_r, chunks_c=cfg.chunks_c)
    moving = e.alive & (e.movestate == MoveState.MOVING)
    use_arrive = ~has_field
    mst = e.max_speed / float(cfg.move_hz)
    args = (e.pos, e.vel, e.flock, e.dest, flow_dir, use_arrive, mst, cand,
            cvalid, moving)
    kwargs = dict(neigh_pos=cpos, neigh_vel=cpay[..., 0:2],
                  neigh_flock=cpay[..., 4].astype(jnp.int32),
                  formation_cell=e.formation_cell, has_cell=e.has_formation_cell,
                  flock_formation=js.flocks.formation, max_flocks=cfg.max_flocks,
                  coh_centroid=wc, coh_cnt=wn)
    want = jboids.preferred_velocity(*args, **kwargs)
    keep = tboids.formation_keep_force(
        _t(e.pos), _t(e.vel), _t(e.flock), _t(e.formation_cell),
        _t(e.has_formation_cell), _t(js.flocks.formation), cfg.max_flocks)
    got = tboids.preferred_velocity(
        *[_t(a) for a in args], keep=keep,
        **{k: _t(v) for k, v in kwargs.items() if k in (
            "neigh_pos", "neigh_vel", "neigh_flock", "coh_centroid",
            "coh_cnt")})
    np.testing.assert_allclose(got.numpy(), _n(want), atol=1e-5)
    assert np.abs(_n(want)).sum() > 1.0


def _keep_scene(n=4360, max_flocks=8, seed=5):
    """A RANK-sized corps in three formation flocks (and one without a
    FormationType) marching across a 1024 u map, cells near each unit."""
    rng = np.random.default_rng(seed)
    pos = (100.0 + 800.0 * rng.random((n, 2))).astype(np.float32)
    cell = (pos + 12.0 * (rng.random((n, 2)) - 0.5)).astype(np.float32)
    vel = (rng.random((n, 2)) - 0.5).astype(np.float32)
    flock = rng.integers(-1, 4, n).astype(np.int32)
    has_cell = rng.random(n) < 0.9
    formation = np.zeros(max_flocks, np.int32)
    formation[:3] = 1
    return (pos, vel, flock, cell, has_cell, formation), max_flocks


def _keep_force_f64(pos, vel, flock, cell, has_cell, formation, max_flocks):
    """The keep force with every sum and operation in float64."""
    pos, vel, cell = (a.astype(np.float64) for a in (pos, vel, cell))
    m = has_cell & (flock >= 0) & (formation[np.clip(flock, 0, max_flocks - 1)] > 0)
    idx = np.where(m, flock, max_flocks)
    sums = np.zeros((max_flocks + 1, 5))
    np.add.at(sums, idx, np.concatenate([pos, cell, np.ones((len(pos), 1))], 1)
              * m[:, None])
    mean = sums[:, :4] / np.maximum(sums[:, 4:], 1.0)
    to = mean[idx, 0:2] + (cell - mean[idx, 2:4]) - pos
    n = np.linalg.norm(to, axis=1, keepdims=True)
    keep = np.where(n > MAX_FORCE, to * MAX_FORCE / np.maximum(n, 1e-6), to)
    near = np.linalg.norm(cell - pos, axis=1) < CELL_ARRIVAL_RADIUS
    drag = np.where(near[:, None], -vel * FORMATION_DRAG, 0.0)
    return np.where(m[:, None], keep * FORMATION_COHESION_FORCE + drag, 0.0)


def test_formation_keep_force_matches_jax():
    """The keep force of a 4,360-unit formation. The port sums each flock
    exactly, so it lies within 5e-5 of a float64 evaluation (the f32
    rounding of the steps after the sums; 1.7e-5-2.6e-5 on seeds 0-5). The
    JAX version sums in f32 in scatter order, which moves a ~1,200-unit
    flock's centroid by up to ~7e-4 u at these positions; the force scales
    that by FORMATION_COHESION_FORCE (0.35), so port and JAX agree within
    1e-3 (1.1e-4-3.1e-4 on seeds 0-5)."""
    args, mf = _keep_scene()
    want = _n(jboids.formation_keep_force(*[jnp.asarray(a) for a in args],
                                          max_flocks=mf))
    got = tboids.formation_keep_force(*[_t(a) for a in args], max_flocks=mf)
    np.testing.assert_allclose(got.numpy(), _keep_force_f64(*args, mf), atol=5e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    assert (np.abs(want).sum(1) > 0).mean() > 0.5


def test_formation_keep_force_order_free():
    """The per-flock sums do not depend on the order the entities are added
    in (on the card an index_add_ adds in any order): permuting the rows
    permutes the force, bit for bit."""
    args, mf = _keep_scene()
    perm = np.random.default_rng(6).permutation(len(args[0]))
    base = tboids.formation_keep_force(*[_t(a) for a in args], max_flocks=mf)
    shuffled = tboids.formation_keep_force(
        *[_t(a[perm]) for a in args[:5]], _t(args[5]), max_flocks=mf)
    np.testing.assert_array_equal(shuffled.numpy(), base.numpy()[perm])


def test_movement_update_fields():
    cfg, host = _scene()
    js = _j(host)
    e = js.ents
    rng = np.random.default_rng(2)
    new_vel = jnp.asarray((rng.random((cfg.max_ents, 2)) - 0.5).astype(np.float32) * 3)
    kwargs = dict(
        alive=e.alive, moving_mask=e.alive & (e.movestate == MoveState.MOVING),
        pos=e.pos, new_vel=new_vel, dest=e.dest, movestate=e.movestate,
        facing=e.facing, vel_hist=e.vel_hist, vel_hist_idx=e.vel_hist_idx,
        wait_ticks=e.wait_ticks, stuck_ticks=e.stuck_ticks, layer=e.layer,
        cost_base=js.nav.cost_base, blockers=js.nav.blockers,
        garrisoned=jnp.zeros(cfg.max_ents, bool),
        flock_arrived=jnp.asarray(rng.random(cfg.max_ents) < 0.2),
        has_cell=e.has_formation_cell,
        depen=jnp.asarray((rng.random((cfg.max_ents, 2)) - 0.5).astype(np.float32) * 0.2))
    want = jinteg.movement_update(**kwargs)
    got = tinteg.movement_update(**{k: _t(v) for k, v in kwargs.items()})
    assert set(got) == set(want)
    for k, w in want.items():
        w = _n(w)
        g = got[k].numpy()
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    np.testing.assert_allclose(
        tinteg.facing_from_history(_t(e.vel_hist), _t(e.facing)).numpy(),
        _n(jinteg.facing_from_history(e.vel_hist, e.facing)), atol=1e-5)


def test_restamp_blockers_exact():
    cfg, host = _scene()
    js = _j(host)
    ts = state_from_numpy(host, "cpu")
    want = jstep._restamp_blockers(cfg, js.ents, js.nav).blockers
    got = tstep._restamp_blockers(_tcfg(cfg), ts.ents, ts.nav)
    np.testing.assert_array_equal(got.numpy(), _n(want))
    assert _n(want).sum() > 0
    # a multi-layer config dilates the stamps per footprint
    cfg12 = type(cfg)(**{**cfg.__dict__, "num_layers": 12})
    nav12 = js.nav.replace(blockers=jnp.zeros((12, cfg.field_h, cfg.field_w), jnp.int32))
    want = jstep._restamp_blockers(cfg12, js.ents, nav12).blockers
    got = tstep._restamp_blockers(_tcfg(cfg12), ts.ents, ts.nav)
    np.testing.assert_array_equal(got.numpy(), _n(want))


@pytest.mark.parametrize("frames", [30, 90])
def test_movement_substep_matches(frames):
    """One whole substep (exact ClearPath, the default) from the same
    state: pos/vel within 1e-4 on at least 99% of moving rows, movestate
    equal on at least 99%, no NaN. (Fan mode is left to test_torch_crowd:
    its edge-projection candidates sit on cone boundaries within the 1e-6
    feasibility tolerance, so XLA's FMA rounding flips a few picks.)"""
    cfg, host = _scene(frames)
    kernel = functools.partial(hrvo_select_pallas, interpret=True,
                               exact=cfg.clearpath_exact)
    js, jd = jstep.movement_substep(cfg, _j(host), jempty(cfg), kernel)
    tcfg = _tcfg(cfg)
    ts, td = tstep.movement_substep(tcfg, state_from_numpy(host, "cpu"),
                                    tempty(tcfg, device="cpu"))
    moving = np.asarray(host.ents.alive) & np.isin(
        np.asarray(host.ents.movestate), [MoveState.MOVING, MoveState.TURNING])
    assert moving.sum() >= 10
    for name in ("pos", "vel"):
        g = getattr(ts.ents, name).numpy()
        w = _n(getattr(js.ents, name))
        assert np.isfinite(g).all()
        close = np.all(np.abs(g - w) <= 1e-4, axis=1)
        assert close[moving].mean() >= 0.99, (name, close[moving].mean())
    same = ts.ents.movestate.numpy() == _n(js.ents.movestate)
    assert same[moving].mean() >= 0.99
    np.testing.assert_array_equal(ts.nav.blockers.numpy(), _n(js.nav.blockers))
    np.testing.assert_array_equal(td.arrived.numpy(), _n(jd.arrived))


def test_merge_deltas_matches():
    """Event masks OR; the projectile-hit triple follows the newer hit."""
    cfg = small_cfg()
    rng = np.random.default_rng(4)
    n, p = cfg.max_ents, cfg.max_projectiles

    def deltas():
        return dict(
            arrived=rng.random(n) < 0.3, motion_start=rng.random(n) < 0.3,
            died=rng.random(n) < 0.1, attack_started=rng.random(n) < 0.1,
            proj_hit=np.where(rng.random(p) < 0.4, rng.integers(0, n, p), -1
                              ).astype(np.int32),
            proj_hit_shooter=rng.integers(-1, n, p).astype(np.int32),
            proj_hit_cookie=rng.random(p).astype(np.float32),
            corpse_expired=rng.random(n) < 0.1)

    a, b = deltas(), deltas()
    from permafrost_engine_tpu.state.schema import TickDeltas as JD
    from permafrost_engine_tpu_torch.state.schema import TickDeltas as TD
    want = jstep.merge_deltas(JD(**{k: jnp.asarray(v) for k, v in a.items()}),
                              JD(**{k: jnp.asarray(v) for k, v in b.items()}))
    got = tstep.merge_deltas(TD(**{k: _t(v) for k, v in a.items()}),
                             TD(**{k: _t(v) for k, v in b.items()}))
    for k in a:
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      _n(getattr(want, k)), err_msg=k)
