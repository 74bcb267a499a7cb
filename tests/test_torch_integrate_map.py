"""PyTorch port vs the JAX package: whole-map integration (kernel K2's
map shape class) and the port's own copies of the JAX-free modules.

Whole-map fields: the same seeded numpy inputs go through the JAX
``ff.integrate`` (XLA, 16-sweep convergence checks, cap 4*max(H, W)) and the
port's ``flowfield_cuda.integrate`` on the CPU, where the wrapper runs K2's
plain version (8-sweep bundles). Both stop at a fixed point or at the same
cap, so the fields are bit-equal, cap-bound serpentine included. The
chase-field build must route through that wrapper, and the wrapper must
refuse shapes no cluster of K2 can hold.

Copies: every constant and enum of the port's ``core/config.py``, its
``EventType``, ``EngineConfig``, ``assign_ring_slots``, ``make_battle_map``
and ``compile_nav_costs`` equal the JAX package's (and ``tools/mapgen``'s).
"""

import dataclasses
import enum
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.assets import pfmap as jpfmap
from permafrost_engine_tpu.core import config as jconfig
from permafrost_engine_tpu.core import events as jevents
from permafrost_engine_tpu.game import arrival as jarrival
from permafrost_engine_tpu.ops import flowfield as jff
from permafrost_engine_tpu_torch.assets import mapgen as tmapgen
from permafrost_engine_tpu_torch.assets import pfmap as tpfmap
from permafrost_engine_tpu_torch.core import config as tconfig
from permafrost_engine_tpu_torch.core import events as tevents
from permafrost_engine_tpu_torch.game import arrival as tarrival
from permafrost_engine_tpu_torch.game.engine import Engine
from permafrost_engine_tpu_torch.nav import service
from permafrost_engine_tpu_torch.ops import flowfield_cuda
from permafrost_engine_tpu_torch.ops.flowfield import integrate_plain

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import mapgen as jmapgen  # noqa: E402

BLOCKED = jconfig.COST_IMPASSABLE


def _map_cost(chunks: int, layer: int = 0) -> np.ndarray:
    """A layer of the battle map's compiled costs at `chunks` x `chunks`."""
    cost, _ = jpfmap.compile_nav_costs(jmapgen.make_battle_map(chunks))
    return np.ascontiguousarray(cost[layer])


def _enemy_seeds(cost: np.ndarray, k: int, seed: int) -> np.ndarray:
    """Chase-field seeds: per field, ~150 passable tiles scattered over a
    few clusters (an army's unit tiles), none on the field's own side."""
    rng = np.random.default_rng(seed)
    h, w = cost.shape
    seeds = np.zeros((k, h, w), bool)
    for f in range(k):
        centres = rng.random((4, 2)) * [h, w / 2] + [0, (f % 2) * w / 2]
        pts = centres[rng.integers(0, 4, 150)] + rng.normal(0, 6, (150, 2))
        r = np.clip(pts[:, 0].astype(int), 0, h - 1)
        c = np.clip(pts[:, 1].astype(int), 0, w - 1)
        seeds[f, r, c] = True
    return seeds & (cost != BLOCKED)[None]


def _jax(cost, seeds, svals=None, cap=None):
    h, w = cost.shape[-2:]
    return np.asarray(jff.integrate(
        jnp.asarray(cost), jnp.asarray(seeds),
        None if svals is None else jnp.asarray(svals),
        max_iters=cap or 4 * max(h, w)))


def _port(cost, seeds, svals=None, **kw):
    return flowfield_cuda.integrate(
        torch.from_numpy(cost), torch.from_numpy(seeds),
        None if svals is None else torch.from_numpy(svals), **kw).numpy()


@pytest.mark.parametrize("chunks", [2, 4])
def test_whole_map_bit_equal_to_xla(chunks):
    """[2, 128, 128] and [2, 256, 256] battle-map fields, seeded like the
    chase fields, equal the JAX whole-map integration bit for bit."""
    cost1 = _map_cost(chunks)
    seeds = _enemy_seeds(cost1, 2, chunks)
    cost = np.ascontiguousarray(np.broadcast_to(cost1, seeds.shape))
    want = _jax(cost, seeds)
    stats = {}
    got = integrate_plain(
        torch.from_numpy(cost), torch.from_numpy(seeds), stats=stats,
        max_iters=4 * 64 * chunks).numpy()
    np.testing.assert_array_equal(_port(cost, seeds), want)
    np.testing.assert_array_equal(got, want)
    reach = want < 1e30
    assert reach.mean() > 0.6 and want[reach].max() > 100.0
    assert 0 < stats["sweeps"] < 4 * 64 * chunks     # converged early


def test_serpentine_cap_binds_bit_equal():
    """A 128x128 serpentine (walls every 4 rows, gaps at alternating ends):
    the geodesic is ~4,000 tiles, so the 512-sweep cap binds and any other
    sweep order than Jacobi would differ."""
    h = w = 128
    cost = np.ones((1, h, w), np.uint8)
    for i, r in enumerate(range(4, h, 4)):
        cost[0, r, :] = BLOCKED
        cost[0, r, (w - 1) if i % 2 == 0 else 0] = 1
    seeds = np.zeros_like(cost, bool)
    seeds[0, 0, 0] = True
    want = _jax(cost, seeds)
    stats = {}
    integrate_plain(torch.from_numpy(cost), torch.from_numpy(seeds),
                    stats=stats, max_iters=4 * h)
    np.testing.assert_array_equal(_port(cost, seeds), want)
    assert stats["sweeps"] == 4 * h
    reach = want < 1e30
    assert 0.1 < reach.mean() < 0.9             # the cap cut the wavefront


def test_whole_map_seed_cost_bit_equal():
    """Seed costs at a whole-map shape: union-style seeds carry their
    remaining cost."""
    cost1 = _map_cost(2, layer=1)               # the 3x3 ground footprint
    seeds = _enemy_seeds(_map_cost(2), 2, 7) & (cost1 != BLOCKED)[None]
    rng = np.random.default_rng(7)
    svals = (rng.random(seeds.shape) * 300).astype(np.float32)
    cost = np.ascontiguousarray(np.broadcast_to(cost1, seeds.shape))
    np.testing.assert_array_equal(_port(cost, seeds, svals),
                                  _jax(cost, seeds, svals))


def test_chase_fields_route_through_k2(monkeypatch):
    """``build_enemy_seek_fields_batch`` integrates through
    ``flowfield_cuda.integrate`` (K2 on a card), whole maps at once."""
    calls = []

    def counting(cost, seeds, seed_cost=None, **kw):
        calls.append((tuple(cost.shape), kw.get("max_iters")))
        return flowfield_cuda.integrate(cost, seeds, seed_cost, **kw)

    monkeypatch.setattr(service, "integrate", counting)
    assert not hasattr(service, "integrate_plain")
    cfg = tconfig.EngineConfig(max_ents=32, chunks_r=2, chunks_c=2,
                               num_layers=1, max_flocks=4, max_projectiles=8,
                               field_slab_slots=8, los_slab_slots=8)
    eng = Engine(cfg, device="cpu")
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, tconfig.DiplomacyState.WAR)
    eng.spawn_batch(np.array([[40.0, 40.0]], np.float32), faction=0)
    eng.spawn_batch(np.array([[400.0, 420.0], [380.0, 60.0]], np.float32),
                    faction=1)
    eng.state = eng.nav.build_enemy_seek_fields_batch(
        eng.state, [(0, 0, 0, None), (1, 0, 1, None)])
    assert calls == [((2, 128, 128), 512)]
    flow = eng.state.fields.global_flow[:2]
    assert (flow > 0).float().mean() > 0.9


@pytest.mark.parametrize("shape", [(1, 64, 96), (1, 96, 64), (2, 32, 32),
                                   (1, 64, 2048)])
def test_wrapper_raises_on_shapes_it_cannot_take(shape):
    """H and W must be multiples of 64, and a strip of the field must fit
    one block (at most 1,024 columns); the wrapper raises on the CPU too,
    before any fallback could run."""
    cost = torch.ones(shape, dtype=torch.uint8)
    seeds = torch.zeros(shape, dtype=torch.bool)
    with pytest.raises(ValueError):
        flowfield_cuda.integrate(cost, seeds)


def test_cluster_plans():
    """The cut of each shape class: 64x64 chunks as 4 strips of 16 rows
    (256 threads, 4 rows each), a 256x256 map as 16 strips (512 threads,
    8 rows each); every plan fits one block's shared memory."""
    assert flowfield_cuda.plan(64, 64) == (4, 4, 256, 2 * 18 * 66 * 4)
    assert flowfield_cuda.plan(256, 256) == (16, 8, 512, 2 * 18 * 258 * 4)
    assert flowfield_cuda.plan(128, 192)[:3] == (8, 8, 384)
    assert flowfield_cuda.plan(512, 512)[:3] == (16, 16, 1024)
    with pytest.raises(ValueError):
        flowfield_cuda.plan(1024, 1024)
    with pytest.raises(ValueError):
        flowfield_cuda.plan(64, 2048)
    for h, w in ((64, 64), (128, 128), (256, 256), (512, 512), (64, 1024)):
        p, m, threads, smem = flowfield_cuda.plan(h, w)
        assert smem <= flowfield_cuda.SMEM_BYTES and threads <= 1024
        assert (h // p) % m == 0 and p <= 16


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and k.isupper() or
            (isinstance(v, type) and issubclass(v, enum.Enum)
             and v.__module__ == mod.__name__)}


def test_config_copy_equals_jax():
    """Every constant and enum value of the port's config equals the JAX
    package's, and the EngineConfig fields, defaults and derived geometry
    agree."""
    ours, theirs = _public(tconfig), _public(jconfig)
    assert set(ours) == set(theirs)
    for name, v in ours.items():
        if isinstance(v, type):
            assert ({m.name: m.value for m in v}
                    == {m.name: m.value for m in theirs[name]}), name
        else:
            assert v == theirs[name], name
    assert ([(f.name, f.default) for f in dataclasses.fields(tconfig.EngineConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(jconfig.EngineConfig)])
    for kw in ({}, dict(chunks_r=2, chunks_c=3)):
        a, b = tconfig.EngineConfig(**kw), jconfig.EngineConfig(**kw)
        for prop in ("field_h", "field_w", "tiles_h", "tiles_w", "world_h",
                     "world_w", "num_chunks", "grid_cells_r", "grid_cells_c",
                     "contact_cells_r", "contact_cells_c"):
            assert getattr(a, prop) == getattr(b, prop), prop
    for r in (0.5, 2.0, 6.0, 9.0, 20.0):
        assert tconfig.footprint_for_radius(r) == jconfig.footprint_for_radius(r)


def test_events_and_arrival_copies_equal_jax():
    assert ({m.name: m.value for m in tevents.EventType}
            == {m.name: m.value for m in jevents.EventType})
    assert (tevents.ES_RUNNING, tevents.ES_ALL, tevents.GLOBAL_UID) == (
        jevents.ES_RUNNING, jevents.ES_ALL, jevents.GLOBAL_UID)
    rng = np.random.default_rng(3)
    pos = (rng.random((40, 2)) * 200).astype(np.float32)
    goal = np.array([120.0, 90.0], np.float32)
    cost = _map_cost(1)
    np.testing.assert_array_equal(
        tarrival.assign_ring_slots(pos, goal, 3.0, cost),
        jarrival.assign_ring_slots(pos, goal, 3.0, cost))


@pytest.mark.parametrize("chunks", [2, 4])
def test_battle_map_and_nav_costs_equal_jax(chunks):
    ours, theirs = tmapgen.make_battle_map(chunks), jmapgen.make_battle_map(chunks)
    for f in dataclasses.fields(theirs):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    tc, th = tpfmap.compile_nav_costs(ours)
    jc, jh = jpfmap.compile_nav_costs(theirs)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(th, jh)
    assert tc.dtype == jc.dtype and th.dtype == jh.dtype
    assert (tc == BLOCKED).any() and np.ptp(th) > 0.5
