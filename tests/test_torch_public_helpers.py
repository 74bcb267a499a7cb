"""The port's counterparts of the JAX package's remaining public helpers:
``ops/grid.build_grid`` and ``central_block_cols`` (on tests/test_grid.py's
cases), ``ops/flowfield.los_field_iter`` (on tests/test_flowfield.py's LOS
cases), ``NavService.request_path`` (a two-island map, against the JAX
service), and ``utils/native.parse_tiles`` and ``grid_dijkstra`` (against
the JAX bindings, the port's Python PFMAP parser and ``integrate_plain``).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core.config import EngineConfig as JaxConfig
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu.ops import flowfield as jff
from permafrost_engine_tpu.ops import grid as jgrid
from permafrost_engine_tpu.utils import native as jnative
from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
from permafrost_engine_tpu_torch.assets.pfmap import parse_pfmap, write_pfmap
from permafrost_engine_tpu_torch.core.config import (
    COST_IMPASSABLE,
    FIELD_RES,
    INF_COST,
    EngineConfig,
    SPATIAL_CELL_SIZE,
    TILES_PER_CHUNK,
)
from permafrost_engine_tpu_torch.game.engine import Engine
from permafrost_engine_tpu_torch.ops import flowfield as tff
from permafrost_engine_tpu_torch.ops import grid as tgrid
from permafrost_engine_tpu_torch.utils import native as tnative

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _world(rng, n=200, world=160.0, n_dead=20):
    """tests/test_grid.py's make_world."""
    pos = rng.random((n, 2)).astype(np.float32) * world
    alive = np.ones(n, bool)
    alive[rng.choice(n, n_dead, replace=False)] = False
    return pos, alive, int(np.ceil(world / SPATIAL_CELL_SIZE))


def _grid_pair(pos, alive, cells, cap, payload=None, cell_size=SPATIAL_CELL_SIZE):
    kw = dict(cells_r=cells, cells_c=cells, cap=cap, cell_size=cell_size)
    want = jgrid.build_grid(jnp.asarray(pos), jnp.asarray(alive),
                            payload=None if payload is None
                            else jnp.asarray(payload), **kw)
    got = tgrid.build_grid(torch.from_numpy(pos), torch.from_numpy(alive),
                           payload=None if payload is None
                           else torch.from_numpy(payload), **kw)
    return want, got


@pytest.mark.parametrize("seed,n,n_dead,cap", [(0, 200, 20, 32), (1, 300, 20, 64),
                                              (2, 100, 50, 32)])
def test_build_grid_equals_jax(seed, n, n_dead, cap):
    """The buckets, positions and cells of test_grid.py's worlds equal the
    JAX build's, and every alive entity sits in its own cell's bucket."""
    pos, alive, cells = _world(np.random.default_rng(seed), n=n, n_dead=n_dead)
    want, got = _grid_pair(pos, alive, cells, cap)
    buckets = got.buckets.numpy()
    np.testing.assert_array_equal(buckets, np.asarray(want.buckets))
    np.testing.assert_array_equal(got.bucket_xy.numpy(),
                                  np.asarray(want.bucket_xy))
    np.testing.assert_array_equal(got.cell_of.numpy(), np.asarray(want.cell_of))
    assert got.bucket_payload is None and want.bucket_payload is None
    indexed = buckets[buckets >= 0]
    assert sorted(indexed) == sorted(np.nonzero(alive)[0])
    cell_of = got.cell_of.numpy()
    for slot in indexed:
        assert slot in buckets[cell_of[slot]]


def test_build_grid_payload_and_overflow_equal_jax():
    """A payload rides with its slots, the fine cell size of
    test_build_grid_pair_matches_separate_builds works, and an overflowing
    cell keeps its first `cap` slots, as in JAX."""
    rng = np.random.default_rng(7)
    pos, alive, _ = _world(rng, n=400)
    pay = rng.random((400, 3)).astype(np.float32)
    fine = int(np.ceil(160.0 / 4.0))
    for cells, cap, size in ((10, 64, SPATIAL_CELL_SIZE), (fine, 16, 4.0)):
        want, got = _grid_pair(pos, alive, cells, cap, pay, size)
        np.testing.assert_array_equal(got.buckets.numpy(),
                                      np.asarray(want.buckets))
        np.testing.assert_array_equal(got.bucket_payload.numpy(),
                                      np.asarray(want.bucket_payload))
    pile = np.full((40, 2), 2.0, np.float32)
    want, got = _grid_pair(pile, np.ones(40, bool), 4, 8)
    np.testing.assert_array_equal(got.buckets.numpy(), np.asarray(want.buckets))
    assert (got.buckets.numpy()[0] >= 0).sum() == 8


@pytest.mark.parametrize("window,sub,cap", [(5, 3, 3), (5, 1, 4), (3, 3, 2),
                                            (7, 3, 5)])
def test_central_block_cols_equals_jax(window, sub, cap):
    cols = tgrid.central_block_cols(window, sub, cap)
    np.testing.assert_array_equal(cols, jgrid.central_block_cols(window, sub, cap))
    assert cols.dtype == np.int32 and len(cols) == sub * sub * cap
    off = (window - sub) // 2
    blocks = sorted({int(c) // cap for c in cols})
    assert blocks == sorted(dr * window + dc for dr in range(off, off + sub)
                            for dc in range(off, off + sub))


def test_central_block_cols_rejects_off_centre():
    with pytest.raises(ValueError):
        tgrid.central_block_cols(5, 2, 3)


def _los_cases():
    """tests/test_flowfield.py's LOS scenes: random densities and sizes,
    a maze, corner goals, an impassable goal, a batch with per-element
    goals. Yields (passable, goal_r, goal_c, max_iters)."""
    rng = np.random.default_rng(3)
    for _ in range(8):
        h = int(rng.choice([16, 33, 64]))
        w = int(rng.choice([16, 33, 64]))
        p = rng.random((h, w)) > rng.uniform(0.0, 0.5)
        yield p, int(rng.integers(0, h)), int(rng.integers(0, w)), 2 * max(h, w)
    p = np.ones((64, 64), bool)
    for _ in range(25):
        r, c = rng.integers(0, 64, 2)
        n = int(rng.integers(5, 30))
        if rng.random() < 0.5:
            p[r, c:c + n] = False
        else:
            p[r:r + n, c] = False
    p[40, 40] = True
    yield p, 40, 40, 128
    for gr, gc in [(0, 0), (63, 63), (0, 63)]:
        yield np.ones((64, 64), bool), gr, gc, 128
    p = np.ones((32, 32), bool)
    p[5, 5] = False
    yield p, 5, 5, 64
    p = rng.random((4, 64, 64)) > 0.25
    yield p, rng.integers(0, 64, 4), rng.integers(0, 64, 4), 128


def test_los_field_iter_equals_jax_and_closed_form():
    """``los_field_iter`` equals the JAX oracle and the port's closed-form
    ``los_field`` on every LOS scene of test_flowfield.py."""
    n = seen = 0
    for p, gr, gc, iters in _los_cases():
        got = tff.los_field_iter(torch.from_numpy(p), gr, gc,
                                 max_iters=iters).numpy()
        want = np.asarray(jff.los_field_iter(jnp.asarray(p), jnp.asarray(gr),
                                             jnp.asarray(gc), max_iters=iters))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, tff.los_field(torch.from_numpy(p), gr, gc).numpy())
        n += 1
        seen += int(got.sum())
    assert n == 14 and got.shape == (4, 64, 64)
    assert seen > 10000


def _two_islands(cfg):
    """A 1-layer map cut in two by an impassable band at nav rows 60-63."""
    cost = np.ones((1, cfg.field_h, cfg.field_w), np.uint8)
    cost[:, 60:64, :] = COST_IMPASSABLE
    return cost


@pytest.mark.parametrize("goal", [(300.0, 120.0), (300.0, 400.0)])
def test_request_path_two_islands_equals_jax(goal):
    """One path request on a two-island map through both services: on the
    start's island, and across the band, where the goal retargets to the
    closest tile of the start's island. Reachability, the effective goal,
    the flock's slot tables and the installed fields equal JAX's."""
    cfg = EngineConfig(max_ents=64, chunks_r=2, chunks_c=2, num_layers=1,
                       max_flocks=8, max_projectiles=16, field_slab_slots=16,
                       los_slab_slots=16)
    jeng = JaxEngine(JaxConfig(**dataclasses.asdict(cfg)),
                     cost_base=_two_islands(cfg))
    teng = Engine(cfg, device="cpu", cost_base=_two_islands(cfg))
    jstate, jok, jeff = jeng.nav.request_path(jeng.state, 0, (40.0, 40.0),
                                              goal, 0)
    tstate, tok, teff = teng.nav.request_path(teng.state, 0, (40.0, 40.0),
                                              goal, 0)
    assert tok == jok and tok
    np.testing.assert_allclose(teff, jeff)
    assert (teff[1] < 60 * 4.0) and ((teff == goal) == (goal[1] < 240))
    np.testing.assert_array_equal(teng.nav.slot_mirror, jeng.nav.slot_mirror)
    np.testing.assert_array_equal(teng.nav.los_mirror, jeng.nav.los_mirror)
    slots = np.unique(teng.nav.slot_mirror[teng.nav.slot_mirror >= 0])
    assert len(slots) >= 2
    np.testing.assert_array_equal(tstate.fields.flow.numpy()[slots],
                                  np.asarray(jstate.fields.flow)[slots])
    assert teng.nav.stats["retargeted"] == (goal[1] > 240)


def _tile_text(text: str):
    """The tile records of a PFMAP text (what follows the header) and the
    tile count."""
    m = parse_pfmap(text)
    lines = [ln for ln in text.splitlines() if ln.strip()]
    head = 5 + len(m.materials) + len(m.splats)
    total = m.chunks_r * m.chunks_c * TILES_PER_CHUNK * TILES_PER_CHUNK
    return m, "\n".join(lines[head:]), total


@pytest.mark.parametrize("source", ["demo.pfmap", "battle"])
def test_parse_tiles_equals_jax_and_python_parser(source):
    """The native tile parser on the asset map and the written battle map
    equals the JAX binding's result and the port's Python PFMAP parser."""
    if source == "battle":
        text = write_pfmap(make_battle_map())
    else:
        with open(os.path.join(_REPO, "assets", "maps", source)) as f:
            text = f.read()
    m, tiles, total = _tile_text(text)
    got = tnative.parse_tiles(tiles, total)
    want = jnative.parse_tiles(tiles, total)
    assert got is not None and want is not None
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # file order -> (r, c): chunks row-major, tiles row-major in a chunk
    idx = np.arange(total)
    chunk, within = idx // TILES_PER_CHUNK ** 2, idx % TILES_PER_CHUNK ** 2
    rr = (chunk // m.chunks_c) * TILES_PER_CHUNK + within // TILES_PER_CHUNK
    cc = (chunk % m.chunks_c) * TILES_PER_CHUNK + within % TILES_PER_CHUNK
    for k in got:
        np.testing.assert_array_equal(got[k], getattr(m, k)[rr, cc], err_msg=k)
    assert tnative.parse_tiles(tiles[:len(tiles) // 2], total) is None


def test_grid_dijkstra_equals_jax_and_integration():
    """The native Dijkstra equals the JAX binding's and, to rounding, the
    fixed point of the port's integration on a maze with two seeds."""
    rng = np.random.default_rng(11)
    cost = rng.integers(1, 4, (FIELD_RES, FIELD_RES)).astype(np.uint8)
    cost[rng.random(cost.shape) < 0.25] = COST_IMPASSABLE
    seeds = np.array([5 * FIELD_RES + 7, 50 * FIELD_RES + 40], np.int64)
    cost.reshape(-1)[seeds] = 1
    got = tnative.grid_dijkstra(cost, seeds)
    np.testing.assert_array_equal(got, jnative.grid_dijkstra(cost, seeds))
    mask = np.zeros(cost.size, bool)
    mask[seeds] = True
    integ = tff.integrate_plain(torch.from_numpy(cost)[None],
                                torch.from_numpy(mask.reshape(cost.shape))[None]
                                ).numpy()[0]
    reach = integ < INF_COST / 2
    np.testing.assert_array_equal(got < 1e29, reach)
    np.testing.assert_allclose(got[reach], integ[reach], rtol=1e-5)
    assert reach.sum() > 0.5 * cost.size
