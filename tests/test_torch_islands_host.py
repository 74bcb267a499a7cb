"""The host island labeller against both device labellers, and the nav
service that labels with it.

* ``ops.islands.label_islands_host`` (4-connected components, each tile
  given its component's smallest linear id) against the port's
  ``label_islands`` and the JAX package's, ids and dtype, no tolerance:
  every layer of the battle map and of the flat map, seeded random maps at
  25-75% impassable, a diagonal pinch, all passable, all impassable, and
  batched inputs.
* ``NavService.islands`` after ``commit_structures`` with a stamped
  footprint equals ``label_islands`` of the new ``cost_base``; the
  ``nav.islands`` scope counts one labelling per layer asked for and none
  for a cached layer, and a labelling runs no torch op and waits on no
  fetch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

torch.set_num_threads(1)

from permafrost_engine_tpu.ops.islands import label_islands as jlabel
from permafrost_engine_tpu_torch.assets.mapgen import make_battle_map
from permafrost_engine_tpu_torch.assets.pfmap import (compile_nav_costs,
                                                      make_flat_map)
from permafrost_engine_tpu_torch.core.config import (COST_IMPASSABLE,
                                                     EngineConfig,
                                                     NUM_FOOTPRINTS,
                                                     NavDomain)
from permafrost_engine_tpu_torch.game.engine import Engine
from permafrost_engine_tpu_torch.ops.islands import (label_islands,
                                                     label_islands_host)


def _assert_all_equal(cost):
    """The host labeller equals both device labellers on `cost`, and each
    of its leading slices labelled alone."""
    got = label_islands_host(cost)
    want_t = label_islands(torch.from_numpy(cost)).numpy()
    want_j = np.asarray(jlabel(jnp.asarray(cost)))
    assert got.dtype == want_t.dtype == want_j.dtype == np.int32
    assert got.shape == cost.shape
    np.testing.assert_array_equal(got, want_t)
    np.testing.assert_array_equal(got, want_j)
    flat = cost.reshape(-1, *cost.shape[-2:])
    for i, layer in enumerate(got.reshape(flat.shape)):
        np.testing.assert_array_equal(label_islands_host(flat[i]), layer)
    return got


MAPS = {"battle": lambda: make_battle_map(4),
        "flat": lambda: make_flat_map(4, 4)}


@pytest.mark.parametrize("name", sorted(MAPS))
def test_map_layers_equal(name):
    cost, _heights = compile_nav_costs(MAPS[name]())
    assert cost.shape[0] == 12
    got = _assert_all_equal(cost)
    ground = got[int(NavDomain.GROUND) * NUM_FOOTPRINTS]
    if name == "battle":
        # the wall, river and cliffs cut the ground; the bridges cut the
        # river into several stretches of water
        assert (ground < 0).any() and (ground >= 0).any()
        water = got[int(NavDomain.WATER) * NUM_FOOTPRINTS]
        assert len(np.unique(water[water >= 0])) >= 2
    else:
        assert (ground == 0).all()


@pytest.mark.parametrize("frac", [0.25, 0.5, 0.75])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_maps_equal(seed, frac):
    rng = np.random.default_rng(100 * seed + int(frac * 100))
    cost = rng.integers(1, 8, (2, 48, 80)).astype(np.uint8)
    cost[rng.random(cost.shape) < frac] = COST_IMPASSABLE
    got = _assert_all_equal(cost)
    assert len(np.unique(got)) > 3


def test_diagonal_pinch_is_two_islands():
    """Tiles touching only at a corner are two islands; a third tile next
    to both joins them."""
    cost = np.full((4, 5), COST_IMPASSABLE, np.uint8)
    cost[1, 1] = cost[2, 2] = 1
    got = _assert_all_equal(cost)
    assert got[1, 1] == 1 * 5 + 1 and got[2, 2] == 2 * 5 + 2
    assert (got >= 0).sum() == 2
    cost[1, 2] = 1
    got = _assert_all_equal(cost)
    assert got[1, 1] == got[1, 2] == got[2, 2] == 6


@pytest.mark.parametrize("fill", ["passable", "impassable"])
def test_uniform_maps(fill):
    cost = np.full((3, 16, 24), 1 if fill == "passable" else COST_IMPASSABLE,
                   np.uint8)
    got = _assert_all_equal(cost)
    assert (got == (0 if fill == "passable" else -1)).all()


def test_batched_leading_dims():
    """[L, H, W] and [A, B, H, W]: each slice labelled on its own, the ids
    local to it."""
    rng = np.random.default_rng(7)
    cost = np.ones((2, 3, 32, 40), np.uint8)
    cost[rng.random(cost.shape) < 0.4] = COST_IMPASSABLE
    got = _assert_all_equal(cost)
    np.testing.assert_array_equal(label_islands_host(cost[1]), got[1])
    assert got.max() < 32 * 40


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _corridor_engine():
    """A 2x2-chunk engine on 12 layers: the ground layers split by a wall
    at columns 60-61 with one gap at rows 30-39, the water layers a pond,
    the air layers open."""
    cfg = EngineConfig(max_ents=64, chunks_r=2, chunks_c=2, num_layers=12,
                       max_flocks=8, max_projectiles=8, field_slab_slots=32,
                       los_slab_slots=32)
    cost = np.ones((12, cfg.field_h, cfg.field_w), np.uint8)
    for fp in range(NUM_FOOTPRINTS):
        g = int(NavDomain.GROUND) * NUM_FOOTPRINTS + fp
        cost[g, :, 60:62] = COST_IMPASSABLE
        cost[g, 30:40, 60:62] = 1
        w = int(NavDomain.WATER) * NUM_FOOTPRINTS + fp
        cost[w] = COST_IMPASSABLE
        cost[w, 20:50, 40:90] = 1
    return Engine(cfg, device="cpu", cost_base=cost)


def test_service_relabels_after_commit():
    eng = _corridor_engine()
    nav, counters = eng.nav, eng.counters
    layers = (0, 4, 8)

    def n():
        return counters.get("nav.islands.n", 0)

    n0 = n()
    before = {layer: nav.islands(layer) for layer in layers}
    assert n() - n0 == len(layers)
    for layer in layers:
        nav.islands(layer)
    assert n() - n0 == len(layers)
    assert len(np.unique(before[0][before[0] >= 0])) == 1

    # close the gap: the ground layers split in two; the pond loses a strip
    nav.stamp_structure((28, 41, 58, 63), +1)
    nav.stamp_structure((20, 49, 64, 66), +1)
    eng.state, dirty = nav.commit_structures(eng.state)
    assert dirty
    n1 = n()
    with _CountOps() as ops:
        after = {layer: nav.islands(layer) for layer in layers}
        nav.islands(0)
    assert ops.n == 0
    # the ground and water layers relabelled once each; air kept its ids
    assert n() - n1 == 2
    assert after[8] is before[8]
    assert counters.get("nav.islands.wait_ms", 0.0) == 0.0
    for layer in layers:
        cost = nav.cost_base[layer]
        np.testing.assert_array_equal(
            after[layer], label_islands(torch.from_numpy(cost)).numpy())
        np.testing.assert_array_equal(
            after[layer], np.asarray(jlabel(jnp.asarray(cost))))
    assert len(np.unique(after[0][after[0] >= 0])) == 2
    assert not np.array_equal(after[4], before[4])
