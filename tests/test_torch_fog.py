"""PyTorch port vs the JAX package: fog of war and the shadowcaster.

Seeded numpy viewers (clustered, several per tile, some dead or without
vision) and terrain go through the JAX functions and the port's. Every
result is bit-equal: the fog planes (u8 FogState codes) on a flat map and
with a ``tile_height``, and the shadowcaster's per-faction masks on random
terrain and on the battle map's heights (``tools/mapgen.make_battle_map``:
a plateau and a river bed).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.assets.pfmap import compile_nav_costs
from permafrost_engine_tpu.ops import fog as jfog
from permafrost_engine_tpu.ops.shadowcast import shadowcast_visibility as jsc
from permafrost_engine_tpu_torch.ops import fog as tfog
from permafrost_engine_tpu_torch.ops.shadowcast import (
    shadowcast_visibility as tsc,
)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from mapgen import make_battle_map  # noqa: E402

F = 16


def _viewers(rng, n, th, tw):
    centers = rng.random((5, 2)) * np.array([tw * 8.0, th * 8.0])
    pos = centers[rng.integers(0, 5, n)] + rng.normal(0, 30, (n, 2))
    pos = np.clip(pos, -5, [tw * 8.0 + 5, th * 8.0 + 5]).astype(np.float32)
    alive = rng.random(n) < 0.9
    faction = rng.integers(-1, 4, n).astype(np.int32)
    vision = (rng.random(n) * 150).astype(np.float32)
    vision[rng.random(n) < 0.05] = 0.0
    return pos, alive, faction, vision


def _fog_both(seed, n, th, tw, height=None):
    rng = np.random.default_rng(seed)
    pos, alive, faction, vision = _viewers(rng, n, th, tw)
    prev = rng.integers(0, 3, (F, th, tw)).astype(np.uint8)
    kw = dict(tiles_h=th, tiles_w=tw, max_factions=F)
    out = []
    for enabled in (True, False):
        want = np.asarray(jfog.update_fog(
            jnp.asarray(prev), jnp.asarray(enabled), jnp.asarray(pos),
            jnp.asarray(alive), jnp.asarray(faction), jnp.asarray(vision),
            None if height is None else jnp.asarray(height), **kw))
        got = tfog.update_fog(
            torch.from_numpy(prev), torch.tensor(enabled),
            torch.from_numpy(pos), torch.from_numpy(alive),
            torch.from_numpy(faction), torch.from_numpy(vision),
            None if height is None else torch.from_numpy(height), **kw)
        out.append((got.numpy(), want))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_update_fog_flat_exact(seed):
    (got, want), (got_off, want_off) = _fog_both(seed, 600, 64, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_off, want_off)
    assert (want == 2).sum() > 500 and (want == 1).sum() > 500


def test_update_fog_with_height_exact():
    rng = np.random.default_rng(3)
    height = (rng.random((64, 64)) * 3).astype(np.float32)
    height[20:40, 10:50] += 6.0
    (got, want), (got_off, want_off) = _fog_both(4, 900, 64, 64, height)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_off, want_off)
    assert (want == 2).sum() > 500


def _battle_heights():
    _cost, heights = compile_nav_costs(make_battle_map())
    return heights[::2, ::2].astype(np.float32)


@pytest.mark.parametrize("terrain", ["random", "battle_map"])
def test_shadowcast_exact(terrain):
    rng = np.random.default_rng(5)
    if terrain == "random":
        th = tw = 48
        height = (rng.random((th, tw)) * 8).astype(np.float32)
    else:
        height = _battle_heights()
        th, tw = height.shape
        assert np.ptp(height) > 0.5
    n = 700
    pos_rc = np.stack([rng.integers(0, th, n), rng.integers(0, tw, n)],
                      1).astype(np.int32)
    ok = rng.random(n) < 0.9
    faction = rng.integers(0, 4, n).astype(np.int32)
    vision = (rng.random(n) * 18).astype(np.float32)
    kw = dict(radius=16, tiles_h=th, tiles_w=tw, max_factions=F)
    want = np.asarray(jsc(jnp.asarray(pos_rc), jnp.asarray(ok),
                          jnp.asarray(faction), jnp.asarray(vision),
                          jnp.asarray(height), **kw))
    got = tsc(torch.from_numpy(pos_rc), torch.from_numpy(ok),
              torch.from_numpy(faction), torch.from_numpy(vision),
              torch.from_numpy(height), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 1000
