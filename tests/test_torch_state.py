"""PyTorch port vs the JAX package: the game-state schema and conversion.

``init_state`` must equal the JAX ``init_state`` leaf by leaf (names,
shapes, dtypes, values); ``flags`` keeps its u32 bits through the port's
int32 storage; a JAX state carried across with ``state_from_numpy`` comes
back unchanged through ``state_to_numpy``.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core.config import EngineConfig, EntityFlags
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu.state import schema as jschema
from permafrost_engine_tpu_torch.state import schema as tschema
from permafrost_engine_tpu_torch.state.convert import (
    state_from_numpy,
    state_to_numpy,
)
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig

_CFG = EngineConfig(max_ents=48, chunks_r=2, chunks_c=3, num_layers=4,
                    max_flocks=6, max_projectiles=20, field_slab_slots=8,
                    los_slab_slots=8, global_field_slots=2, max_factions=4)


def _tcfg(cfg):
    """The port's EngineConfig with the same fields as a JAX one."""
    return TorchConfig(**dataclasses.asdict(cfg))


def _assert_same_tree(ours: dict, theirs):
    """Every leaf of the port's numpy tree equals the JAX state's leaf."""
    for comp, fields in ours.items():
        if comp in ("tick", "rng"):
            want = np.asarray(getattr(theirs, comp))
            assert fields.dtype == want.dtype and np.array_equal(fields, want), comp
            continue
        src = getattr(theirs, comp)
        names = {f.name for f in dataclasses.fields(src)}
        assert set(fields) == names, comp
        for name, got in fields.items():
            want = np.asarray(getattr(src, name))
            assert got.dtype == want.dtype, (comp, name, got.dtype, want.dtype)
            assert got.shape == want.shape, (comp, name)
            np.testing.assert_array_equal(got, want, err_msg=f"{comp}.{name}")


@pytest.mark.parametrize("seed", [0, 7])
def test_init_state_matches_leaf_by_leaf(seed):
    ours = state_to_numpy(tschema.init_state(_tcfg(_CFG), seed=seed, device="cpu"))
    theirs = jax.device_get(jschema.init_state(_CFG, seed=seed))
    _assert_same_tree(ours, theirs)


def test_empty_deltas_match():
    ours = tschema.empty_deltas(_tcfg(_CFG), device="cpu")
    theirs = jax.device_get(jschema.empty_deltas(_CFG))
    for f in dataclasses.fields(ours):
        got = getattr(ours, f.name).numpy()
        want = np.asarray(getattr(theirs, f.name))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_flags_bits_and_round_trip():
    """A spawned JAX state (flags with high bits set) round-trips: flags
    bit for bit, every other leaf equal."""
    cfg = EngineConfig(max_ents=32, chunks_r=1, chunks_c=1, num_layers=1,
                       max_flocks=4, max_projectiles=8, field_slab_slots=4,
                       los_slab_slots=4)
    eng = JaxEngine(cfg)
    flags = int(EntityFlags.COLLISION | EntityFlags.MOVABLE | EntityFlags.DYING
                | EntityFlags.GARRISONABLE | EntityFlags.AIR)
    eng.spawn_batch(np.array([[10.0, 20.0], [30.0, 40.0]], np.float32),
                    flags=flags, max_speed=np.array([5.0, 7.0], np.float32))
    host = jax.device_get(eng.state)
    ts = state_from_numpy(host, "cpu")
    assert ts.ents.flags.dtype.is_signed
    np.testing.assert_array_equal(ts.ents.flags.numpy().view(np.uint32),
                                  np.asarray(host.ents.flags))
    assert int(ts.ents.flags[0]) == flags
    _assert_same_tree(state_to_numpy(ts), host)


def test_skinning_not_ported():
    cfg = dataclasses.replace(_CFG, skin_joints=4)
    with pytest.raises(NotImplementedError):
        tschema.init_state(_tcfg(cfg), device="cpu")
