"""PyTorch port vs the JAX package: flow fields, LOS, islands, portals.

The same seeded numpy inputs go through the JAX functions and the port's
counterparts on the CPU, where the port's kernel wrappers run their plain
versions (kernel K2's plain version is ``ops/flowfield.integrate_plain``).
The JAX Pallas kernel runs in interpret mode, as in test_flowfield.py.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)
import jax.numpy as jnp

from permafrost_engine_tpu.core.config import COST_IMPASSABLE, FIELD_RES
from permafrost_engine_tpu.nav import portals as jpt
from permafrost_engine_tpu.ops import flowfield as jff
from permafrost_engine_tpu.ops.flowfield_pallas import integrate_pallas
from permafrost_engine_tpu.ops.islands import label_islands as jlabel
from permafrost_engine_tpu_torch.nav import portals as tpt
from permafrost_engine_tpu_torch.ops import flowfield as tff
from permafrost_engine_tpu_torch.ops import flowfield_cuda
from permafrost_engine_tpu_torch.ops.islands import label_islands as tlabel


def _chunks(seed, k=5, wall_frac=0.3):
    """Random-cost chunks with walls, a serpentine chunk (the 256-sweep
    cap binds there), point seeds and a full-edge portal seed."""
    rng = np.random.default_rng(seed)
    cost = rng.integers(1, 6, (k, FIELD_RES, FIELD_RES)).astype(np.uint8)
    cost[rng.random(cost.shape) < wall_frac] = COST_IMPASSABLE
    cost[0] = 1
    for i, r in enumerate(range(4, FIELD_RES, 4)):
        cost[0, r, :] = COST_IMPASSABLE
        cost[0, r, (FIELD_RES - 1) if i % 2 == 0 else 0] = 1
    seeds = np.zeros(cost.shape, bool)
    seeds[:, 1, 2] = True
    seeds[1, FIELD_RES - 1, :] = True
    svals = (rng.random(cost.shape) * 40).astype(np.float32)
    return cost, seeds, svals


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("with_seed_cost", [False, True])
def test_integrate_matches_xla_and_pallas(seed, with_seed_cost):
    """rtol 1e-6 / atol 1e-5, the bound test_flowfield.py puts on Pallas
    vs XLA; on this CPU the fields come out bit-equal."""
    cost, seeds, svals = _chunks(seed)
    sv = svals if with_seed_cost else None
    want = np.asarray(jff.integrate(jnp.asarray(cost), jnp.asarray(seeds),
                                    None if sv is None else jnp.asarray(sv)))
    pal = np.asarray(integrate_pallas(
        jnp.asarray(cost), jnp.asarray(seeds),
        None if sv is None else jnp.asarray(sv), interpret=True))
    got = flowfield_cuda.integrate(
        torch.from_numpy(cost), torch.from_numpy(seeds),
        None if sv is None else torch.from_numpy(sv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got, pal, rtol=1e-6, atol=1e-5)
    # the serpentine chunk really needs the whole sweep budget
    assert np.isfinite(got[0][got[0] < 1e30]).all()
    assert got[0][cost[0] != COST_IMPASSABLE].max() > 4 * FIELD_RES


@pytest.mark.parametrize("seed", [0, 1])
def test_flow_dirs_exact(seed):
    cost, seeds, _ = _chunks(seed)
    integ = np.array(jff.integrate(jnp.asarray(cost), jnp.asarray(seeds)))
    want = np.asarray(jff.flow_dirs(jnp.asarray(integ), jnp.asarray(cost)))
    got = tff.flow_dirs(torch.from_numpy(integ), torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(got, want)


def test_dir_table_exact():
    np.testing.assert_array_equal(tff.DIR_UNIT_TABLE.numpy(),
                                  np.asarray(jff.DIR_UNIT_TABLE))
    codes = np.arange(9, dtype=np.uint8).reshape(3, 3)
    np.testing.assert_array_equal(
        tff.dir_code_to_vec(torch.from_numpy(codes)).numpy(),
        np.asarray(jff.dir_code_to_vec(jnp.asarray(codes))))


@pytest.mark.parametrize("seed", [0, 3])
def test_los_field_exact(seed):
    rng = np.random.default_rng(seed)
    passable = rng.random((3, 96, 128)) > 0.03
    gr = np.array([0, 40, 95])
    gc = np.array([127, 64, 3])
    want = np.asarray(jff.los_field(jnp.asarray(passable), jnp.asarray(gr),
                                    jnp.asarray(gc)))
    got = tff.los_field(torch.from_numpy(passable), torch.from_numpy(gr),
                        torch.from_numpy(gc)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.sum() > 1500
    single = tff.los_field(torch.from_numpy(passable[1]), 40, 64).numpy()
    np.testing.assert_array_equal(single, want[1])


def _same_partition(a, b):
    """Equal labellings up to renaming ids (-1 = impassable stays -1)."""
    np.testing.assert_array_equal(a < 0, b < 0)
    pairs = np.unique(np.stack([a.ravel(), b.ravel()], 1), axis=0)
    assert len(np.unique(pairs[:, 0])) == len(pairs)
    assert len(np.unique(pairs[:, 1])) == len(pairs)


@pytest.mark.parametrize("seed", [0, 1])
def test_label_islands_partition(seed):
    cost, _, _ = _chunks(seed, k=3, wall_frac=0.45)
    want = np.asarray(jlabel(jnp.asarray(cost)))
    got = tlabel(torch.from_numpy(cost)).numpy()
    _same_partition(got, want)
    assert len(np.unique(want)) > 10


def test_portal_graph_matches():
    """Whole-map portal graph: the same portals and links; link costs
    come from the integration, so they are equal too."""
    rng = np.random.default_rng(5)
    cost = np.ones((2 * FIELD_RES, 3 * FIELD_RES), np.uint8)
    cost[rng.random(cost.shape) < 0.2] = COST_IMPASSABLE
    cost[FIELD_RES - 1:FIELD_RES + 1, 10:] = COST_IMPASSABLE
    want = jpt.build_portal_graph(cost, 2, 3)
    got = tpt.build_portal_graph(cost, 2, 3, device="cpu")
    assert [(p.chunk, p.side, p.lo, p.hi, p.paired) for p in got.portals] == \
        [(p.chunk, p.side, p.lo, p.hi, p.paired) for p in want.portals]
    assert got.adj == want.adj
    a = jpt.astar_portals(want, {0: 0.0}, {len(want.portals) - 1: 0.0},
                          (100.0, 150.0))
    b = tpt.astar_portals(got, {0: 0.0}, {len(got.portals) - 1: 0.0},
                          (100.0, 150.0))
    assert a == b and a is not None


def test_integrate_rejects_other_devices():
    """The wrapper runs the plain version only for CPU tensors; any other
    device launches the kernel or raises."""
    cost = torch.ones((1, FIELD_RES, FIELD_RES), dtype=torch.uint8,
                      device="meta")
    seeds = torch.zeros((1, FIELD_RES, FIELD_RES), dtype=torch.bool,
                        device="meta")
    with pytest.raises(RuntimeError):
        flowfield_cuda.integrate(cost, seeds)


def test_local_islands_and_seed_point():
    """Blocker-aware local islands (partition-equal) and the single-tile
    seed mask."""
    cost, _, _ = _chunks(2, k=3, wall_frac=0.3)
    rng = np.random.default_rng(9)
    blockers = (rng.random(cost.shape) < 0.1).astype(np.int32) * 2
    from permafrost_engine_tpu.ops.islands import label_local_islands as jlocal
    from permafrost_engine_tpu_torch.ops.islands import label_local_islands
    want = np.asarray(jlocal(jnp.asarray(cost), jnp.asarray(blockers)))
    got = label_local_islands(torch.from_numpy(cost),
                              torch.from_numpy(blockers)).numpy()
    _same_partition(got, want)
    assert (got[blockers > 0] == -1).all()
    np.testing.assert_array_equal(
        tff.seed_from_point(FIELD_RES, 48, 5, 40, "cpu").numpy(),
        np.asarray(jff.seed_from_point(FIELD_RES, 48, 5, 40)))
