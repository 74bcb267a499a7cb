"""PyTorch port vs the JAX package: the auction assignment.

``auction_assign`` of both packages runs on the same numpy cost matrices,
``tests/test_assignment.py``'s scenes (square, rectangular, masked,
medium, formation costs) plus ties and round caps, on the CPU. The
assignments must be equal, element for element (tolerance: none; the port
rounds every bid as XLA on the CPU does, the division by 2 n^2 included).
``assign_cells`` (the cost build, the auction and the greedy fill) must
give equal cell indices.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.game.formation import assign_cells as jax_assign_cells
from permafrost_engine_tpu.ops.assignment import auction_assign as jax_auction
from permafrost_engine_tpu_torch.game.formation import assign_cells
from permafrost_engine_tpu_torch.ops import assignment
from permafrost_engine_tpu_torch.ops.assignment import auction_assign


def _formation_cost():
    rng = np.random.default_rng(6)
    units = rng.random((32, 2)).astype(np.float32) * 100
    cells = np.stack(np.meshgrid(np.arange(8), np.arange(4)), -1).reshape(-1, 2)
    cells = (cells * 5 + 50).astype(np.float32)
    return (np.linalg.norm(units[:, None] - cells[None, :], axis=-1) ** 2
            ).astype(np.float32)


def _scene(name):
    """(cost, bidder mask or None, object mask or None, keywords)."""
    if name.startswith("square"):
        rng = np.random.default_rng(int(name[-1]))
        return rng.random((6, 6)).astype(np.float32) * 100, None, None, {}
    if name == "rect":
        rng = np.random.default_rng(3)
        return rng.random((5, 9)).astype(np.float32) * 10, None, None, {}
    if name == "masked":
        rng = np.random.default_rng(4)
        bm = np.array([True, True, False, True, False, True, True, False])
        om = np.array([True] * 6 + [False, False])
        return rng.random((8, 8)).astype(np.float32), bm, om, {}
    if name == "medium":
        rng = np.random.default_rng(5)
        return (rng.random((64, 64)) * 1000).astype(np.float32), None, None, {}
    if name == "formation":
        return _formation_cost(), None, None, {}
    if name == "ties_all_equal":
        return np.zeros((8, 8), np.float32), None, None, {}
    if name == "ties_integer":
        # few distinct values: equal best values across objects in most rows
        rng = np.random.default_rng(7)
        return np.round(rng.random((16, 20)) * 3).astype(np.float32), None, None, {}
    if name == "cap_7":
        rng = np.random.default_rng(5)
        return ((rng.random((64, 64)) * 1000).astype(np.float32), None, None,
                dict(max_rounds=7))
    if name == "cap_20":
        rng = np.random.default_rng(8)
        return ((rng.random((48, 48)) * 1000).astype(np.float32), None, None,
                dict(max_rounds=20))
    if name == "fixed_eps":
        rng = np.random.default_rng(9)
        return ((rng.random((24, 30)) * 50).astype(np.float32), None, None,
                dict(eps=0.25))
    raise KeyError(name)


SCENES = ["square_0", "square_1", "square_2", "rect", "masked", "medium",
          "formation", "ties_all_equal", "ties_integer", "cap_7", "cap_20",
          "fixed_eps"]


@pytest.mark.parametrize("name", SCENES)
def test_auction_equal(name):
    cost, bm, om, kw = _scene(name)
    n, m = cost.shape
    bm = np.ones(n, bool) if bm is None else bm
    om = np.ones(m, bool) if om is None else om
    want = np.asarray(jax_auction(jnp.asarray(cost), jnp.asarray(bm),
                                  jnp.asarray(om), **kw))
    stats = {}
    got = auction_assign(torch.from_numpy(cost), torch.from_numpy(bm),
                         torch.from_numpy(om), stats=stats, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < stats["rounds"] <= kw.get("max_rounds", 10000)
    if name.startswith("cap"):
        assert (want < 0).any(), "the cap should leave bidders unassigned"
        assert stats["rounds"] == kw["max_rounds"]
    else:
        assert (want[bm] >= 0).all()


def test_auction_block_size_does_not_change_result(monkeypatch):
    """Rounds in blocks of 1, 5 or 64 give the same assignment and the same
    round count (a round after convergence is a no-op)."""
    cost = _scene("medium")[0]
    ones_n = torch.ones(64, dtype=torch.bool)
    outs, rounds = [], []
    for block in (1, 5, 64):
        monkeypatch.setattr(assignment, "ROUNDS_PER_SYNC", block)
        st = {}
        outs.append(auction_assign(torch.from_numpy(cost), ones_n, ones_n,
                                   stats=st).numpy())
        rounds.append(st["rounds"])
    assert all(np.array_equal(outs[0], o) for o in outs[1:])
    assert len(set(rounds)) == 1


@pytest.mark.parametrize("seed,n,m", [(0, 12, 15), (1, 40, 44), (2, 9, 9)])
def test_assign_cells_equal(seed, n, m):
    rng = np.random.default_rng(seed)
    units = rng.random((n, 2)).astype(np.float32) * 50
    cells = rng.random((m, 2)).astype(np.float32) * 50
    want = jax_assign_cells(units, cells)
    stats = {}
    got = assign_cells(units, cells, device="cpu", stats=stats)
    np.testing.assert_array_equal(got, want)
    assert got.flags.writeable
    assert stats["greedy"] == 0 and len(set(got.tolist())) == n
