"""PyTorch port vs the JAX package: ``grid.knn_query``,
``boids.cohesion_force``, ``preferred_velocity``'s arena-gather and
per-pair cohesion fallbacks, and ``session.dataclass_dict``.

``knn_query`` must equal JAX's bit for bit on all four outputs, the invalid
slots included: JAX's ``approx_max_k`` is an exact top-k off the TPU whose
ties go to the lower candidate column, and the port sorts stably. The
forces are held to ``tests/test_torch_movement.py``'s 1e-5 for boids
forces (XLA contracts multiply-adds into FMAs; the port rounds each
operation).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core import session as jsession
from permafrost_engine_tpu.core.config import (
    SPATIAL_CELL_SIZE,
    EngineConfig,
)
from permafrost_engine_tpu.ops import boids as jboids
from permafrost_engine_tpu.ops import grid as jgrid
from permafrost_engine_tpu_torch.core import session as tsession
from permafrost_engine_tpu_torch.core.config import EngineConfig as TorchConfig
from permafrost_engine_tpu_torch.ops import boids as tboids
from permafrost_engine_tpu_torch.ops import grid as tgrid

FORCE_ATOL = 1e-5   # tests/test_torch_movement.py's boids-force tolerance


def make_world(rng, n=200, world=160.0, n_dead=20):
    """tests/test_grid.py's world: uniform positions, `n_dead` dead."""
    pos = rng.random((n, 2)).astype(np.float32) * world
    alive = np.ones(n, bool)
    alive[rng.choice(n, n_dead, replace=False)] = False
    cells = int(np.ceil(world / SPATIAL_CELL_SIZE))
    return pos, alive, cells


def port_knn(pos, alive, cells, cap, query_pos, slots, k, window=5):
    g = tgrid.build_grid(torch.from_numpy(pos), torch.from_numpy(alive),
                         cells_r=cells, cells_c=cells, cap=cap)
    out = tgrid.knn_query(g, torch.from_numpy(pos),
                          torch.from_numpy(query_pos),
                          torch.from_numpy(slots), k=k, window=window)
    return [t.numpy() for t in out]


def jax_knn(pos, alive, cells, cap, query_pos, slots, k, window=5):
    g = jgrid.build_grid(jnp.asarray(pos), jnp.asarray(alive),
                         cells_r=cells, cells_c=cells, cap=cap)
    out = jgrid.knn_query(g, jnp.asarray(pos), jnp.asarray(query_pos),
                          jnp.asarray(slots), k=k, window=window)
    return [np.array(a) for a in out]


def test_knn_matches_bruteforce():
    """tests/test_grid.py::test_knn_matches_bruteforce on the port."""
    rng = np.random.default_rng(1)
    pos, alive, cells = make_world(rng, n=300)
    k, window = 8, 5
    slots = np.arange(pos.shape[0], dtype=np.int32)
    idx, dist, valid, _npos = port_knn(pos, alive, cells, 64, pos, slots,
                                       k, window)
    # window=5 over 16u cells guarantees everything within 2 cells = 32u
    guaranteed = 2 * SPATIAL_CELL_SIZE
    for q in range(0, 300, 17):
        if not alive[q]:
            continue
        d = np.linalg.norm(pos - pos[q], axis=1)
        d[~alive] = np.inf
        d[q] = np.inf
        want = np.sort(d[d < guaranteed])[:k]
        got = dist[q][valid[q]]
        got_within = got[got < guaranteed]
        np.testing.assert_allclose(np.sort(got_within), want, rtol=1e-5)
        for j, v in zip(idx[q], valid[q]):
            if v:
                assert j != q and alive[j]


def test_knn_dead_entities_never_returned():
    """tests/test_grid.py::test_knn_dead_entities_never_returned on the port."""
    rng = np.random.default_rng(2)
    pos, alive, cells = make_world(rng, n=100, n_dead=50)
    idx, _dist, valid, _npos = port_knn(
        pos, alive, cells, 32, pos, np.arange(100, dtype=np.int32), 8)
    assert all(alive[j] for j in idx[valid])


def _lattice():
    """A 20x20 lattice 4u apart: every query has rings of equal distances."""
    xs, zs = np.meshgrid(np.arange(20), np.arange(20))
    pos = (np.stack([xs.ravel(), zs.ravel()], 1) * 4.0 + 2.0).astype(np.float32)
    return pos, np.ones(len(pos), bool), 5


KNN_CASES = {
    "k8_window5_n300": dict(n=300, k=8, window=5, cap=64),
    "k32_window3": dict(n=300, k=32, window=3, cap=64),
    "lattice_ties": dict(lattice=True, k=8, window=5, cap=32),
    "point_queries": dict(n=300, k=8, window=5, cap=64, point=True),
    "half_dead": dict(n=300, k=8, window=5, cap=64, n_dead=150),
}


@pytest.mark.parametrize("case", list(KNN_CASES))
def test_knn_bit_equal_to_jax(case):
    c = KNN_CASES[case]
    rng = np.random.default_rng(7)
    if c.get("lattice"):
        pos, alive, cells = _lattice()
    else:
        pos, alive, cells = make_world(rng, n=c["n"],
                                       n_dead=c.get("n_dead", 20))
    n = len(pos)
    if c.get("point"):
        query_pos = (rng.random((n, 2)) * 160.0).astype(np.float32)
        slots = np.full(n, -1, np.int32)
    else:
        query_pos, slots = pos, np.arange(n, dtype=np.int32)
    args = (pos, alive, cells, c["cap"], query_pos, slots, c["k"], c["window"])
    want, got = jax_knn(*args), port_knn(*args)
    for name, w, g in zip(("idx", "dist", "valid", "neigh_pos"), want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
        if w.dtype == np.float32:   # bit patterns too (inf, -0.0)
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=name)
    assert got[2].any()
    if c["k"] == 32 or "n_dead" in c:   # rows with invalid slots
        assert (~got[2]).any()
    if c.get("lattice"):   # ties: equal distances within the k returned
        d = got[1][got[2][:, 1]]
        assert (d[:, 0] == d[:, 1]).any()


def _neighbour_scene(n=512, k=32, seed=3):
    """Flocks of units in a 160u square with their knn window (from the
    JAX side; the port's is bit-equal), 10% dead, some velocities."""
    rng = np.random.default_rng(seed)
    pos, alive, cells = make_world(rng, n=n, n_dead=n // 10)
    slots = np.arange(n, dtype=np.int32)
    idx, _d, valid, npos = jax_knn(pos, alive, cells, 64, pos, slots, k)
    vel = ((rng.random((n, 2)) - 0.5) * 2.0).astype(np.float32)
    flock = rng.integers(-1, 6, n).astype(np.int32)
    return dict(pos=pos, vel=vel, flock=flock, idx=idx, valid=valid,
                npos=npos, rng=rng)


def test_cohesion_force_matches_jax():
    s = _neighbour_scene()
    nflock = np.where(s["valid"], s["flock"][np.clip(s["idx"], 0, None)], -1)
    args = (s["pos"], s["flock"], s["idx"], s["valid"], s["npos"],
            nflock.astype(np.int32))
    want = np.asarray(jboids.cohesion_force(*[jnp.asarray(a) for a in args]))
    got = tboids.cohesion_force(*[torch.from_numpy(a) for a in args]).numpy()
    np.testing.assert_allclose(got, want, atol=FORCE_ATOL)
    assert (np.abs(want).sum(1) > 0).mean() > 0.3


def test_gather_clamps_invalid_to_row_zero():
    x = torch.arange(10, dtype=torch.float32)[:, None].expand(10, 2)
    idx = torch.tensor([[-1, 3], [9, -1]])
    got = tboids._gather(x, idx)
    want = np.asarray(jboids._gather(jnp.asarray(x.numpy()),
                                     jnp.asarray(idx.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0, 0] == 0.0   # not the last row, as -1 would index


@pytest.mark.parametrize("formation", [False, True],
                         ids=["no_formation", "formation"])
def test_preferred_velocity_fallbacks_match_jax(formation):
    """``neigh_pos``/``neigh_vel``/``neigh_flock`` gathered from the arena
    and cohesion per pair (no centroid), against JAX's; with formations,
    JAX's formation arguments against the port's
    ``keep=formation_keep_force(...)``."""
    s = _neighbour_scene()
    rng, n = s["rng"], len(s["pos"])
    dest = (rng.random((n, 2)) * 160.0).astype(np.float32)
    flow = rng.normal(size=(n, 2)).astype(np.float32)
    flow /= np.linalg.norm(flow, axis=1, keepdims=True)
    use_arrive = rng.random(n) < 0.3
    mst = (0.5 + rng.random(n)).astype(np.float32)
    moving = rng.random(n) < 0.8
    args = (s["pos"], s["vel"], s["flock"], dest, flow, use_arrive, mst,
            s["idx"], s["valid"], moving)
    jkw, tkw = {}, {}
    if formation:
        mf = 8
        cell = (s["pos"] + 6.0 * (rng.random((n, 2)) - 0.5)).astype(np.float32)
        has_cell = rng.random(n) < 0.9
        ftype = np.zeros(mf, np.int32)
        ftype[:3] = 1
        jkw = dict(formation_cell=jnp.asarray(cell),
                   has_cell=jnp.asarray(has_cell),
                   flock_formation=jnp.asarray(ftype), max_flocks=mf)
        tkw = dict(keep=tboids.formation_keep_force(
            *[torch.from_numpy(a) for a in (s["pos"], s["vel"], s["flock"],
                                            cell, has_cell, ftype)], mf))
    want = np.asarray(jboids.preferred_velocity(
        *[jnp.asarray(a) for a in args], **jkw))
    got = tboids.preferred_velocity(*[torch.from_numpy(a) for a in args],
                                    **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=FORCE_ATOL)
    assert np.abs(want).sum() > 1.0


def test_dataclass_dict_matches_jax():
    cfg = EngineConfig(max_ents=300, chunks_r=2, chunks_c=3, num_layers=2)
    want = jsession.dataclass_dict(cfg)
    got = tsession.dataclass_dict(TorchConfig(**dataclasses.asdict(cfg)))
    assert got == want
