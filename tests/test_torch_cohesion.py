"""The movement substep's cohesion stage (``ops/boids.
flock_cohesion_centroids``) against the JAX package's dense table, bit for
bit, in both of the port's forms: the dense (flock, cell) table and the
sort of the units' keys, which the stage takes once the table has more
than ``_DENSE_ROWS_PER_UNIT`` rows a unit. Seeded random flocks and
positions on the 64x64-cell grid of the 1024-unit map, a clump of one
flock's units and the map's corners among them, at 64 and 1,024 flocks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from permafrost_engine_tpu.ops import boids as jboids
from permafrost_engine_tpu_torch.ops import boids as tboids

GRID = dict(cells_r=64, cells_c=64, cell_size=16.0)


def _scene(rows: int, flocks: int, seed: int):
    rng = np.random.default_rng(seed)
    pos = (rng.random((rows, 2)) * 1024.0).astype(np.float32)
    pos[:200] = pos[:200] * 0.05 + 500.0        # one clump of three flocks
    pos[200:205] = 0.0
    pos[205:210] = 1023.9
    flock = rng.integers(-1, flocks, rows).astype(np.int32)
    flock[:200] = rng.integers(0, 3, 200)
    flock[200:210] = flocks - 1
    mask = rng.random(rows) < 0.9
    return pos, flock, mask


@pytest.mark.parametrize("form", ["picked", "dense", "sorted"])
@pytest.mark.parametrize("flocks,rows", [(64, 3000), (1024, 1400)])
def test_cohesion_equals_jax_dense(flocks, rows, form):
    pos, flock, mask = _scene(rows, flocks, seed=flocks + rows)
    want = jboids.flock_cohesion_centroids(
        jnp.asarray(pos), jnp.asarray(flock), jnp.asarray(mask),
        max_flocks=flocks, **GRID)
    args = (torch.from_numpy(pos), torch.from_numpy(flock),
            torch.from_numpy(mask))
    if form == "picked":
        got = tboids.flock_cohesion_centroids(*args, max_flocks=flocks,
                                              **GRID)
    else:
        rows_fn = (tboids._cohesion_rows_dense if form == "dense"
                   else tboids._cohesion_rows_sorted)
        got = tboids._cohesion_centroids(*args, rows_fn, max_flocks=flocks,
                                         box=7, **GRID)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[1].max()) >= 50          # the clump's mates count


def test_the_stage_picks_by_the_table_size():
    """The battles' shape (10,256 rows, 64 flocks) takes the dense table;
    the economy match's (2,048 rows, 1,024 flocks) the sorted keys."""
    cells = GRID["cells_r"] * GRID["cells_c"]
    assert tboids._cohesion_rows_for(64, cells, 10256) \
        is tboids._cohesion_rows_dense
    assert tboids._cohesion_rows_for(1024, cells, 2048) \
        is tboids._cohesion_rows_sorted


def test_probe_cohesion_on_the_cpu(capsys):
    """``tools/probe_cohesion`` times both forms at both shapes and finds
    them equal; its last line is one JSON object."""
    import json

    from permafrost_engine_tpu_torch.tools import probe_cohesion

    assert probe_cohesion.main(["--cpu", "--reps", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"battle", "match"}
    assert out["battle"]["picked"] == "dense"
    assert out["match"]["picked"] == "sorted"
    assert all(v["equal"] and v["dense_ms"] > 0 and v["sorted_ms"] > 0
               for v in out.values())
