"""Perf probe: the movement substep's cohesion stage in its two forms.

``ops/boids.flock_cohesion_centroids`` box-filters per-(flock, cell) sums
either through the dense i32[max_flocks, cells, 5] table
(``_cohesion_rows_dense``) or by sorting the units' (flock, cell) keys
(``_cohesion_rows_sorted``). This times both, each captured once in a CUDA
graph and replayed (the tick's own form on the card), at two shapes: the
10k-unit battles' (10,256 rows, 64 flocks, about 30 of them in use) and
the 4v4 economy match's (2,048 rows of which 1,400 live, 1,024 flocks,
350 in use), on the 64x64-cell grid of the 1024-unit map. Positions are
clustered around a few centres, as armies and bases are. It prints one
JSON line: per shape, each form's milliseconds a call (the median of
`--reps` replays timed by CUDA events; the wall clock on the CPU), which
form ``flock_cohesion_centroids`` picks there, and whether the two forms'
outputs are equal bit for bit.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_cohesion [--cpu]
[--reps 200] [--out PATH]``
"""

from __future__ import annotations

import time

import numpy as np
import torch

from permafrost_engine_tpu_torch.ops import boids
from permafrost_engine_tpu_torch.tools import _probe_util as U

# (name, rows, live rows, max_flocks, flocks in use, clusters)
SHAPES = (("battle", 10256, 10256, 64, 30, 6),
          ("match", 2048, 1400, 1024, 350, 24))
GRID = dict(cells_r=64, cells_c=64, cell_size=16.0)


def scene(rows, live, flocks, used, clusters, device, seed=0):
    """Positions in `clusters` clumps of the 1024-unit map, `live` rows
    alive, each in one of `used` flocks of a `flocks`-row table (one in
    ten of them in none)."""
    rng = np.random.default_rng(seed)
    centres = rng.random((clusters, 2)) * 900.0 + 62.0
    pos = centres[rng.integers(0, clusters, rows)] \
        + rng.normal(0.0, 25.0, (rows, 2))
    pos = np.clip(pos, 0.0, 1023.0).astype(np.float32)
    ids = rng.choice(flocks, used, replace=False)
    flock = ids[rng.integers(0, used, rows)].astype(np.int32)
    flock[rng.random(rows) < 0.1] = -1
    mask = np.arange(rows) < live
    return [torch.from_numpy(a).to(device) for a in (pos, flock, mask)]


def form(rows_fn, pos, flock, mask, flocks):
    """The cohesion stage with its rows taken by `rows_fn`."""
    return boids._cohesion_centroids(pos, flock, mask, rows_fn,
                                     max_flocks=flocks, box=7, **GRID)


def time_ms(fn, device, reps: int) -> float:
    """The median ms of one call of `fn`: replays of its CUDA graph timed
    by events on the card, wall-clock calls on the CPU."""
    times = []
    if torch.device(device).type != "cuda":
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for _ in range(5):
        graph.replay()
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def main(argv=None) -> int:
    ap = U.parser("probe_cohesion", __doc__)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_cohesion")
    out = {}
    for name, rows, live, flocks, used, clusters in SHAPES:
        pos, flock, mask = scene(rows, live, flocks, used, clusters, device)
        res = {}
        got = []
        for label, fn in (("dense", boids._cohesion_rows_dense),
                          ("sorted", boids._cohesion_rows_sorted)):
            got.append(form(fn, pos, flock, mask, flocks))
            res[f"{label}_ms"] = time_ms(
                lambda fn=fn: form(fn, pos, flock, mask, flocks), device,
                args.reps)
        res["equal"] = all(torch.equal(a, b) for a, b in zip(*got))
        picked = boids._cohesion_rows_for(
            flocks, GRID["cells_r"] * GRID["cells_c"], rows)
        res["picked"] = ("dense" if picked is boids._cohesion_rows_dense
                         else "sorted")
        out[name] = res
        print(f"{name}: {res}", flush=True)
    U.emit(out, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
