"""Perf probe: the one-time stall after a mid-fight structure drop, split.

Reproduces the bench's mid-fight drop of six buildings and prints, for one
120-frame ``step`` window before it and three after it, the host counters
(occupancy fetch, extend plan, field batch, blocker update and replan) and
the nav service's statistics (``chunks_rebuilt``, ``invalidations``,
field hits and misses, chunks built): the split of the structure-commit
frame that ``probe_obstacle`` lacks. The K2 chunk and whole-map launches
of each window ride along (``ops/flowfield_cuda``; 0 on the CPU, where no
kernel launches), the segment graphs it captured (their count and ms: a
window that meets new segment keys pays their captures), and the split of
each structure commit, synchronized: the effective-cost recompute, the
incremental portal relink, the field invalidation, the replans and,
inside them, the islands relabelled (``commit_split``; a commit drops the
islands of the ground and water layers, and the replans' first path
request on a layer labels it anew).

Port of ``tools/probe_extend.py``: ``bench.build_battle(terrain=True)``,
``step(60)``, the fast-forward to the first death, ``step_scan(300)``,
then the windows around ``bench.place_midfight_structures``.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_extend [--cpu]
[--n-per-side 5000] [--frames 120] [--warmup 60] [--ff-chunk 300]
[--ff-max-frames 6000] [--thicken 300] [--out PATH]``
"""

from __future__ import annotations

import contextlib
import time

from permafrost_engine_tpu_torch import bench
from permafrost_engine_tpu_torch.nav import portals as pt
from permafrost_engine_tpu_torch.tools import _probe_util as U

POST_WINDOWS = 3


def _launches() -> dict:
    from permafrost_engine_tpu_torch.ops import flowfield_cuda

    return {"k2_chunk": flowfield_cuda.launches_chunk,
            "k2_map": flowfield_cuda.launches_map}


@contextlib.contextmanager
def commit_split(eng, ms: dict):
    """Time, synchronized, each structure commit (``Engine._commit_nav``
    with stamps pending) and its parts: the effective-cost recompute, the
    incremental portal relink (``portals.update_portal_graph``), the
    invalidation of the dirty chunks' fields, the flocks' replans and the
    islands labelled inside the commit (``NavService.islands`` of a layer
    not cached; part of the replans), adding ms to `ms` and the number of
    labellings to ``ms["islands_n"]``. A commit with nothing pending runs
    untimed (no synchronize), so the window's other frames are not
    slowed."""
    nav = eng.nav
    parts = ((nav, "_recompute_effective", "recompute"),
             (pt, "update_portal_graph", "portal_relink"),
             (nav, "_invalidate_chunk_fields", "invalidate"),
             (eng, "_replan_flocks", "replan"))
    in_commit = [False]

    def timed(key, fn):
        def run(*args, **kw):
            U.sync(eng.device)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                U.sync(eng.device)
                ms[key] = ms.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return run

    def in_a_commit():
        in_commit[0] = True
        try:
            return timed_commit()
        finally:
            in_commit[0] = False

    def islands(layer):
        if not in_commit[0] or layer in nav._islands:
            return labels(layer)
        ms["islands_n"] = ms.get("islands_n", 0) + 1
        return timed_labels(layer)

    commit = eng._commit_nav
    timed_commit = timed("commit", commit)
    labels = nav.islands
    timed_labels = timed("islands", labels)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in parts]
    eng._commit_nav = lambda: (in_a_commit() if nav._pending_dirty
                               else commit())
    nav.islands = islands
    for obj, attr, key in parts:
        setattr(obj, attr, timed(key, getattr(obj, attr)))
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            if obj is pt:
                setattr(obj, attr, fn)
            else:                    # drop the instance attribute
                delattr(obj, attr)
        del eng._commit_nav
        del nav.islands


def window(eng, frames: int = 120) -> dict:
    """One timed ``step(frames)``: its fps and wall, the growth of the host
    counters, the nav statistics, the K2 launches and the segment graphs
    captured (first uses, on the card) over it, and the structure commits'
    split (``commit_split``; empty when none ran)."""
    c0, s0, k0 = dict(eng.perf.counters), dict(eng.nav.stats), _launches()
    g0 = dict(eng._scan_fn.stats)
    commit_ms: dict = {}
    t0 = time.perf_counter()
    with commit_split(eng, commit_ms):
        eng.step(frames)
        U.sync(eng.device)
    wall = (time.perf_counter() - t0) * 1e3
    return {"fps": round(frames / wall * 1e3, 1), "wall_ms": round(wall, 0),
            "counters": U.delta(dict(eng.perf.counters), c0),
            "nav_stats": U.delta(dict(eng.nav.stats), s0),
            "launches": {k: v - k0[k] for k, v in _launches().items()},
            "graphs": U.delta(dict(eng._scan_fn.stats), g0),
            "commit_ms": {k: round(v, 2) for k, v in commit_ms.items()}}


def extend(eng, frames: int = 120) -> dict:
    """The windows around the drop, on `eng` at contact."""
    out = {"pre_drop": window(eng, frames)}
    t0 = time.perf_counter()
    bench.place_midfight_structures(eng)
    out["drop_ms"] = round((time.perf_counter() - t0) * 1e3, 0)
    for i in range(POST_WINDOWS):
        out[f"post_drop_{i}"] = window(eng, frames)
    return out


def main(argv=None) -> dict:
    ap = U.parser("probe_extend", __doc__)
    ap.add_argument("--n-per-side", type=int, default=5000)
    ap.add_argument("--frames", type=int, default=120)
    U.contact_flags(ap)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_extend")
    eng = U.battle_to_contact(args, device, terrain=True)
    out = extend(eng, args.frames)
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
