"""Obstacle-battle phase probe: where do march and contact frames go?

Builds the bench's obstacle battle, measures the march and contact phases
as the bench does (the median fps of three 120-frame ``step`` windows) and
prints the engine's host counters per phase (``eng.perf.counters``:
blocker snapshot, update, route and replan, seek and chase refresh, field
batch, delta drains): the attribution the bench's fps lack.

Port of ``tools/probe_obstacle.py``: ``bench.build_battle(terrain=True)``,
``step(60)``, the march phase, the fast-forward to the first death,
``step_scan(300)``, the six mid-fight buildings, then two contact phases.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_obstacle [--cpu]
[--n-per-side 5000] [--frames 120] [--windows 3] [--warmup 60]
[--ff-chunk 300] [--ff-max-frames 6000] [--thicken 300] [--out PATH]``
"""

from __future__ import annotations

import time

import numpy as np

from permafrost_engine_tpu_torch import bench
from permafrost_engine_tpu_torch.tools import _probe_util as U


def phase(eng, name: str, frames: int = 120, windows: int = 3) -> dict:
    """`windows` timed ``step(frames)`` windows: their fps and the host
    counters' growth over them."""
    before = dict(eng.perf.counters)
    vals = []
    for _ in range(windows):
        t0 = time.perf_counter()
        eng.step(frames)
        U.sync(eng.device)
        vals.append(frames / (time.perf_counter() - t0))
    wall_ms = windows * frames / np.median(vals) * 1e3
    return {"phase": name, "fps_median": round(float(np.median(vals)), 2),
            "fps_all": [round(v, 1) for v in vals],
            "window_wall_ms": round(wall_ms, 0),
            "host_counters_ms": U.delta(dict(eng.perf.counters), before)}


def obstacle(eng, frames: int = 120, windows: int = 3,
             warmup: int = bench.WARMUP_FRAMES,
             contact: tuple = (bench.FF_CHUNK, bench.FF_MAX_FRAMES,
                               bench.THICKEN_FRAMES)) -> dict:
    """The probe on a freshly built battle `eng`: `warmup` frames, the
    march, the way to contact (``to_contact``'s chunk, cap and thickening
    frames, `contact`), the buildings, two contact phases."""
    n0 = bench.alive_count(eng)
    eng.step(warmup)
    out = {"phases": [phase(eng, "march", frames, windows)]}
    U.to_contact(eng, n0, *contact)
    bench.place_midfight_structures(eng)
    out["phases"].append(phase(eng, "contact", frames, windows))
    out["phases"].append(phase(eng, "contact2", frames, windows))
    return out


def main(argv=None) -> dict:
    ap = U.parser("probe_obstacle", __doc__)
    ap.add_argument("--n-per-side", type=int, default=5000)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--windows", type=int, default=3)
    U.contact_flags(ap)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_obstacle")
    eng = bench.build_battle(args.n_per_side, terrain=True, device=device)
    out = obstacle(eng, args.frames, args.windows, args.warmup,
                   (args.ff_chunk, args.ff_max_frames, args.thicken))
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
