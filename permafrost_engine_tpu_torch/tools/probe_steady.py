"""Perf probe: the steady-state interactive ``step`` decomposed, on the
obstacle battle's march (past the first-use graph captures).

Sums the engine's ``Perf`` scopes ``device_tick``, ``drain_deltas`` and
``host_systems`` over 120 frames of ``step`` and reports the wall time
they leave unattributed, then compares micro-batched, per-frame and scan
driving and the per-cadence-class eager tick (``profile_tick``).

On the card a micro-batched ``device_tick`` scope times the host's part of
a segment, the CUDA graph replay's enqueue, not the device's work. The
device's work shows where the host next waits for it: in ``drain_deltas``,
whose window copy at each drain boundary waits for the replays before it,
and in ``host_systems`` where the nav cadence reads device values. So
``unattributed_ms`` (the wall minus the three scopes, as in the JAX probe)
stays near 0 there, and ``drain_deltas`` is mostly the device wait.

Port of ``tools/probe_steady.py``: ``bench.build_battle(terrain=True)``,
``step(60)``, then the measurements.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_steady [--cpu]
[--n-per-side 5000] [--frames 120] [--windows 3] [--profile-frames 60]
[--warmup 60] [--out PATH]``
"""

from __future__ import annotations

import time
from collections import defaultdict

from permafrost_engine_tpu_torch import bench
from permafrost_engine_tpu_torch.tools import _probe_util as U

SCOPES = ("device_tick", "drain_deltas", "host_systems")


def scope_totals(eng, frames: int = 120) -> dict:
    """Perf-scope ms summed over `frames` frames of ``step``, after one
    untimed run of as many frames (captures on first use), with an archive
    wide enough to keep every segment's scopes. The untimed run's last
    segment is archived before the archive is cleared (the JAX probe
    counts it among the timed segments)."""
    totals: dict[str, float] = defaultdict(float)
    eng.step(frames)
    U.sync(eng.device)
    keep = eng.perf.keep_frames
    eng.perf.keep_frames = max(keep, frames + 1)
    eng.perf.begin_tick()
    eng.perf._frames = []
    try:
        t0 = time.perf_counter()
        eng.step(frames)
        U.sync(eng.device)
        wall = (time.perf_counter() - t0) * 1e3
        eng.perf.begin_tick()  # archive the last segment
        nseg = 0
        for fr in eng.perf._frames:
            nseg += 1
            for e in fr:
                totals[e.name] += e.ms
    finally:
        eng.perf.keep_frames = keep
    return {"wall_ms": round(wall, 1), "segments": nseg,
            "scope_ms": {k: round(v, 1) for k, v in totals.items()},
            "unattributed_ms": round(
                wall - sum(totals[k] for k in SCOPES), 1)}


def steady(eng, frames: int = 120, windows: int = 3,
           profile_frames: int = 60) -> dict:
    """The decomposition, the three driving modes and ``profile_tick`` on
    `eng` as it stands; leaves ``micro_batching`` on."""
    out = {"march_breakdown": scope_totals(eng, frames)}
    for key, fn in (("fps_micro", eng.step), ("fps_perframe", eng.step),
                    ("fps_scan", eng.step_scan)):
        eng.micro_batching = key != "fps_perframe"
        try:
            vals, med = U.fps_of(eng, fn, frames, windows)
        finally:
            eng.micro_batching = True
        out[key] = {"all": [round(v, 1) for v in vals], "median": round(med, 1)}
    prof = eng.profile_tick(profile_frames)
    out["tick_classes"] = prof.get("classes")
    out["tick_ms_mean"] = round(prof.get("ms_mean", 0.0), 3)
    return out


def main(argv=None) -> dict:
    ap = U.parser("probe_steady", __doc__)
    ap.add_argument("--n-per-side", type=int, default=5000)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--profile-frames", type=int, default=60)
    ap.add_argument("--warmup", type=int, default=60)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_steady")
    eng = bench.build_battle(args.n_per_side, terrain=True, device=device)
    eng.step(args.warmup)   # the first captures
    out = steady(eng, args.frames, args.windows, args.profile_frames)
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
