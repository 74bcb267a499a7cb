"""Perf probe: the driving modes at battle contact: micro-batched
``step`` (each fused segment one CUDA graph replay on the card), per-frame
``step`` (``eng.micro_batching = False``: an eager tick per frame) and
``step_scan`` (whole windows in segments), then the exact per-cadence-class
eager tick (``profile_tick``). Tells whether a frame is bound by dispatch
(launches per frame) or by the device tick.

Port of ``tools/probe_drive.py``: ``bench.build_battle()`` (the plain
5,000-a-side battle), ``step(60)``, the bench's fast-forward to the first
death and ``step_scan(300)``, then three 120-frame windows per mode.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_drive [--cpu]
[--n-per-side 5000] [--frames 120] [--windows 3]
[--profile-frames 30] [--warmup 60] [--ff-chunk 300]
[--ff-max-frames 6000] [--thicken 300] [--out PATH]``
"""

from __future__ import annotations

from permafrost_engine_tpu_torch import bench
from permafrost_engine_tpu_torch.tools import _probe_util as U


def drive(eng, frames: int = 120, windows: int = 3,
          profile_frames: int = 30, log=print) -> dict:
    """The three driving modes and ``profile_tick`` on `eng` as it stands
    (at contact); leaves ``micro_batching`` on."""
    out = {"alive_at_contact": bench.alive_count(eng)}
    log(f"at contact, alive: {out['alive_at_contact']}")
    vals, out["fps_step"] = U.fps_of(eng, eng.step, frames, windows)
    log(f"step() fps (micro-batched): {out['fps_step']:.2f}")
    eng.micro_batching = False
    try:
        vals1, out["fps_step_perframe"] = U.fps_of(eng, eng.step, frames,
                                                   windows)
    finally:
        eng.micro_batching = True
    log(f"step() fps (per-frame dispatch): {out['fps_step_perframe']:.2f}")
    vals2, out["fps_step_scan"] = U.fps_of(eng, eng.step_scan, frames, windows)
    log(f"step_scan() fps: {out['fps_step_scan']:.2f}")
    out["fps_all"] = {"step": vals, "step_perframe": vals1,
                      "step_scan": vals2}
    st = eng.profile_tick(profile_frames)
    out["tick"] = {k: st[k] for k in ("ms_p50", "ms_max", "ms_mean", "classes",
                                      "repeat_spread_pct")}
    log("exact device tick: " + str(
        {k: (round(v, 2) if isinstance(v, float) else v)
         for k, v in st.items()}))
    return out


def main(argv=None) -> dict:
    ap = U.parser("probe_drive", __doc__)
    ap.add_argument("--n-per-side", type=int, default=5000)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--profile-frames", type=int, default=30)
    U.contact_flags(ap)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_drive")
    eng = U.battle_to_contact(args, device, terrain=False)
    out = drive(eng, args.frames, args.windows, args.profile_frames)
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
