"""Probe: the render frame's cost by pass at a given resolution.

Uses ``SceneRenderer``'s ``render_log`` (``pf.debug.render_log_mask`` 3:
each pass synchronized and wall-timed, and the live triangles of each
pass) and an overlays-off A/B to split the frame: geometry soup, shadow
pass, raster, shade, water, and the host's overlays, HUD and UI. Then the
same frame again, whose shadow map is cached.

Port of ``tools/probe_render_breakdown.py``: the port bench's
``render_scene`` at 640x384 by default, the same frame counts and lines.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_render_breakdown
[--cpu] [--w 640] [--h 384] [--ents 1000] [--frames 8] [--log-frames 4]
[--out PATH]``
"""

from __future__ import annotations

import time

import numpy as np

from permafrost_engine_tpu_torch import bench
from permafrost_engine_tpu_torch.tools import _probe_util as U


def breakdown(eng, cam, w: int = 640, h: int = 384, n_ents: int = 1000,
              frames: int = 8, log_frames: int = 4, log=print) -> dict:
    """The probe on a fresh scene (``bench.render_scene``: the engine and
    its camera)."""
    from permafrost_engine_tpu_torch.core.settings import SettingType
    from permafrost_engine_tpu_torch.render.scene import SceneRenderer

    eng.step(30)
    r = SceneRenderer(eng, w=w, h=h, maxi=n_ents, shadows=True,
                      reflections=True)
    t0 = time.perf_counter()
    r.render(cam, faction_pov=0)
    out = {"resolution": f"{w}x{h}", "first_frame_s": time.perf_counter() - t0}
    log(f"first frame: {out['first_frame_s']:.1f} s")

    for key, overlays in (("no_overlays", False), ("full", True)):
        times = []
        for _ in range(frames):
            eng._frame += 1
            t0 = time.perf_counter()
            r.render(cam, faction_pov=0, overlays=overlays)
            times.append((time.perf_counter() - t0) * 1e3)
        out[f"render_ms_p50_{key}"] = float(np.median(times))
        label = "no-overlays" if key == "no_overlays" else "full"
        log(f"render {label} p50: {np.median(times):.1f} ms")

    # per-pass split (a synchronize per pass: the sum can exceed the
    # pipelined frame)
    eng.settings.create("pf.debug.render_log_mask", SettingType.INT, 3,
                        persist=False)
    for _ in range(log_frames):
        eng._frame += 1
        r.render(cam, faction_pov=0)
    out["passes"] = list(r.render_log)[-3:]
    for rec in out["passes"]:
        log(f"passes: {rec}")

    # the shadow pass is cached within a frame
    t0 = time.perf_counter()
    r.render(cam, faction_pov=0)
    out["same_frame_ms"] = (time.perf_counter() - t0) * 1e3
    log(f"same-frame (shadow cached): {out['same_frame_ms']:.1f} ms")
    return out


def main(argv=None) -> dict:
    ap = U.parser("probe_render_breakdown", __doc__)
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--h", type=int, default=384)
    ap.add_argument("--ents", type=int, default=1000)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--log-frames", type=int, default=4)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_render_breakdown")
    eng, cam = bench.render_scene(args.ents, device)
    out = breakdown(eng, cam, args.w, args.h, args.ents, args.frames,
                    args.log_frames)
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
