"""Probe: the rasterizer's frame cost at a given resolution.

Times ``SceneRenderer.render`` on the battle-map scene (terrain, skinned
units, water, shadows, HUD). ``render`` ends in the u8 frame's host copy,
so each call is a true wall-clock frame. With ``--sim`` it also measures
the sim and the renderer together: 120 frames of ``step`` with a render
every 4th, then every 2nd frame.

Port of ``tools/probe_render.py``: the same scene and camera (the port
bench's ``render_scene``, the bench's render cell), frame counts and lines.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_render [--cpu]
[--w 1280] [--h 720] [--ents 1000] [--frames 30] [--sim]
[--sim-frames 120] [--out PATH]``
"""

from __future__ import annotations

import time

import numpy as np

from permafrost_engine_tpu_torch import bench
from permafrost_engine_tpu_torch.tools import _probe_util as U


def render_probe(eng, cam, w: int = 1280, h: int = 720, n_ents: int = 1000,
                 frames: int = 30, sim: bool = False, sim_frames: int = 120,
                 log=print) -> dict:
    """The probe on a fresh scene (``bench.render_scene``: the engine and
    its camera)."""
    from permafrost_engine_tpu_torch.render.scene import SceneRenderer

    eng.step(30)
    r = SceneRenderer(eng, w=w, h=h, maxi=n_ents, shadows=True,
                      reflections=True)
    t0 = time.perf_counter()
    img = r.render(cam, faction_pov=0)
    first_s = time.perf_counter() - t0
    log(f"first frame (compiles): {first_s:.1f} s, shape {img.shape}, "
        f"mean {img.mean():.1f}")
    out = {"resolution": f"{w}x{h}", "first_frame_s": first_s,
           "shape": list(img.shape), "mean": float(img.mean())}

    times = []
    for _ in range(frames):
        eng._frame += 1  # advance the shadow pass's cache key as a loop would
        t0 = time.perf_counter()
        r.render(cam, faction_pov=0)
        times.append((time.perf_counter() - t0) * 1e3)
    p50 = float(np.median(times))
    p90 = float(np.percentile(times, 90))
    log(f"render-only {w}x{h}: p50 {p50:.1f} ms ({1000.0 / p50:.1f} fps), "
        f"p90 {p90:.1f} ms")
    out.update(render_ms_p50=p50, render_ms_p90=p90, render_fps=1000.0 / p50)

    if sim:
        for dec in (4, 2):
            t0 = time.perf_counter()
            for _ in range(sim_frames // dec):
                eng.step(dec)
                r.render(cam, faction_pov=0)
            U.sync(eng.device)
            fps = sim_frames / (time.perf_counter() - t0)
            log(f"sim+render (render every {dec} frames): {fps:.1f} sim fps")
            out[f"sim_plus_render_fps_dec{dec}"] = fps
    return out


def main(argv=None) -> dict:
    ap = U.parser("probe_render", __doc__)
    ap.add_argument("--w", type=int, default=1280)
    ap.add_argument("--h", type=int, default=720)
    ap.add_argument("--ents", type=int, default=1000)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--sim", action="store_true",
                    help="also measure sim+render co-residency")
    ap.add_argument("--sim-frames", type=int, default=120)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_render")
    eng, cam = bench.render_scene(args.ents, device)
    out = render_probe(eng, cam, args.w, args.h, args.ents, args.frames,
                       args.sim, args.sim_frames)
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
