#!/usr/bin/env python3
"""Where the time of the port's movement substep goes, on one CUDA device.

Run from the repository root: ``python3 tools/profile_torch_slice.py``.
It builds ``chip_smoke.py``'s battle scene (two 5,000-unit armies ordered
across the battle map, 10,256 slots), steps 60 frames into the march, and
then measures:

- per substep, median of 10, synchronized host clock: the whole substep
  (``Engine.step(1)`` on a substep frame), its front half
  (``step.crowd_inputs``: grid, window, flow/LOS sampling, boids) and K1
  (``hrvo_select`` on those inputs), each timed alone on the same state;
  the rest (contacts, integration, restamp) is the whole minus the two;
- 30 frames (10 substeps) under ``torch.profiler``: wall time, device time
  (summed over device-side events, and as the union of their intervals),
  busy share (union over wall), device events and kernel launches, the
  share of host CPU time in ``cudaLaunchKernel``, and the largest device
  items;
- the same 30 frames without the profiler, for the profiler's overhead.

It prints one line per measurement and, as its last line, one JSON object
with every number.
"""

import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sync_ms(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from permafrost_engine_tpu_torch import FRAME_HZ
    from permafrost_engine_tpu_torch.game.step import crowd_inputs
    from permafrost_engine_tpu_torch.ops.crowd_cuda import hrvo_select

    dev = torch.device("cuda", 0)
    eng, _a, _b, _g = chip_smoke.build_battle(dev)
    eng.step(60)
    period = FRAME_HZ // eng.cfg.move_hz
    cfg = eng.cfg

    whole, front, k1 = [], [], []
    while len(whole) < 10:
        if (eng.state.tick + 1) % period == 0:
            front.append(sync_ms(lambda: crowd_inputs(cfg, eng.state)))
            args = crowd_inputs(cfg, eng.state)["hrvo_args"]
            k1.append(sync_ms(lambda: hrvo_select(
                *args, exact=cfg.clearpath_exact)))
            whole.append(sync_ms(lambda: eng.step(1)))
        else:
            eng.step(1)
    split = dict(substep_ms=statistics.median(whole),
                 front_ms=statistics.median(front),
                 k1_ms=statistics.median(k1))
    split["rest_ms"] = split["substep_ms"] - split["front_ms"] - split["k1_ms"]
    print("substep split (median of 10): " + " ".join(
        f"{k}={v:.3f}" for k, v in split.items()), flush=True)

    frames = 30
    plain_wall = sync_ms(lambda: eng.step(frames))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall = sync_ms(lambda: eng.step(frames))
    cuda = torch.autograd.DeviceType.CUDA
    rows = prof.key_averages()
    dev_rows = [r for r in rows if r.device_type == cuda]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s0, e0 in spans:                      # union of device intervals
        if cur_e is None or s0 > cur_e:
            busy_us += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy_us += 0.0 if cur_e is None else cur_e - cur_s
    cpu_us = sum(r.self_cpu_time_total for r in rows)
    launch = [r for r in rows if "LaunchKernel" in r.key]
    launches = sum(r.count for r in launch)
    launch_cpu_us = sum(r.self_cpu_time_total for r in launch)
    top = sorted(dev_rows, key=lambda r: r.self_device_time_total,
                 reverse=True)[:8]
    prof_res = dict(
        frames=frames, wall_ms=wall, wall_ms_no_profiler=plain_wall,
        device_ms=sum(r.self_device_time_total for r in dev_rows) / 1e3,
        device_busy_ms=busy_us / 1e3, busy_share=busy_us / 1e3 / wall,
        device_events=len(spans), kernel_launches=launches,
        launch_cpu_share=launch_cpu_us / max(cpu_us, 1e-9),
        top_device=[dict(name=r.key[:80], count=r.count,
                         device_ms=r.self_device_time_total / 1e3)
                    for r in top])
    print(f"profiled {frames} frames: wall_ms={wall:.3f} "
          f"(no profiler {plain_wall:.3f}) device_ms={prof_res['device_ms']:.3f} "
          f"device_busy_ms={prof_res['device_busy_ms']:.3f} "
          f"device_events={len(spans)} busy_share={prof_res['busy_share']:.4f} "
          f"kernel_launches={launches} "
          f"launch_cpu_share={prof_res['launch_cpu_share']:.4f}", flush=True)
    for t in prof_res["top_device"]:
        print(f"  {t['device_ms']:.3f} ms x{t['count']} {t['name']}")
    print(json.dumps(dict(device=torch.cuda.get_device_name(0), split=split,
                          profile=prof_res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
