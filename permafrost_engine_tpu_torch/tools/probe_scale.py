"""Perf probe: headroom past the north star: a 16,384-fighter battle
(8,192 a side, 16,640 slots) measured through contact, the median fps of
three 120-frame ``step`` windows and of three ``step_scan`` windows.

Port of ``tools/probe_scale.py``: ``bench.build_battle(n_per_side=8192)``
(the plain battle on the flat map), ``step(60)``, the bench's fast-forward
to the first death and ``step_scan(300)``, then the windows.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_scale [--cpu]
[--n-per-side 8192] [--frames 120] [--windows 3] [--warmup 60]
[--ff-chunk 300] [--ff-max-frames 6000] [--thicken 300] [--out PATH]``
"""

from __future__ import annotations

import numpy as np

from permafrost_engine_tpu_torch import bench
from permafrost_engine_tpu_torch.tools import _probe_util as U


def scale(eng, frames: int = 120, windows: int = 3, log=print) -> dict:
    """The ``step`` and ``step_scan`` windows on `eng` at contact."""
    fighters = eng.cfg.max_ents - 256     # bench.battle_engine's headroom
    out = {"max_ents": eng.cfg.max_ents,
           "alive_at_contact": bench.alive_count(eng)}
    log(f"alive at contact: {out['alive_at_contact']}")
    for name, drive in (("step", eng.step), ("step_scan", eng.step_scan)):
        vals, med = U.fps_of(eng, drive, frames, windows)
        out[f"fps_{name}"] = med
        out[f"fps_{name}_all"] = vals
        log(f"{fighters // 1000}k contact {name}: {med:.1f} fps")
    h = eng.ents_host("alive", "pos", "vel", "hp")
    out["alive_at_end"] = int(h["alive"].sum())
    out["finite"] = bool(all(np.isfinite(h[k][h["alive"]]).all()
                             for k in ("pos", "vel", "hp")))
    log(f"alive at end: {out['alive_at_end']}")
    return out


def main(argv=None) -> dict:
    ap = U.parser("probe_scale", __doc__)
    ap.add_argument("--n-per-side", type=int, default=8192)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--windows", type=int, default=3)
    U.contact_flags(ap)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_scale")
    eng = U.battle_to_contact(args, device, terrain=False)
    out = scale(eng, args.frames, args.windows)
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
