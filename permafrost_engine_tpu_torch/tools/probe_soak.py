"""Soak probe: run the 10k battle ~200 simulated seconds on the card and
hold the state's invariants at scale: no NaN among live positions, a unit
with ``hp <= 0`` that is not yet a corpse (legal for a moment: projectile
kills at 30 Hz become corpses at the next 10 Hz combat substep) resolves
within one combat period, and exact slot accounting. A failed invariant
raises.

Port of ``tools/probe_soak.py``: ``bench.build_battle()`` (two plain
5,000-unit armies on the flat map), ``step(60)``, then up to 40 windows of
``step_scan(300)`` (12,000 frames), stopping early when a side is gone.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_soak [--cpu]
[--n-per-side 5000] [--windows 40] [--window-frames 300] [--warmup 60]
[--out PATH]``
"""

from __future__ import annotations

import time

import numpy as np

from permafrost_engine_tpu_torch.core.config import CombatState
from permafrost_engine_tpu_torch import bench
from permafrost_engine_tpu_torch.tools import _probe_util as U

RESOLVE_FRAMES = 6    # one 10 Hz combat period


def soak(eng, windows: int = 40, window_frames: int = 300,
         log=print) -> dict:
    """Step `eng` in `windows` windows of ``step_scan(window_frames)``,
    checking the invariants after each (see the module docstring); returns
    each window's faction alive counts and transient-dead count, and the
    final slot accounting."""
    cols = ("alive", "pos", "hp", "faction", "combatstate")
    out = {"windows": []}
    t0 = time.perf_counter()
    for w in range(windows):
        eng.step_scan(window_frames)
        h = eng.ents_host(*cols)
        alive = h["alive"]
        if not np.isfinite(h["pos"][alive]).all():
            raise AssertionError(f"window {w}: NaN/inf positions")
        a0 = int((alive & (h["faction"] == 0)).sum())
        a1 = int((alive & (h["faction"] == 1)).sum())
        trans = (alive & (h["hp"] <= 0)
                 & (h["combatstate"] != CombatState.CORPSE))
        if trans.any():
            eng.step(RESOLVE_FRAMES)
            h2 = eng.ents_host("alive", "hp", "combatstate")
            stuck = (trans & h2["alive"] & (h2["hp"] <= 0)
                     & (h2["combatstate"] != CombatState.CORPSE))
            if stuck.any():
                raise AssertionError(f"{int(stuck.sum())} zombies persisted")
        log(f"w{w}: f0={a0} f1={a1} transient_dead={int(trans.sum())}")
        out["windows"].append({"f0": a0, "f1": a1,
                               "transient_dead": int(trans.sum())})
        if a0 == 0 or a1 == 0:
            log("one side eliminated")
            break
    n_live = int(eng.ents_host("alive")["alive"].sum())
    log(f"final: live {n_live} free {len(eng._free_slots)} "
        f"uids {len(eng.uid_to_slot)}")
    if n_live + len(eng._free_slots) != eng.cfg.max_ents:
        raise AssertionError(f"slots: {n_live} live + {len(eng._free_slots)} "
                             f"free != {eng.cfg.max_ents}")
    if len(eng.uid_to_slot) != n_live:
        raise AssertionError(f"{len(eng.uid_to_slot)} uids for {n_live} live")
    log("SOAK OK")
    out.update(frames=eng._frame, live=n_live, free=len(eng._free_slots),
               uids=len(eng.uid_to_slot), max_ents=eng.cfg.max_ents,
               wall_s=time.perf_counter() - t0)
    return out


def main(argv=None) -> dict:
    ap = U.parser("probe_soak", __doc__)
    ap.add_argument("--n-per-side", type=int, default=5000)
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--window-frames", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=60)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_soak")
    eng = bench.build_battle(args.n_per_side, device=device)
    eng.step(args.warmup)
    out = soak(eng, args.windows, args.window_frames)
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
