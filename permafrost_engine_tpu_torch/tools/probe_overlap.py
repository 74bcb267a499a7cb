"""Crowd-quality probe: interpenetration at a head-on meeting.

Two melee armies (``--units`` a side, 16 files, 5-unit attack range)
march into each other; each simulated second it prints the share of
living units that overlap a neighbour by more than half their combined
radius (the bench's ``overlap_frac``), the median and the largest
per-unit overlap depth, and the living count. Small enough to iterate on
contact constraints in seconds.

Port of ``tools/probe_overlap.py``, which forces the CPU; this one runs on
the card unless given ``--cpu``.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_overlap [--cpu]
[--units 256] [--seconds 30] [--out PATH]``
"""

from __future__ import annotations

import numpy as np

from permafrost_engine_tpu_torch import bench
from permafrost_engine_tpu_torch.tools import _probe_util as U


def overlap_stats(eng) -> tuple[float, float, float]:
    """(overlap fraction, median depth, largest depth) of the living,
    non-corpse units."""
    from permafrost_engine_tpu_torch.core.config import CombatState

    h = eng.ents_host("alive", "combatstate", "pos", "radius")
    live = h["alive"] & (h["combatstate"] != CombatState.CORPSE)
    pos, rad = h["pos"][live], h["radius"][live]
    if len(pos) < 2:
        return 0.0, 0.0, 0.0
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    comb = (rad[:, None] + rad[None, :]) * 0.5          # the bench's bar
    bad = (d < comb).any(axis=1)
    tang = rad[:, None] + rad[None, :]
    depth = np.maximum(tang - d, 0.0).max(axis=1)       # deepest overlap a unit
    return float(bad.mean()), float(np.median(depth)), float(depth.max())


def build(n: int, device="cuda"):
    """Two `n`-unit melee blocks (rng seed 0) at war, 150 units apart,
    each ordered through the other."""
    from permafrost_engine_tpu_torch.core.config import DiplomacyState, EngineConfig
    from permafrost_engine_tpu_torch.game.engine import Engine

    eng = Engine(EngineConfig(max_ents=max(1024, 2 * n + 64)), device=device)
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(0)

    def army(x0):
        files = 16
        fx = (np.arange(n) % files) * 4.0
        fz = (np.arange(n) // files) * 3.0
        return np.stack([x0 + fx + (rng.random(n) - 0.5),
                         200.0 + fz + (rng.random(n) - 0.5)], 1
                        ).astype(np.float32)

    a = eng.spawn_batch(army(150.0), faction=0, max_speed=20.0,
                        attack_range=5.0, hp=200.0)
    b = eng.spawn_batch(army(300.0), faction=1, max_speed=20.0,
                        attack_range=5.0, hp=200.0)
    eng.move(a, (350.0, 220.0))
    eng.move(b, (120.0, 220.0))
    return eng


def overlap(eng, seconds: int = 30, log=print) -> dict:
    """`seconds` of ``step(60)``, the statistics after each."""
    rows = []
    for s in range(seconds):
        eng.step(60)
        frac, dmed, dmax = overlap_stats(eng)
        alive = bench.alive_count(eng)
        log(f"t={s + 1:3d}s overlap_frac={frac:.3f} "
            f"depth_med={dmed:.2f} depth_max={dmax:.2f} alive={alive}")
        rows.append({"t": s + 1, "overlap_frac": frac, "depth_med": dmed,
                     "depth_max": dmax, "alive": alive})
    return {"seconds": rows}


def main(argv=None) -> dict:
    ap = U.parser("probe_overlap", __doc__)
    ap.add_argument("--units", type=int, default=256)
    ap.add_argument("--seconds", type=int, default=30)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_overlap")
    out = overlap(build(args.units, device), args.seconds)
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
