"""Stress battle: two armies march into each other and fight.

Port of ``demos/stress.py``, which mirrors the reference's
scripts/test_stress.py (2 x 256 units on a 4x4-chunk map, ref:
test_stress.py:46-50) at any army size: the default matches the
reference, ``--units 5000`` is the north-star 10k battle. Runs on the card;
``--cpu`` asks for the CPU. Prints a report per simulated second.

Run: ``python -m permafrost_engine_tpu_torch.demos.stress --units 5000``
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from permafrost_engine_tpu_torch.core.config import DiplomacyState, EngineConfig
from permafrost_engine_tpu_torch.game.engine import Engine


def build(units_per_side: int, device="cuda") -> Engine:
    # arena sized to the workload (dense arenas pay for dead padding)
    cfg = EngineConfig(max_ents=max(1024, 2 * units_per_side + 256))
    eng = Engine(cfg, device=device)
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(0)

    def army(x0):
        files = max(8, int(np.sqrt(units_per_side) * 0.8))
        fx = (np.arange(units_per_side) % files) * 4.0
        fz = (np.arange(units_per_side) // files) * 3.0
        return np.stack([
            x0 + fx + (rng.random(units_per_side) - 0.5),
            300.0 + fz + (rng.random(units_per_side) - 0.5)], 1).astype(np.float32)

    ranged = rng.random(units_per_side) < 0.2
    a = eng.spawn_batch(army(150.0), faction=0, max_speed=20.0, hp=150.0,
                        is_ranged=ranged,
                        attack_range=np.where(ranged, 40.0, 5.0))
    b = eng.spawn_batch(army(800.0), faction=1, max_speed=20.0, hp=150.0,
                        is_ranged=ranged,
                        attack_range=np.where(ranged, 40.0, 5.0))
    eng.move(a, (850.0, 450.0))
    eng.move(b, (160.0, 450.0))
    return eng


def report(eng: Engine) -> dict:
    """Living units, drained deaths and the summed hp, from one host copy."""
    h = eng.ents_host("alive", "hp")
    return dict(alive=int(h["alive"].sum()),
                deaths=sum(1 for e in eng.events if e[0] == "entity_death"),
                total_hp=float(h["hp"].clip(0).sum()))


def run(eng: Engine, seconds: int) -> tuple[float, list[dict]]:
    """``main``'s loop: `seconds` simulated seconds, one ``step_scan(60)``
    each. Returns the first second's wall time (it captures the segment
    graphs on the card) and one report per later second with its fps."""
    t0 = time.perf_counter()
    eng.step_scan(60)
    first_s = time.perf_counter() - t0
    print(f"capture+first second: {first_s:.1f}s")
    rows = []
    for s in range(seconds - 1):
        t0 = time.perf_counter()
        eng.step_scan(60)       # ends with a synchronous drain of the events
        dt = time.perf_counter() - t0
        r = dict(t=s + 2, fps=60 / dt, **report(eng))
        print(f"t={r['t']:3d}s  {r['fps']:7.1f} fps  alive={r['alive']:6d} "
              f"deaths={r['deaths']:5d} total_hp={r['total_hp']:9.0f}")
        rows.append(r)
    return first_s, rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--units", type=int, default=256, help="units per side")
    ap.add_argument("--seconds", type=int, default=20, help="sim seconds")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)
    eng = build(args.units, device="cpu" if args.cpu else "cuda")
    return run(eng, args.seconds)


if __name__ == "__main__":
    main()
