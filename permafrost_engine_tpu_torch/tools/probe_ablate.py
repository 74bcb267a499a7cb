"""Perf probe: the tick's cost by subsystem, by ablation.

Builds tick variants with one substep replaced by a passthrough (movement,
combat or fog), restores the same contact-phase battle state for each, and
measures the throughput of the raw tick (no host systems), one frame per
replay of a fresh one-frame ``TickGraphs`` (``_probe_util.run_variants``).
A diagnostic: the ablated ticks diverge as simulations, only their timing
matters. Each variant also reports the calls of every patched substep and
the K1 launches (0 for ``no_move``).

Port of ``tools/probe_ablate.py``: ``bench.build_battle()`` (the plain
5,000-a-side battle), ``step(60)``, the bench's fast-forward to the first
death and ``step_scan(300)``, a snapshot of every state tensor, then 3
windows of 120 frames per variant.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_ablate [--cpu]
[--n-per-side 5000] [--frames 120] [--windows 3] [--warm N]
[--warmup 60] [--ff-chunk 300] [--ff-max-frames 6000] [--thicken 300]
[--out PATH]``
"""

from __future__ import annotations

from permafrost_engine_tpu_torch.game import step as step_mod
from permafrost_engine_tpu_torch import bench
from permafrost_engine_tpu_torch.tools import _probe_util as U

POINTS = ((step_mod, "movement_substep"), (step_mod, "combat_substep"),
          (step_mod, "fog_substep"))


def passthrough(cfg, s, d, *extra):
    return s, d


def fog_passthrough(cfg, s, tile_height=None, part=None):
    return s


VARIANTS = [
    ("full", {}),
    ("no_move", {(step_mod, "movement_substep"): passthrough}),
    ("no_combat", {(step_mod, "combat_substep"): passthrough}),
    ("no_fog", {(step_mod, "fog_substep"): fog_passthrough}),
]


def ablate(eng, state0, frames: int = 120, windows: int = 3,
           warm: int | None = None, log=print) -> dict:
    """Every variant timed from the snapshot `state0` of `eng`'s state."""
    return U.run_variants(eng, state0, VARIANTS, POINTS, frames, windows,
                          warm, log)


def main(argv=None) -> dict:
    ap = U.parser("probe_ablate", __doc__)
    ap.add_argument("--n-per-side", type=int, default=5000)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--warm", type=int, default=None,
                    help="untimed frames first (default one cadence period)")
    U.contact_flags(ap)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_ablate")
    eng = U.battle_to_contact(args, device, terrain=False)
    print(f"alive at contact: {bench.alive_count(eng)}", flush=True)
    out = ablate(eng, U.snapshot(eng.state), args.frames, args.windows,
                      args.warm)
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
