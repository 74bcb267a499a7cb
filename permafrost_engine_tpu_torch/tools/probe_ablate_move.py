"""Perf probe: the movement substep's cost by stage, by ablation.

Replaces single stages of ``game/step.movement_substep`` with constant
stand-ins and measures raw-tick throughput from the contact-phase battle
state (as ``probe_ablate``). Seven variants: ``full``; ``no_hrvo`` (K1,
``step.hrvo_select``, returns the preferred velocity); ``no_boids``
(``boids.preferred_velocity`` returns the flow direction at full speed);
``no_neigh`` (``grid.window_candidates`` returns an empty window);
``no_contact`` (``grid.contact_candidates`` returns no contacts);
``no_fields`` (``velocity.flow_velocity`` and ``dest_los``); and
``no_restamp`` (``step._restamp_blockers`` keeps the blockers).

The JAX probe relies on XLA's dead-code elimination to drop the producers
of a stand-in's unused inputs. PyTorch runs every op it is given, so:

* ``no_boids`` also stubs the producers that feed only the preferred
  velocity, ``boids.flock_cohesion_centroids`` and
  ``boids.formation_keep_force``, so it removes what it removes in JAX;
* the rest still run producers JAX would drop, listed per variant as
  ``still_runs``: one composite-key sort builds both grids
  (``grid.build_grid_pair``), so ``no_neigh`` still scatters the coarse
  buckets and ``no_contact`` the fine ones; ``no_hrvo`` still makes K1's
  contiguous argument copies in ``crowd_inputs``.

Each variant reports the calls of every patch point (the original's and
its stand-in's) and the K1 launches (``ops/crowd_cuda.launches``).

Port of ``tools/probe_ablate_move.py``: the same battle, contact and
windows as ``probe_ablate``.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_ablate_move
[--cpu] [--n-per-side 5000] [--frames 120] [--windows 3]
[--warm N] [--warmup 60] [--ff-chunk 300] [--ff-max-frames 6000]
[--thicken 300] [--out PATH]``
"""

from __future__ import annotations

import torch

from permafrost_engine_tpu_torch.game import step as step_mod
from permafrost_engine_tpu_torch.ops import boids, grid
from permafrost_engine_tpu_torch.ops import velocity as vel_ops
from permafrost_engine_tpu_torch import bench
from permafrost_engine_tpu_torch.tools import _probe_util as U

HRVO = (step_mod, "hrvo_select")
PREF = (boids, "preferred_velocity")
COHESION = (boids, "flock_cohesion_centroids")
KEEP = (boids, "formation_keep_force")
WINDOW = (grid, "window_candidates")
CONTACT = (grid, "contact_candidates")
FLOW = (vel_ops, "flow_velocity")
LOS = (vel_ops, "dest_los")
RESTAMP = (step_mod, "_restamp_blockers")
# every patch point, and the grid build, counted in every variant
POINTS = (HRVO, PREF, COHESION, KEEP, WINDOW, CONTACT, FLOW, LOS, RESTAMP,
          (grid, "build_grid_pair"))


def no_hrvo(pos, vel, radius, vpref, *args, **kw):
    return vpref


def no_boids(pos, vel, flock, dest, flow_dir, use_arrive, max_speed_tick,
             neigh_idx, neigh_valid, moving, **kw):
    return flow_dir * max_speed_tick[:, None]


def no_cohesion(pos, flock, mask, **kw):
    # the centroid is the unit's own position where it is alone
    return pos, U.const((pos.shape[0],), torch.float32, 0.0, pos.device)


def no_keep(pos, vel, flock, cell, has_cell, flock_formation, max_flocks,
            rows=slice(None)):
    n = pos[rows].shape[0]
    return U.const((n, 2), torch.float32, 0.0, pos.device)


def _empty_window(q: int, width: int, pay_c: int, dev):
    return (U.const((q, width), torch.int32, -1, dev),
            U.const((q, width, 2), torch.float32, 1e30, dev),
            U.const((q, width, pay_c), torch.float32, 0.0, dev),
            U.const((q, width), torch.bool, False, dev))


def no_neigh(sgrid, query_pos, query_slot, *, window=5):
    # the window's shape, every candidate invalid
    w2cap = window * window * sgrid.buckets.shape[1]
    pay_c = (sgrid.bucket_payload.shape[-1]
             if sgrid.bucket_payload is not None else 0)
    return _empty_window(query_pos.shape[0], w2cap, pay_c, query_pos.device)


def no_contact(cgrid, query_pos, query_slot):
    # all-invalid candidates zero the pushout and disable the projection
    cap9 = 9 * cgrid.packed.shape[1]
    return _empty_window(query_pos.shape[0], cap9, cgrid.packed.shape[-1] - 3,
                         query_pos.device)


def no_flow_vel(pos, flock, field_slot, flow, global_slot, global_flow,
                ent_gslot, *, chunks_r, chunks_c):
    q = pos.shape[0]
    return (U.const((q, 2), torch.float32, 0.0, pos.device),
            U.const((q,), torch.bool, False, pos.device))


def no_los(pos, flock, los_slot, los, *, chunks_r, chunks_c):
    return U.const((pos.shape[0],), torch.bool, True, pos.device)


def no_restamp(cfg, ents, nav, part=None):
    return nav.blockers


VARIANTS = [
    ("full", {}),
    ("no_hrvo", {HRVO: no_hrvo}),
    ("no_boids", {PREF: no_boids, COHESION: no_cohesion, KEEP: no_keep}),
    ("no_neigh", {WINDOW: no_neigh}),
    ("no_contact", {CONTACT: no_contact}),
    ("no_fields", {FLOW: no_flow_vel, LOS: no_los}),
    ("no_restamp", {RESTAMP: no_restamp}),
]
# what a variant still runs that XLA's dead-code elimination drops in JAX
STILL_RUNS = {
    "no_hrvo": ["crowd_inputs: K1's contiguous argument copies"],
    "no_neigh": ["grid.build_grid_pair: the coarse bucket scatters"],
    "no_contact": ["grid.build_grid_pair: the fine contact-grid packing"],
}


def ablate_move(eng, state0, frames: int = 120, windows: int = 3,
                warm: int | None = None, log=print) -> dict:
    """Every variant timed from the snapshot `state0` of `eng`'s state."""
    res = U.run_variants(eng, state0, VARIANTS, POINTS, frames, windows,
                         warm, log)
    for name, r in res.items():
        r["still_runs"] = STILL_RUNS.get(name, [])
    return res


def main(argv=None) -> dict:
    ap = U.parser("probe_ablate_move", __doc__)
    ap.add_argument("--n-per-side", type=int, default=5000)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--warm", type=int, default=None,
                    help="untimed frames first (default one cadence period)")
    U.contact_flags(ap)
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_ablate_move")
    eng = U.battle_to_contact(args, device, terrain=False)
    print(f"alive at contact: {bench.alive_count(eng)}", flush=True)
    out = ablate_move(eng, U.snapshot(eng.state), args.frames, args.windows,
                           args.warm)
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
