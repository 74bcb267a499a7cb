"""Multi-rank scaling evidence: the collectives of the sharded tick and a
64k-entity map-sharded soak held bit-identical to one device.

1. ``probe_collectives``: the collectives each rank issues per tick,
   counted by ``Mesh.counters`` (calls and bytes by kind: ``all_gather``,
   ``halo``, ``all_reduce``) over a run of ticks, for the replicated tick
   (``game/step.make_tick`` on every rank: none expected), the
   entity-sharded tick and the map-sharded tick
   (``parallel/step.make_sharded_tick``). The entity-sharded tick gathers
   the entity columns its rows computed; the map-sharded one gathers the
   nav and fog bands too. A map-sharded engine also builds its whole-map
   fields through the row-banded integrator (``parallel/fields.py``),
   whose halo exchanges are counted for one field under ``field``. With
   each mode, the peak memory of the rank's device
   (``torch.cuda.max_memory_allocated``; null on the CPU).
2. ``soak_bit_identity``: 65,536 slots (65,408 moving units, rng seed 7)
   stepped 8 ticks map-sharded, against the same ticks on one device in
   the same rank: every state tensor must be bit-identical.

The JAX probe counts the collectives of the compiled tick's HLO on a
virtual 8-device CPU mesh and reads XLA's memory analysis. Here each rank
is a process (``parallel.spawn``): by default 4 ranks, which on the card
share it (transport ``gloo-host``, as ``chip_smoke.py`` phase 10) and on
the CPU use gloo. The output names the ranks and the transport.

Run: ``python -m permafrost_engine_tpu_torch.tools.probe_shard [--cpu]
[--ranks 4] [--n-ents 4096] [--ticks 60] [--soak-ents 65536]
[--soak-ticks 8] [--threads 2] [--out PATH]``
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from permafrost_engine_tpu_torch.tools import _probe_util as U

MODES = ("replicated", "sharded", "map_sharded")
TIMEOUT_S = 600.0     # a rank still running then fails the probe


def probe_state(cfg, device, seed: int = 7):
    """``init_state`` with ``max_ents - 128`` units moving (rng `seed`:
    positions, then destinations, uniform in [50, 950)), as the JAX
    probe's soak fills its state."""
    from permafrost_engine_tpu_torch.core.config import MoveState
    from permafrost_engine_tpu_torch.state.schema import init_state

    state = init_state(cfg, device=device)
    rng = np.random.default_rng(seed)
    n = cfg.max_ents - 128
    pos = (rng.random((n, 2)) * 900 + 50).astype(np.float32)
    dest = (rng.random((n, 2)) * 900 + 50).astype(np.float32)
    e = state.ents
    e.alive[:n] = True
    e.uid[:n] = torch.arange(n, dtype=e.uid.dtype)
    e.pos[:n] = torch.from_numpy(pos)
    e.max_speed[:n] = 20.0
    e.hp[:n] = 100.0
    e.max_hp[:n] = 100.0
    e.radius[:n] = 1.0
    e.movestate[:n] = int(MoveState.MOVING)
    e.dest[:n] = torch.from_numpy(dest)
    return state


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield prefix + f.name, v
        elif dataclasses.is_dataclass(v):
            yield from _leaves(v, prefix + f.name + ".")


def _peak(dev):
    return (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def probe_collectives(mesh, n_ents: int = 4096, ticks: int = 60) -> dict:
    """Per mode, this rank's collectives over `ticks` ticks of the
    ``probe_state`` (totals and per tick) and its peak memory; for
    ``map_sharded`` also one whole-map field through the band
    integrator."""
    from permafrost_engine_tpu_torch.core.config import COST_IMPASSABLE, EngineConfig
    from permafrost_engine_tpu_torch.game.step import make_tick
    from permafrost_engine_tpu_torch.parallel.fields import make_sharded_integrate
    from permafrost_engine_tpu_torch.parallel.mesh import shard_state
    from permafrost_engine_tpu_torch.parallel.step import make_sharded_tick
    from permafrost_engine_tpu_torch.state.schema import empty_deltas

    cfg = EngineConfig(max_ents=n_ents)
    dev = mesh.device
    res = {}
    for mode in MODES:
        _reset_peak(dev)
        state = probe_state(cfg, dev)
        acc = empty_deltas(cfg, device=dev)
        if mode == "replicated":
            tick = make_tick(cfg)
        else:
            ms = mode == "map_sharded"
            state = shard_state(cfg, mesh, state, ms)
            tick = make_sharded_tick(cfg, mesh, None, map_sharded=ms)
        mesh.reset_counters()
        for _ in range(ticks):
            state, acc = tick(state, acc)
        counts = copy.deepcopy(mesh.counters)
        r = {"ticks": ticks, "collectives": counts,
             "per_tick": {k: {"calls": v["calls"] / ticks,
                              "bytes": v["bytes"] / ticks}
                          for k, v in counts.items()},
             "total_calls": sum(v["calls"] for v in counts.values()),
             "total_bytes": sum(v["bytes"] for v in counts.values())}
        if mode == "map_sharded":
            rng = np.random.default_rng(3)
            cost = np.ones((cfg.field_h, cfg.field_w), np.uint8)
            cost[rng.random(cost.shape) < 0.15] = COST_IMPASSABLE
            seeds = np.zeros(cost.shape, bool)
            seeds[cfg.field_h // 2, cfg.field_w // 2] = True
            cost[seeds] = 1
            integrate = make_sharded_integrate(mesh, cfg.field_h, cfg.field_w)
            mesh.reset_counters()
            integrate(torch.from_numpy(cost).to(dev),
                      torch.from_numpy(seeds).to(dev))
            r["field"] = {"shape": [cfg.field_h, cfg.field_w],
                          "sweeps": integrate.stats["sweeps"],
                          "collectives": copy.deepcopy(mesh.counters)}
        r["memory_per_rank"] = _peak(dev)
        res[mode] = r
    return res


def soak_bit_identity(mesh, n_ents: int = 65536, ticks: int = 8) -> dict:
    """`ticks` map-sharded ticks of the ``probe_state`` against the same
    ticks of the single-device tick in this rank: whether every state
    tensor is bit-identical, and which are not."""
    from permafrost_engine_tpu_torch.core.config import EngineConfig
    from permafrost_engine_tpu_torch.game.step import make_tick
    from permafrost_engine_tpu_torch.parallel.mesh import shard_state
    from permafrost_engine_tpu_torch.parallel.step import make_sharded_tick
    from permafrost_engine_tpu_torch.state.schema import empty_deltas

    cfg = EngineConfig(max_ents=n_ents)
    dev = mesh.device
    s1, a1 = probe_state(cfg, dev), empty_deltas(cfg, device=dev)
    tick1 = make_tick(cfg)
    for _ in range(ticks):
        s1, a1 = tick1(s1, a1)

    _reset_peak(dev)
    s2 = shard_state(cfg, mesh, probe_state(cfg, dev), True)
    a2 = empty_deltas(cfg, device=dev)
    tick_r = make_sharded_tick(cfg, mesh, None, map_sharded=True)
    mesh.reset_counters()
    for _ in range(ticks):
        s2, a2 = tick_r(s2, a2)
    ref = dict(_leaves(s1))
    differ = [name for name, t in _leaves(s2) if not torch.equal(t, ref[name])]
    return {"n_ents": n_ents, "ticks": ticks,
            "bit_identical": not differ and s1.tick == s2.tick,
            "differ": differ,
            "sharded_memory_per_rank": _peak(dev),
            "collectives": copy.deepcopy(mesh.counters),
            "n_ranks": mesh.world}


def rank_main(n_ents: int, ticks: int, soak_ents: int, soak_ticks: int,
              device: str) -> dict:
    """One rank: both probes on this rank's mesh, and its K1 launches."""
    from permafrost_engine_tpu_torch.ops import crowd_cuda
    from permafrost_engine_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu" if device == "cpu" else None)
    k1 = crowd_cuda.launches
    out = {"rank": mesh.rank, "transport": mesh.transport,
           "device": str(mesh.device),
           "collectives_by_mode": probe_collectives(mesh, n_ents, ticks),
           "soak": soak_bit_identity(mesh, soak_ents, soak_ticks)}
    out["k1_launches"] = crowd_cuda.launches - k1
    return out


def shard(ranks: int = 4, n_ents: int = 4096, ticks: int = 60,
          soak_ents: int = 65536, soak_ticks: int = 8, device="cuda",
          threads: int | None = 2, log=print) -> dict:
    """Both probes on `ranks` rank processes; rank 0's numbers, with every
    rank's bit-identity and peak memory."""
    from permafrost_engine_tpu_torch.parallel.mesh import spawn

    res = spawn(rank_main, ranks, n_ents, ticks, soak_ents, soak_ticks,
                device, device=device, timeout_s=TIMEOUT_S, threads=threads,
                log=log)
    r0 = res[0]
    soak = dict(r0["soak"])
    soak["bit_identical"] = all(r["soak"]["bit_identical"] for r in res)
    soak["memory_per_rank"] = [r["soak"]["sharded_memory_per_rank"]
                               for r in res]
    return {"mesh_ranks": ranks, "transport": r0["transport"],
            "mesh_note": (f"{ranks} rank processes ({r0['transport']}) where "
                          "the JAX probe has 8 virtual CPU devices"),
            "collectives_by_mode": r0["collectives_by_mode"],
            "soak_64k_map_sharded": soak,
            "k1_launches_per_rank": [r["k1_launches"] for r in res]}


def main(argv=None) -> dict:
    ap = U.parser("probe_shard", __doc__)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--n-ents", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=60)
    ap.add_argument("--soak-ents", type=int, default=65536)
    ap.add_argument("--soak-ticks", type=int, default=8)
    ap.add_argument("--threads", type=int, default=2,
                    help="torch threads per rank")
    args = ap.parse_args(argv)
    device = U.device_of(args, "probe_shard")
    out = shard(args.ranks, args.n_ents, args.ticks, args.soak_ents,
                args.soak_ticks, device, threads=args.threads)
    return U.emit(out, args.out)


if __name__ == "__main__":
    main()
