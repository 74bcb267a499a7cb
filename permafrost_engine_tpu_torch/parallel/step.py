"""The sharded simulation step: the multi-rank driving mode.

Counterpart of ``permafrost_engine_tpu/parallel/step.py``. Every rank runs
the same engine program on the whole state (``parallel/mesh.py``); the
tick divides its per-entity work by entity rows and, with `map_sharded`,
the blocker restamp and the flat-map fog by row bands, and ``all_gather``
puts the columns back together: the exchange JAX's partitioner inserts for
the same tick (all-gathers of entity columns; collective permutes for the
halos of the row-banded field integrator). The ops on each row are the
single-device tick's, so every rank's state equals the single-device
engine's state bit for bit.

Usage, inside a rank (``mesh.spawn``):
    mesh = make_mesh()
    eng = load_session_bytes(blob, device=mesh.device)   # or Engine(...)
    sharded_engine(eng, mesh, map_sharded=True)
    eng.step(120)
"""

from __future__ import annotations

import functools

import torch

from permafrost_engine_tpu_torch.core.config import EngineConfig
from permafrost_engine_tpu_torch.game.step import (
    RowPartition,
    cadence_period,
    make_tick,
)
from permafrost_engine_tpu_torch.parallel.mesh import (  # noqa: F401
    ENT_AXIS,
    make_mesh,
    shard_state,
    state_shardings,
)
from permafrost_engine_tpu_torch.state.schema import empty_deltas


def deltas_shardings(cfg: EngineConfig, mesh) -> dict[str, str]:
    """The plan of the ``TickDeltas`` accumulator: entity-major leaves
    ``"ents"``, projectile-pool leaves ``"repl"``."""
    acc = empty_deltas(cfg, device="cpu")
    return {name: ("ents" if t.shape[:1] == (cfg.max_ents,) else "repl")
            for name, t in vars(acc).items()}


def make_sharded_tick(cfg: EngineConfig, mesh, tile_height=None,
                      map_sharded: bool = False, skin_bank=None):
    """The tick ``(state, acc) -> (state, acc)`` of this rank: the
    single-device tick (``game/step.make_tick``) with the movement
    substep's query side on the rank's ``max_ents / world`` entity rows
    and, with `map_sharded`, the blocker restamp and the flat-map fog on
    the rank's bands of nav and fog rows; every result is gathered whole."""
    part = RowPartition(
        ents=mesh.rows(cfg.max_ents), gather=mesh.all_gather_rows,
        field_rows=mesh.rows(cfg.field_h) if map_sharded else None,
        fog_rows=mesh.rows(cfg.tiles_h) if map_sharded else None)
    return make_tick(cfg, tile_height, skin_bank=skin_bank, part=part)


class EagerTicks:
    """``game/graphs.TickGraphs``' interface over eager ticks: ``(state, n,
    acc=None) -> (state, acc)`` runs n ticks in turn. A sharded tick's
    exchange waits on its peers (a gloo message syncs the host), so it is
    never captured in a CUDA graph; ``stats`` counts no captures."""

    def __init__(self, tick, period: int, new_acc):
        self.tick, self.period, self.new_acc = tick, period, new_acc
        self.launches: dict = {}
        self.stats = {"captures": 0, "capture_ms": 0.0, "replays": 0}

    def __call__(self, state, n: int, acc=None):
        if acc is None:
            acc = self.new_acc(state.ents.pos.device)
        for _ in range(n):
            state, acc = self.tick(state, acc)
        return state, acc


def make_sharded_scan(cfg: EngineConfig, tile_height=None, skin_bank=None,
                      *, mesh, map_sharded: bool = False) -> EagerTicks:
    """``game/step.make_tick_scan``'s counterpart for a rank: an
    ``EagerTicks`` over ``make_sharded_tick``."""
    return EagerTicks(
        make_sharded_tick(cfg, mesh, tile_height, map_sharded, skin_bank),
        cadence_period(cfg),
        lambda device: empty_deltas(cfg, device=device))


def sharded_engine(engine, mesh, map_sharded: bool = False):
    """Re-home an existing Engine onto `mesh` in place: its state on the
    rank's device with the plan attached (``shard_state``), its tick and
    segment stepper the sharded ones (kept across ``load_map_data`` and
    ``set_skin_bank``), and, with `map_sharded`, whole-map seek and
    surround fields built through the row-banded halo integrator
    (``NavService.sharded_integrate``). The engine must already live on
    ``mesh.device`` (build or load it there): its host services hold
    tensors on that device."""
    def index(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d

    if index(engine.device) != index(mesh.device):
        raise ValueError(f"sharded_engine: the engine is on {engine.device}, "
                         f"the rank computes on {mesh.device}")
    cfg = engine.cfg
    engine.state = shard_state(cfg, mesh, engine.state, map_sharded)
    engine._make_scan = functools.partial(make_sharded_scan, mesh=mesh,
                                          map_sharded=map_sharded)
    engine._build_steppers()
    engine.mesh = mesh
    if map_sharded and cfg.field_h % mesh.world == 0:
        from permafrost_engine_tpu_torch.parallel.fields import (
            make_sharded_integrate)
        engine.nav.sharded_integrate = make_sharded_integrate(
            mesh, cfg.field_h, cfg.field_w, axis=ENT_AXIS)
    return engine
