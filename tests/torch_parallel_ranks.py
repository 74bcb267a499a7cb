"""Rank programs of tests/test_torch_parallel.py (not collected: no test_
prefix). Spawned rank processes import this module afresh, so it imports
only torch, numpy and the port, never jax or the JAX package.

Every scene is built the same way in a rank and in the single-device
reference (``build``); a rank returns what the test compares: digests of
its state, the compared arrays, the plan's tags, the collective counters
and the modules of the JAX package it loaded (none)."""

from __future__ import annotations

import hashlib
import sys

import numpy as np
import torch

from permafrost_engine_tpu_torch.core.config import (
    DiplomacyState,
    EngineConfig,
)
from permafrost_engine_tpu_torch.game.engine import Engine

COMPARED = ("ents.pos", "ents.vel", "ents.hp", "fog.state", "nav.blockers",
            "fields.global_flow")


def small_cfg(max_ents: int) -> EngineConfig:
    """tests/test_parallel.py's config."""
    return EngineConfig(max_ents=max_ents, chunks_r=2, chunks_c=2,
                        num_layers=1, max_flocks=8, max_projectiles=64,
                        field_slab_slots=16, los_slab_slots=16)


def build(scene: str, device="cpu"):
    """The scenes of tests/test_parallel.py: ``"tick"`` (512 slots, 64 a
    side at war, side 0 ordered across, seed 0), ``"map16k"`` (16,384
    slots, 8,000 a side, seed 1) and ``"seek"`` (512 slots, 32 a side,
    seed 2). Returns (engine, side-0 uids)."""
    cfg, seed, n, spread, off0, off1, dmg = {
        "tick": (small_cfg(512), 0, 64, 100, 50, 250, None),
        "map16k": (small_cfg(16384), 1, 8000, 200, 30, 280, 0.0),
        "seek": (small_cfg(512), 2, 32, 100, 50, 250, 0.0),
    }[scene]
    eng = Engine(cfg, device=device)
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(seed)
    a = eng.spawn_batch((rng.random((n, 2)) * spread + off0).astype(np.float32),
                        faction=0, max_speed=40.0)
    kw = {} if dmg is None else {"base_dmg": dmg}
    eng.spawn_batch((rng.random((n, 2)) * spread + off1).astype(np.float32),
                    faction=1, **kw)
    if scene == "tick":
        eng.move(a, (300.0, 300.0))
    elif scene == "map16k":
        eng.move(a, (400.0, 400.0))
    return eng, a


def leaf(eng, name: str) -> torch.Tensor:
    obj = eng.state
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def digest(eng) -> str:
    """SHA-256 (16 hex digits) of the compared leaves' bytes."""
    h = hashlib.sha256()
    for name in COMPARED:
        h.update(leaf(eng, name).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def drive(eng, scene: str, hunters) -> None:
    """What each scene does after the build: step, or order a seek."""
    if scene == "tick":
        eng.step(30)
    elif scene == "map16k":
        eng.step(12)
    else:
        eng.seek_enemies(hunters)


def reference(scene: str) -> dict:
    """The single-device port's result of `scene` on the CPU."""
    eng, hunters = build(scene)
    drive(eng, scene, hunters)
    return dict(digest=digest(eng),
                arrays={k: leaf(eng, k).numpy().copy() for k in COMPARED},
                hunter_slot=eng.uid_to_slot[hunters[0]], engine=eng)


def run_scene(scene: str, map_sharded: bool) -> dict:
    """A rank: build `scene` on the CPU, shard it over the mesh, drive it,
    and report."""
    from permafrost_engine_tpu_torch.ops import crowd_cuda
    from permafrost_engine_tpu_torch.parallel import (
        make_mesh, sharded_engine)

    mesh = make_mesh(device="cpu")
    eng, hunters = build(scene)
    hook_before = eng.nav.sharded_integrate
    sharded_engine(eng, mesh, map_sharded=map_sharded)
    mesh.reset_counters()
    crowd_cuda.launches = 0
    drive(eng, scene, hunters)
    hook = eng.nav.sharded_integrate
    out = dict(
        rank=mesh.rank, transport=mesh.transport, digest=digest(eng),
        plan=dict(mesh.state_plan), counters=mesh.counters,
        hook_before=hook_before is not None, hook=hook is not None,
        band_stats=None if hook is None else dict(hook.stats),
        k1_rows=mesh.rows(eng.cfg.max_ents),
        jax_modules=sorted(m for m in sys.modules if m.split(".")[0] in (
            "jax", "jaxlib", "flax", "permafrost_engine_tpu")))
    if mesh.rank == 0:
        out["arrays"] = {k: leaf(eng, k).numpy().copy() for k in COMPARED}
        out["hunter_slot"] = eng.uid_to_slot[hunters[0]]
        out["global_slot"] = eng.state.flocks.global_slot.numpy().copy()
        out["flock"] = eng.state.ents.flock.numpy().copy()
    return out


def run_inventory() -> dict:
    """A rank: tests/test_parallel.py's collective inventory on its config
    (1,024 slots). The entity-sharded tick steps one movement substep;
    then a map-sharded engine orders a seek (a whole-map field through the
    banded integrator) and steps one more. Returns both counter sets."""
    from permafrost_engine_tpu_torch.parallel import (
        make_mesh, sharded_engine)

    mesh = make_mesh(device="cpu")
    out = {}
    for map_sharded in (False, True):
        eng = Engine(small_cfg(1024), device="cpu")
        eng.add_faction(0)
        eng.add_faction(1)
        eng.set_diplomacy(0, 1, DiplomacyState.WAR)
        rng = np.random.default_rng(0)
        a = eng.spawn_batch((rng.random((64, 2)) * 100 + 50
                             ).astype(np.float32), faction=0, max_speed=40.0)
        eng.spawn_batch((rng.random((64, 2)) * 100 + 250).astype(np.float32),
                        faction=1)
        sharded_engine(eng, mesh, map_sharded=map_sharded)
        mesh.reset_counters()
        if map_sharded:
            eng.seek_enemies(a)
        eng.step(3)
        out["map_sharded" if map_sharded else "sharded"] = {
            k: dict(v) for k, v in mesh.counters.items()}
    return out


def run_integrate(cost: np.ndarray, seeds: np.ndarray) -> dict:
    """A rank: the row-banded integrator on whole inputs."""
    from permafrost_engine_tpu_torch.parallel import (
        make_mesh, make_sharded_integrate)

    mesh = make_mesh(device="cpu")
    h, w = cost.shape
    fn = make_sharded_integrate(mesh, h, w)
    got = fn(torch.from_numpy(cost), torch.from_numpy(seeds))
    return dict(rank=mesh.rank, field=got.numpy(), stats=dict(fn.stats),
                counters=mesh.counters)


def run_imports() -> list[str]:
    """A rank that loads the parallel package and a sharded engine module
    and reports the JAX modules in its interpreter."""
    import permafrost_engine_tpu_torch.parallel  # noqa: F401
    from permafrost_engine_tpu_torch.parallel import make_mesh

    make_mesh(device="cpu")
    return sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "permafrost_engine_tpu"))


def run_raising() -> None:
    """A rank program whose rank 1 raises."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 gives up")


def run_hanging() -> None:
    """A rank program whose rank 1 never returns."""
    import time

    import torch.distributed as dist

    while dist.get_rank() == 1:
        time.sleep(1.0)
