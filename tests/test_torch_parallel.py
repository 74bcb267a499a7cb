"""The port's parallel/ against the single-device port and the JAX package.

One case per test of tests/test_parallel.py, on its configs and seeds,
with gloo ranks on the CPU (``parallel.spawn`` on a ``file://`` store
under ``tmp_path``; the rank programs are ``tests/torch_parallel_ranks.py``,
which imports no JAX): 4 ranks for the engine cases, 8 for the band
integrator. A sharded run must equal the single-device port bit for bit
(positions, velocities, hp, fog, blockers, whole-map fields) with equal
digests on every rank; the single-device port is held to the JAX engine at
tests/test_torch_engine.py's tolerance, and the band integrator to JAX's
sharded and unsharded integrators at test_parallel.py's tolerance. Every
case joins its ranks with a timeout and stops them, so a deadlock fails
one case.
"""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

import torch_parallel_ranks as R
from permafrost_engine_tpu.core.config import COST_IMPASSABLE
from permafrost_engine_tpu.core.config import DiplomacyState as JaxDiplomacy
from permafrost_engine_tpu.core.config import EngineConfig as JaxConfig
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu.ops import flowfield as jff
from permafrost_engine_tpu.parallel.fields import (
    make_sharded_integrate as jax_sharded_integrate)
from permafrost_engine_tpu_torch.ops.flowfield import integrate_plain
from permafrost_engine_tpu_torch.parallel import spawn

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMEOUT_S = 300.0


def _ranks(tmp_path, fn, world, *args):
    return spawn(fn, world, *args, device="cpu", timeout_s=_TIMEOUT_S,
                 threads=1, store_dir=str(tmp_path), log=lambda _m: None)


def _sharded_and_reference(tmp_path, scene, map_sharded):
    """The 4-rank run of `scene` and, meanwhile, the single-device one."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_ranks, tmp_path, R.run_scene, 4, scene,
                          map_sharded)
        ref = R.reference(scene)
        return fut.result(), ref


def _assert_bit_equal(outs, ref):
    assert all(o["jax_modules"] == [] for o in outs)
    assert [o["digest"] for o in outs] == [ref["digest"]] * 4
    for name, want in ref["arrays"].items():
        np.testing.assert_array_equal(outs[0]["arrays"][name], want,
                                      err_msg=name)


def _jax_build():
    """tests/test_parallel.py's 512-slot build on the JAX engine."""
    eng = JaxEngine(JaxConfig(**dataclasses.asdict(R.small_cfg(512))))
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, JaxDiplomacy.WAR)
    rng = np.random.default_rng(0)
    a = eng.spawn_batch((rng.random((64, 2)) * 100 + 50).astype(np.float32),
                        faction=0, max_speed=40.0)
    eng.spawn_batch((rng.random((64, 2)) * 100 + 250).astype(np.float32),
                    faction=1)
    eng.move(a, (300.0, 300.0))
    return eng


def test_sharded_engine_runs_and_matches_single_device(tmp_path):
    """512 slots over 4 ranks for 30 frames: every rank's state is the
    single-device port's; the single-device port follows the JAX engine."""
    outs, ref = _sharded_and_reference(tmp_path, "tick", False)
    _assert_bit_equal(outs, ref)
    assert {o["transport"] for o in outs} == {"gloo"}
    assert [o["k1_rows"] for o in outs] == [(0, 128), (128, 256),
                                            (256, 384), (384, 512)]
    plan = outs[0]["plan"]
    assert plan["ents.pos"] == "ents" and plan["nav.blockers"] == "repl"
    assert not outs[0]["hook"]

    jeng = _jax_build()
    jeng.step(30)
    jp = np.asarray(jeng.state.ents.pos)
    tp = ref["arrays"]["ents.pos"]
    d = np.linalg.norm(tp - jp, axis=1)
    assert np.isfinite(tp).all()
    assert d.mean() < 0.5 and d.max() < 4.0, d
    np.testing.assert_allclose(ref["arrays"]["ents.hp"],
                               np.asarray(jeng.state.ents.hp))
    assert (ref["arrays"]["ents.pos"] != R.build("tick")[0]
            .state.ents.pos.numpy()).any(), "nobody moved"


def test_map_sharded_tick_matches_replicated_at_16k(tmp_path):
    """16,384 slots, map row-sharded over 4 ranks, 12 frames: positions,
    hp, fog and blockers bit-equal to the single-device port, and the
    plan bands the grids."""
    outs, ref = _sharded_and_reference(tmp_path, "map16k", True)
    _assert_bit_equal(outs, ref)
    plan = outs[0]["plan"]
    assert plan["ents.pos"] == "ents"
    assert plan["nav.blockers"] == "rows" and plan["fog.state"] == "rows"
    assert plan["fields.global_flow"] == "rows"
    assert plan["factions.diplomacy"] == "repl"
    assert (ref["arrays"]["nav.blockers"] > 0).any()
    assert outs[0]["hook"]


def test_sharded_field_integration_matches_single_device(tmp_path):
    """The 128x128 band integrator on 8 ranks against JAX's sharded
    integrator on 8 virtual devices and ``ff.integrate``, and equal to the
    port's ``integrate_plain``."""
    h = w = 128
    rng = np.random.default_rng(5)
    cost = np.ones((h, w), np.uint8)
    cost[rng.random((h, w)) < 0.2] = COST_IMPASSABLE
    cost[64, 64] = 1
    seeds = np.zeros((h, w), bool)
    seeds[64, 64] = True

    outs = _ranks(tmp_path, R.run_integrate, 8, cost, seeds)
    got = outs[0]["field"]
    for o in outs[1:]:
        np.testing.assert_array_equal(o["field"], got)
    plain = integrate_plain(torch.from_numpy(cost), torch.from_numpy(seeds),
                            max_iters=4 * h).numpy()
    np.testing.assert_array_equal(got, plain)

    ref = np.asarray(jff.integrate(jnp.asarray(cost), jnp.asarray(seeds),
                                   max_iters=4 * h))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("rows",))
    jgot = np.asarray(jax_sharded_integrate(mesh, h, w)(
        jnp.asarray(cost), jnp.asarray(seeds)))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-4)
    assert (got < 1e29).sum() > 0.5 * h * w
    assert outs[0]["counters"]["halo"]["calls"] == outs[0]["stats"]["sweeps"] + 1


def test_sharded_engine_seek_field_builds_row_sharded(tmp_path):
    """A map-sharded engine builds the seek field through the band
    integrator, equal to the single-device port's build."""
    outs, ref = _sharded_and_reference(tmp_path, "seek", True)
    _assert_bit_equal(outs, ref)
    assert ref["engine"].nav.sharded_integrate is None
    assert not outs[0]["hook_before"] and outs[0]["hook"]
    assert all(o["band_stats"]["calls"] == 1 for o in outs)
    assert (ref["arrays"]["fields.global_flow"] != 0).any(), "no field built"
    fid = outs[0]["flock"][outs[0]["hunter_slot"]]
    assert outs[0]["global_slot"][fid] >= 0


def test_sharded_tick_collective_inventory(tmp_path):
    """The exchange JAX's HLO test finds: the entity-sharded tick
    all-gathers entity columns; map sharding adds halo exchanges (the
    banded whole-map field) beside the all-gathers."""
    outs = _ranks(tmp_path, R.run_inventory, 4)
    for o in outs:
        assert o["sharded"]["all_gather"]["calls"] > 0, "entity exchange missing"
        assert o["sharded"]["halo"]["calls"] == 0
        assert o["map_sharded"]["halo"]["calls"] > 0, "grid halo missing"
        assert o["map_sharded"]["all_gather"]["calls"] > 0
        assert o["map_sharded"]["all_reduce"]["calls"] > 0


_NO_JAX = """
import sys
sys.path.insert(0, "tests")
import torch_parallel_ranks as R
import permafrost_engine_tpu_torch.parallel as P
ranks = P.spawn(R.run_imports, 2, device="cpu", timeout_s=120, threads=1)
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "permafrost_engine_tpu"))
assert not bad and ranks == [[], []], (bad, ranks)
print("ok")
"""


def test_parallel_and_ranks_import_no_jax():
    """A fresh interpreter imports the parallel package and spawns two rank
    programs; neither it nor a rank loads jax, jaxlib, flax or anything of
    the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_spawn_fails_a_rank_that_raises(tmp_path):
    """A rank that raises fails the call, and no rank outlives it."""
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        _ranks(tmp_path, R.run_raising, 2)


def test_spawn_stops_ranks_that_hang(tmp_path):
    """A rank that never returns is stopped at the timeout, which fails
    the call."""
    with pytest.raises(RuntimeError, match="did not finish"):
        spawn(R.run_hanging, 2, device="cpu", timeout_s=8.0, threads=1,
              store_dir=str(tmp_path), log=lambda _m: None)
