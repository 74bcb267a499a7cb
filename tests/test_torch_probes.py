"""PyTorch port vs the JAX package: the probes (``tools/probe_*.py`` and
``permafrost_engine_tpu_torch/tools/probe_*.py``), on the CPU at small
sizes.

* overlap: ``probe_overlap`` at 32 units a side for 3 simulated seconds on
  both packages (the JAX probe loaded by file; the import path, the
  ``XLA_FLAGS`` and the JAX setting it changes at import are put back):
  each second's living count and overlap fraction equal, the median and
  largest overlap depth within 1e-3 (``tests/test_torch_entry_points.py``'s
  position tolerance);
* soak: a small battle built through the root ``bench.py`` and through the
  port's bench, the soak's ``step_scan`` windows on both: each window's
  faction alive counts and transient-dead count equal (the JAX probe's
  loop, here on the JAX engine), and the port's slot accounting holds;
* extend: the structure drop on a small obstacle battle, the JAX probe's
  ``window`` against the port's: each window's ``chunks_rebuilt`` and
  ``invalidations`` deltas equal; the port's commit split only in the
  drop's window, its timers removed after;
* ablation hygiene: every variant of both ablation probes for one frame
  from a snapshot taken where that frame runs every substep: the skipped
  functions are called 0 times and their stand-ins once, the others once,
  and every patched attribute is the original afterwards; the ``full``
  variant's frame equals ``Engine.step(1)`` from the same state, bit for
  bit;
* shard: 2 CPU ranks (gloo), 1,024 slots, 3 ticks (the third runs the
  movement substep): the map-sharded soak is bit-identical to one device,
  the sharded tick all-gathers, the map-sharded field exchanges halos and
  the replicated tick makes no collective (the port's form of
  ``tests/test_parallel.py::test_sharded_tick_hlo_has_expected_collectives``).

The probes' command lines, their last lines and their imports are
``tests/test_torch_probes_cli.py``'s.
"""

import dataclasses
import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core.config import CombatState
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu_torch import bench as tbench
from permafrost_engine_tpu_torch.tools import _probe_util as U
from permafrost_engine_tpu_torch.tools import probe_ablate as tablate
from permafrost_engine_tpu_torch.tools import probe_ablate_move as tablate_move
from permafrost_engine_tpu_torch.tools import probe_extend as textend
from permafrost_engine_tpu_torch.tools import probe_overlap as toverlap
from permafrost_engine_tpu_torch.tools import probe_shard as tshard
from permafrost_engine_tpu_torch.tools import probe_soak as tsoak

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPTH_ATOL = 1e-3      # tests/test_torch_entry_points.py's position tolerance
N = 8                  # units a side in the small battles
CACHE_SETTINGS = ("jax_compilation_cache_dir",
                  "jax_persistent_cache_min_compile_time_secs", "jax_platforms")


def _load(name: str, *path: str):
    """A file of this checkout as a module; the import path, ``XLA_FLAGS``
    and the JAX settings it changes at import are put back."""
    saved = {n: getattr(jax.config, n) for n in CACHE_SETTINGS}
    saved_path, saved_flags = list(sys.path), os.environ.get("XLA_FLAGS")
    try:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(_REPO, *path))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    finally:
        sys.path[:] = saved_path
        if saved_flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved_flags
        for n, v in saved.items():
            jax.config.update(n, v)


jbench = _load("_root_bench", "bench.py")
MAPGEN = _load("mapgen", "tools", "mapgen.py")


@pytest.fixture
def jax_builds(monkeypatch):
    """bench.py's builds as the tests run them: this checkout's ``mapgen``
    and no nav-kernel prewarm (as ``tests/test_torch_bench.py``)."""
    monkeypatch.setitem(sys.modules, "mapgen", MAPGEN)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(JaxEngine, "prewarm_nav", lambda self: None)


def test_jax_probe_loads_leave_the_process_as_it_was():
    path, flags = list(sys.path), os.environ.get("XLA_FLAGS")
    conf = {n: getattr(jax.config, n) for n in CACHE_SETTINGS}
    for name in ("probe_overlap", "probe_extend"):
        _load(f"_jax_{name}", "tools", f"{name}.py")
        assert sys.path == path and os.environ.get("XLA_FLAGS") == flags
        assert {n: getattr(jax.config, n) for n in CACHE_SETTINGS} == conf


# -- overlap --------------------------------------------------------------------

def test_overlap_matches_jax(monkeypatch, capsys):
    jov = _load("_jax_probe_overlap", "tools", "probe_overlap.py")
    want = []
    stats = jov.overlap_stats

    def record(eng):
        out = stats(eng)
        want.append(out + (int(np.asarray(eng.state.ents.alive).sum()),))
        return out

    monkeypatch.setattr(jov, "overlap_stats", record)
    monkeypatch.setattr(sys, "argv", ["probe_overlap", "--units", "32",
                                      "--seconds", "3"])
    jov.main()
    got = toverlap.main(["--cpu", "--units", "32", "--seconds", "3"])["seconds"]
    assert len(got) == len(want) == 3
    for g, (frac, dmed, dmax, alive) in zip(got, want):
        assert g["alive"] == alive and g["overlap_frac"] == frac, (g, want)
        assert abs(g["depth_med"] - dmed) <= DEPTH_ATOL, (g, dmed)
        assert abs(g["depth_max"] - dmax) <= DEPTH_ATOL, (g, dmax)
    assert want[-1][2] > 0, "the armies met"
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith('{"seconds":')


# -- soak -----------------------------------------------------------------------

SOAK_WINDOWS, SOAK_FRAMES, WARMUP = 3, 30, 6


def _jax_soak(eng) -> list:
    """``tools/probe_soak.py``'s loop on a JAX engine, each window's
    counts."""
    rows = []
    for _ in range(SOAK_WINDOWS):
        eng.step_scan(SOAK_FRAMES)
        ents = eng.state.ents
        alive, fac = np.asarray(ents.alive), np.asarray(ents.faction)
        assert np.isfinite(np.asarray(ents.pos)[alive]).all()
        trans = (alive & (np.asarray(ents.hp) <= 0)
                 & (np.asarray(ents.combatstate) != CombatState.CORPSE))
        if trans.any():
            eng.step(6)
        rows.append({"f0": int((alive & (fac == 0)).sum()),
                     "f1": int((alive & (fac == 1)).sum()),
                     "transient_dead": int(trans.sum())})
    return rows


def test_soak_matches_jax(jax_builds):
    jeng = jbench.build_battle(N)
    teng = tbench.build_battle(N, device="cpu")
    jeng.step(WARMUP)
    teng.step(WARMUP)
    want = _jax_soak(jeng)
    got = tsoak.soak(teng, SOAK_WINDOWS, SOAK_FRAMES, log=lambda m: None)
    assert got["windows"] == want
    assert got["live"] + got["free"] == got["max_ents"] == 2 * N + 256
    assert got["uids"] == got["live"] == 2 * N
    assert got["frames"] == jeng._frame == WARMUP + SOAK_WINDOWS * SOAK_FRAMES


def test_soak_raises_on_a_broken_invariant():
    eng = tbench.build_battle(N, device="cpu")
    eng._free_slots.pop()
    with pytest.raises(AssertionError, match="slots"):
        tsoak.soak(eng, 1, 1, log=lambda m: None)


# -- extend ---------------------------------------------------------------------

EXTEND_FRAMES = 6


def test_extend_matches_jax(jax_builds):
    jext = _load("_jax_probe_extend", "tools", "probe_extend.py")
    jeng = jbench.build_battle(N, terrain=True)
    teng = tbench.build_battle(N, terrain=True, device="cpu")
    jeng.step(WARMUP)
    teng.step(WARMUP)
    want = {"pre_drop": jext.window(jeng, EXTEND_FRAMES)}
    jbench.place_midfight_structures(jeng)
    for i in range(textend.POST_WINDOWS):
        want[f"post_drop_{i}"] = jext.window(jeng, EXTEND_FRAMES)
    got = textend.extend(teng, EXTEND_FRAMES)
    assert set(got) == set(want) | {"drop_ms"}
    for key, w in want.items():
        for stat in ("chunks_rebuilt", "invalidations"):
            assert got[key]["nav_stats"].get(stat, 0) == w["nav_stats"].get(
                stat, 0), (key, stat, got[key]["nav_stats"], w["nav_stats"])
    assert got["post_drop_0"]["nav_stats"]["chunks_rebuilt"] > 0
    assert got["post_drop_0"]["nav_stats"]["invalidations"] > 0
    # the commit's split, in the drop's window alone; the timers removed
    split = got["post_drop_0"]["commit_ms"]
    assert set(split) == {"commit", "recompute", "portal_relink",
                          "invalidate", "replan", "islands", "islands_n"}
    # the ground layer the replans walk is labelled once, inside them
    assert split["islands_n"] >= 1
    assert split["islands"] <= split["replan"] <= split["commit"]
    assert all(got[k]["commit_ms"] == {} for k in want if k != "post_drop_0")
    assert not {"_commit_nav", "_replan_flocks"} & set(vars(teng))
    assert not {"_recompute_effective", "islands"} & set(vars(teng.nav))
    assert textend.pt.update_portal_graph.__module__.endswith("nav.portals")


# -- ablation hygiene -------------------------------------------------------------

@pytest.fixture(scope="module")
def every_substep():
    """A small battle stepped until its next frame runs every substep
    (movement, combat, projectiles and fog: tick + 1 a multiple of 30), and
    a snapshot of its state there."""
    eng = tbench.build_battle(N, device="cpu")
    eng.step(29)
    assert (eng.state.tick + 1) % 30 == 0
    return eng, U.snapshot(eng.state)


ABLATIONS = [(tablate, name) for name, _ in tablate.VARIANTS] + [
    (tablate_move, name) for name, _ in tablate_move.VARIANTS]


@pytest.mark.parametrize("probe,variant", ABLATIONS,
                         ids=[f"{p.__name__.rsplit('.', 1)[1]}-{v}"
                              for p, v in ABLATIONS])
def test_ablation_variant_hygiene(every_substep, probe, variant):
    eng, snap = every_substep
    patches = dict(probe.VARIANTS)[variant]
    originals = {p: getattr(*p) for p in probe.POINTS}
    res = U.run_variants(eng, snap, [(variant, patches)], probe.POINTS,
                         frames=1, windows=1, warm=0, log=lambda m: None)
    r = res[variant]
    assert U.restored(probe.POINTS, originals)
    for mod, attr in probe.POINTS:
        label = U.label(mod, attr)
        if (mod, attr) in patches:
            assert r["calls"][label] == 0, label
            assert r["standin_calls"][label] == 1, label
        else:
            assert r["calls"][label] == 1, (label, r["calls"])
    assert r["k1_launches"] == 0 and np.isfinite(r["fps"])


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            yield prefix + f.name, v
        elif dataclasses.is_dataclass(v):
            yield from _leaves(v, prefix + f.name + ".")


def test_full_variant_frame_equals_engine_step(every_substep):
    eng, snap = every_substep
    graphs = U.make_graphs(eng)
    state, _ = graphs(U.snapshot(snap), 1, graphs.new_acc("cpu"))
    eng.state = U.snapshot(snap)
    eng.step(1)
    want = dict(_leaves(eng.state))
    assert state.tick == eng.state.tick
    for name, t in _leaves(state):
        assert torch.equal(t, want[name]), name


# -- shard ----------------------------------------------------------------------

def test_shard_collectives_and_bit_identity(capsys):
    out = tshard.main(["--cpu", "--ranks", "2", "--n-ents", "1024", "--ticks",
                       "3", "--soak-ents", "1024", "--soak-ticks", "3",
                       "--threads", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert set(out) == {"mesh_ranks", "transport", "mesh_note",
                        "collectives_by_mode", "soak_64k_map_sharded",
                        "k1_launches_per_rank"}
    assert out["mesh_ranks"] == 2 and out["transport"] == "gloo"
    soak = out["soak_64k_map_sharded"]
    assert soak["bit_identical"] and soak["differ"] == [], soak["differ"]
    modes = out["collectives_by_mode"]
    assert modes["replicated"]["total_calls"] == 0
    assert modes["sharded"]["collectives"]["all_gather"]["calls"] > 0
    assert modes["sharded"]["collectives"]["halo"]["calls"] == 0
    assert (modes["map_sharded"]["collectives"]["all_gather"]["calls"]
            > modes["sharded"]["collectives"]["all_gather"]["calls"])
    assert modes["map_sharded"]["field"]["collectives"]["halo"]["calls"] > 0
    assert all(m["memory_per_rank"] is None for m in modes.values())
    assert out["k1_launches_per_rank"] == [0, 0]
