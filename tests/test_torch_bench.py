"""PyTorch port vs the JAX package: the benchmark.

The repository's ``bench.py`` (loaded with importlib; the compilation-cache
settings and the import path it changes at import are put back at once, and
its ``mapgen`` is this checkout's ``tools/mapgen.py``) against the port's
``permafrost_engine_tpu_torch.bench`` on the CPU, the JAX ``Engine``'s
``prewarm_nav`` patched to a no-op, as its docstring says tests do:

* ``build_battle(48, terrain=True, full=True)`` and ``build_battle(48)``:
  every entity column, the flock table, the field slabs and the nav slot
  mirrors equal after the build (tolerance: none); then 60 frames of
  ``step``, positions within ``tests/test_torch_engine.py``'s tolerance (a
  mean distance under 0.5 world units and a maximum under 4);
* ``alive_count``, ``overlap_fraction`` and ``_class_spread`` equal on the
  same entity columns and profile dicts;
* ``measure_rebuild``: the integrations and flow directions each bench
  computes, recorded call by call, take equal inputs and give bit-equal
  outputs, and the JAX bench's inputs through the port's path give the JAX
  outputs bit for bit;
* the port's ``main(["--cpu"])`` at lowered sizes prints a ``bench
  detail:`` line and, last, one JSON line under 2,048 characters with the
  JAX bench's keys (``relay_rtt_floor_ms_*`` renamed ``sync_rtt_floor_ms_*``);
* a fresh interpreter that imports the port's bench loads no module of JAX
  or of the JAX package; without a CUDA device and without ``--cpu``,
  ``main`` exits non-zero.
"""

import importlib.util
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core.config import CombatState
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu.ops import flowfield as jff
from permafrost_engine_tpu_torch import bench as tbench
from permafrost_engine_tpu_torch.ops import flowfield as tff
from permafrost_engine_tpu_torch.ops import flowfield_cuda
from permafrost_engine_tpu_torch.state.convert import state_to_numpy

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 48                       # units a side in the parity builds
STEP_FRAMES = 60
POS_MEAN, POS_MAX = 0.5, 4.0     # tests/test_torch_engine.py's tolerance
LINE_MAX = 2048

# bench.py's keys: main's line (bench.py:472-492), run_battle's dict
# (bench.py:364-383) and measure_render's (bench.py:445-454)
TOP_KEYS = {"metric", "value", "unit", "vs_baseline", "flat_map_worst_phase_fps",
            "sync_rtt_floor_ms_start", "sync_rtt_floor_ms_end", "obstacle",
            "flat", "flow_field_rebuild_ms_p50",
            "flow_field_rebuild_ms_per_chunk_batched", "rebuild_vs_2ms_target",
            "render"}
BATTLE_KEYS = {"fps_min", "fps_march", "fps_contact", "fps_contact_scan",
               "fps_late", "alive_after_march", "alive_after_contact",
               "overlap_frac_contact", "alive_at_end", "frames_to_contact",
               "tick_ms_amortized", "tick_classes", "tick_classes_rerun",
               "tick_rerun_spread_pct", "tick_flops_upper",
               "tick_hbm_bytes_upper", "mfu_upper_pct", "nav_stats"}
RENDER_KEYS = {"resolution", "render_ms_p50", "render_fps", "render_ms_p90",
               "sim_plus_render_fps_dec4", "first_frame_compile_s", "scene"}


def _load(name: str, *path: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_jax_bench():
    """The root bench.py as a module, with the two JAX settings and the
    import path it changes at import restored, so later tests in this
    process are unaffected."""
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {n: getattr(jax.config, n) for n in names}
    saved_path = list(sys.path)
    try:
        return _load("_root_bench", "bench.py")
    finally:
        sys.path[:] = saved_path
        for n, v in saved.items():
            jax.config.update(n, v)


jbench = _load_jax_bench()
# bench.py imports `mapgen` from a tools/ it puts on the import path: this
# checkout's, found in sys.modules whatever the path holds
MAPGEN = _load("mapgen", "tools", "mapgen.py")


SCENES = {"obstacle_full": dict(terrain=True, full=True),
          "flat": dict(terrain=False)}


@pytest.fixture(scope="module")
def battles():
    """Per scene: the host states right after both builds, then both
    engines after STEP_FRAMES frames of ``step``. bench.py's build imports
    ``mapgen`` (this checkout's ``tools/mapgen.py``, from sys.modules; the
    entry it adds to the import path is dropped after) and compiles the nav
    kernels in ``prewarm_nav`` (skipped)."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "mapgen", MAPGEN)
        mp.setattr(sys, "path", list(sys.path))
        mp.setattr(JaxEngine, "prewarm_nav", lambda self: None)
        for name, kw in SCENES.items():
            jeng = jbench.build_battle(N, **kw)
            teng = tbench.build_battle(N, device="cpu", **kw)
            # state_to_numpy's arrays are views of the CPU tensors: copy
            tstate = {c: {k: np.array(v) for k, v in state_to_numpy(
                teng.state)[c].items()} for c in ("ents", "flocks", "fields")}
            built = (jax.device_get(jeng.state), tstate,
                     (jeng.nav.slot_mirror.copy(), jeng.nav.los_mirror.copy()),
                     (teng.nav.slot_mirror.copy(), teng.nav.los_mirror.copy()))
            jeng.step(STEP_FRAMES)
            teng.step(STEP_FRAMES)
            out[name] = (built, jeng, teng)
    return out


@pytest.mark.parametrize("scene", list(SCENES))
def test_build_battle_equal(battles, scene):
    (jstate, tstate, jmirrors, tmirrors), jeng, teng = battles[scene]
    for comp in ("ents", "flocks", "fields"):
        jc = getattr(jstate, comp)
        for name, got in tstate[comp].items():
            np.testing.assert_array_equal(got, np.asarray(getattr(jc, name)),
                                          err_msg=f"{comp}.{name}")
    for got, want in zip(tmirrors, jmirrors):
        np.testing.assert_array_equal(got, want)
    assert teng.uid_to_slot == jeng.uid_to_slot
    n_alive = int(tstate["ents"]["alive"].sum())
    assert n_alive == 2 * N
    if SCENES[scene].get("full"):
        assert tstate["ents"]["has_formation_cell"].sum() > N
        assert (tmirrors[0] >= 0).any()


@pytest.mark.parametrize("scene", list(SCENES))
def test_battle_positions_close(battles, scene):
    _, jeng, teng = battles[scene]
    jh = jax.device_get(jeng.state.ents)
    th = teng.ents_host("pos", "alive")
    live = np.asarray(jh.alive)
    np.testing.assert_array_equal(th["alive"], live)
    d = np.linalg.norm(th["pos"][live] - np.asarray(jh.pos)[live], axis=1)
    assert np.isfinite(th["pos"]).all()
    assert d.mean() < POS_MEAN and d.max() < POS_MAX, (d.mean(), d.max())
    assert teng._frame == jeng._frame == STEP_FRAMES


def _columns(scene_state, crowd: bool):
    """Host entity columns of a stepped JAX state; with `crowd`, some units
    moved onto their neighbours and some marked corpses."""
    cols = {k: np.array(getattr(scene_state, k))
            for k in ("alive", "combatstate", "pos", "radius")}
    if crowd:
        slots = np.flatnonzero(cols["alive"])
        cols["pos"][slots[1:20:2]] = cols["pos"][slots[0:19:2]] + 0.1
        cols["combatstate"][slots[40:50]] = int(CombatState.CORPSE)
    return cols


@pytest.mark.parametrize("crowd", [False, True])
@pytest.mark.parametrize("scene", list(SCENES))
def test_alive_and_overlap_equal(battles, scene, crowd):
    _, jeng, _ = battles[scene]
    cols = _columns(jax.device_get(jeng.state.ents), crowd)
    jax_view = types.SimpleNamespace(
        state=types.SimpleNamespace(ents=types.SimpleNamespace(**cols)))
    port_view = types.SimpleNamespace(
        ents_host=lambda *names: {n: cols[n].copy() for n in names})
    assert tbench.alive_count(port_view) == jbench.alive_count(jax_view) == 2 * N
    got = tbench.overlap_fraction(port_view)
    assert got == jbench.overlap_fraction(jax_view)
    assert (got > 0) == crowd


def _cls(p50, n):
    return {"ms_p50": p50, "n": n}


SPREADS = {
    "two_classes": ({"classes": {"move": _cls(2.0, 20), "base": _cls(1.0, 30)}},
                    {"classes": {"move": _cls(2.5, 20), "base": _cls(1.1, 30)}}),
    "few_frames": ({"classes": {"move": _cls(2.0, 5)}},
                   {"classes": {"move": _cls(9.0, 20)}}),
    "missing_class": ({"classes": {"fog": _cls(3.0, 6), "move": _cls(2.0, 6)}},
                      {"classes": {"move": _cls(2.0, 6)}}),
    "no_classes": ({"classes": None}, {}),
    "zero_p50": ({"classes": {"base": _cls(0.0, 8)}},
                 {"classes": {"base": _cls(0.0, 8)}}),
}


@pytest.mark.parametrize("case", list(SPREADS))
def test_class_spread_equal(case):
    a, b = SPREADS[case]
    assert tbench._class_spread(a, b) == jbench._class_spread(a, b)


def _recorder(calls, fn, to_np):
    def run(*args, **kw):
        out = fn(*args, **kw)
        calls.append(([to_np(a) for a in args], to_np(out)))
        return out
    return run


def test_measure_rebuild_fields_equal(monkeypatch):
    """bench.py takes its cost grid with ``jnp.asarray`` and then sets the
    21 seed tiles passable in the numpy array. On the TPU the transfer
    copies; JAX on the CPU may alias a suitably aligned numpy buffer, so
    the later writes would show through in some runs and not others. The
    copy is made explicit here, as the port makes it."""
    asarray = jax.numpy.asarray
    monkeypatch.setattr(jax.numpy, "asarray", lambda a, *args, **kw: asarray(
        np.array(a) if isinstance(a, np.ndarray) else a, *args, **kw))
    jcalls = {"integrate": [], "flow_dirs": []}
    tcalls = {"integrate": [], "flow_dirs": []}
    for k in jcalls:
        monkeypatch.setattr(jff, k, _recorder(jcalls[k], getattr(jff, k),
                                              np.asarray))
    monkeypatch.setattr(flowfield_cuda, "integrate", _recorder(
        tcalls["integrate"], flowfield_cuda.integrate, lambda t: t.numpy()))
    monkeypatch.setattr(tff, "flow_dirs", _recorder(
        tcalls["flow_dirs"], tff.flow_dirs, lambda t: t.numpy()))
    jres = jbench.measure_rebuild()
    tres = tbench.measure_rebuild("cpu")
    assert all(np.isfinite(v) and v > 0 for v in jres + tres)
    # a warm-up and 21 single chunks, a warm-up and 5 batches of 64
    for k in jcalls:
        assert len(tcalls[k]) == len(jcalls[k]) == 28, k
        for i, ((targs, tout), (jargs, jout)) in enumerate(
                zip(tcalls[k], jcalls[k])):
            for t, j in zip(targs, jargs):
                np.testing.assert_array_equal(t, j, err_msg=f"{k} {i} input")
            np.testing.assert_array_equal(tout, jout, err_msg=f"{k} {i}")
    assert jcalls["integrate"][-1][0][0].shape == (64, 64, 64)
    # the JAX bench's own inputs through the port's path (one single chunk
    # and the batch)
    for i in (1, 27):
        (cost, seed), integ = jcalls["integrate"][i]
        cost, seed = torch.tensor(cost), torch.tensor(seed)
        got = tff.flow_dirs(flowfield_cuda.integrate(cost, seed), cost)
        np.testing.assert_array_equal(got.numpy(), jcalls["flow_dirs"][i][1])
        assert (integ < 1e30).sum() > 1000


SMALL = dict(N_PER_SIDE=8, FF_MAX_FRAMES=6, FF_CHUNK=6, RENDER_W=160,
             RENDER_H=96, RENDER_ENTS=40, RENDER_FRAMES=2, RENDER_SIM_FRAMES=8,
             WARMUP_FRAMES=6, PHASE_WINDOWS=1, PHASE_FRAMES=6,
             THICKEN_FRAMES=6, PROFILE_FRAMES=12)


def test_main_prints_the_compact_line(monkeypatch, capsys):
    for k, v in SMALL.items():
        monkeypatch.setattr(tbench, k, v)
    out = tbench.main(["--cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    detail = [ln for ln in lines if ln.startswith("bench detail: ")]
    assert len(detail) == 1 and lines[-2] == detail[0]
    det = json.loads(detail[0][len("bench detail: "):])
    assert set(det) == {"obstacle", "flat"}
    for battle in det.values():
        assert set(battle) == set(tbench.DETAIL_KEYS)
        assert battle["nav_stats"]["requests"] > 0
    last = lines[-1]
    assert len(last) < LINE_MAX, len(last)
    line = json.loads(last)
    assert set(line) == TOP_KEYS
    for name in ("obstacle", "flat"):
        assert set(line[name]) == BATTLE_KEYS - set(tbench.DETAIL_KEYS)
        b = line[name]
        for k in ("fps_march", "fps_contact", "fps_contact_scan", "fps_late"):
            assert np.isfinite(b[k]) and b[k] > 0, (name, k)
        assert round(b["fps_min"], 2) == min(b["fps_march"], b["fps_contact"],
                                             b["fps_late"])
        # the obstacle battle's six buildings count as alive
        assert b["alive_at_end"] <= 2 * SMALL["N_PER_SIDE"] + 6
        assert b["frames_to_contact"] == 6 + 6 + 6
        assert b["tick_rerun_spread_pct"] == jbench._class_spread(
            {"classes": out[name]["tick_classes"]},
            {"classes": out[name]["tick_classes_rerun"]})
    assert set(line["render"]) == RENDER_KEYS
    assert line["render"]["resolution"] == "160x96"
    assert line["value"] == round(line["obstacle"]["fps_min"], 2)
    assert line["flat_map_worst_phase_fps"] == round(line["flat"]["fps_min"], 2)
    assert line["flow_field_rebuild_ms_p50"] > 0


def test_import_loads_no_jax():
    code = ("import sys; import permafrost_engine_tpu_torch.bench; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'permafrost_engine_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         env=dict(os.environ, PYTHONPATH=_REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_no_device_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        tbench.main([])
    assert exc.value.code not in (0, None)
    cap = capsys.readouterr()
    assert "no CUDA device" in cap.err and cap.out == ""


def test_jax_bench_load_leaves_the_process_as_it_was():
    names = ("jax_compilation_cache_dir",
             "jax_persistent_cache_min_compile_time_secs")
    path, conf = list(sys.path), {n: getattr(jax.config, n) for n in names}
    mod = _load_jax_bench()
    assert mod.build_battle.__module__ == "_root_bench"
    assert sys.path == path
    assert {n: getattr(jax.config, n) for n in names} == conf
