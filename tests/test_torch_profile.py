"""PyTorch port vs the JAX package: profiling (``core/perf.py``,
``Engine.profile_tick``, ``Engine.tick_cost_analysis``).

* ``profile_tick(60)`` on the same scene (``tests/test_torch_micro_step.py``'s
  squad at war with a second faction) in both engines: the same record
  keys, the same cadence classes (``move``, ``combat``, ``fog`` and their
  joins, ``base``) with the same frame counts per class and per half, and
  the same frame and tick advance afterwards; the drained events are equal.
* ``tick_cost_analysis`` counts positive operations and bytes, more bytes
  than the state holds, and leaves the engine as it was: state, frame,
  accumulator and the kernels' launch counters (a counting K1 wrapper
  stands in for the card's launches).
* ``Perf``: scopes nest, the engine's cadence counters are ``perf.counters``,
  and ``device_trace`` writes a Chrome trace.
"""

import dataclasses
import json
import os

import numpy as np
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core.config import DiplomacyState
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu_torch.core.config import EngineConfig
from permafrost_engine_tpu_torch.core.perf import OpCounter, Perf
from permafrost_engine_tpu_torch.game import step as step_mod
from permafrost_engine_tpu_torch.game.engine import Engine
from permafrost_engine_tpu_torch.ops import crowd_cuda, flowfield_cuda
from permafrost_engine_tpu_torch.state.convert import state_to_numpy
from permafrost_engine_tpu_torch.state.schema import state_byte_size
from test_micro_step import small_cfg, walled_cost

_TIMES = ("ms_p50", "ms_max", "ms_mean", "repeat_spread_pct",
          "tick_flops_upper", "tick_hbm_bytes_upper", "mfu_upper_pct")


def _scene(kind):
    cfg = small_cfg()
    if kind == "jax":
        eng = JaxEngine(cfg, cost_base=walled_cost(cfg))
    else:
        eng = Engine(EngineConfig(**dataclasses.asdict(cfg)), device="cpu",
                     cost_base=walled_cost(cfg))
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(0)
    a = eng.spawn_batch((np.array([400.0, 100.0]) + rng.random((8, 2)) * 30
                         ).astype(np.float32), faction=0, max_speed=80.0)
    eng.spawn_batch((np.array([420.0, 160.0]) + rng.random((6, 2)) * 20
                     ).astype(np.float32), faction=1, is_ranged=True,
                    attack_range=40.0)
    assert eng.move(a, (400.0, 400.0))
    eng.step(7)
    return eng


def _shape(stats: dict) -> dict:
    """profile_tick's record without its measured numbers."""
    out = {k: v for k, v in stats.items() if k not in _TIMES}
    out["classes"] = {k: (c["n"], c["ms_p50_h1"] is None,
                          c["ms_p50_h2"] is None)
                      for k, c in stats["classes"].items()}
    return out


def test_profile_tick_keys_and_classes_match_jax():
    jeng, teng = _scene("jax"), _scene("port")
    jstats, tstats = jeng.profile_tick(60), teng.profile_tick(60)
    assert _shape(tstats) == _shape(jstats)
    assert set(tstats["classes"]) >= {"move", "move+combat", "fog", "base"}
    assert {"tick_flops_upper", "tick_hbm_bytes_upper",
            "mfu_upper_pct"} <= tstats.keys()
    assert tstats.keys() == jstats.keys() | {"mfu_upper_pct",
                                             "tick_flops_upper",
                                             "tick_hbm_bytes_upper"}
    assert teng._frame == jeng._frame == 7 + 61
    assert teng.state.tick == int(jeng.state.tick)
    assert teng.events == jeng.events
    assert teng.perf.counters["device_tick_exact_ms_p50"] == tstats["ms_p50"]
    # the engine steps on after the probe as the JAX engine does
    jeng.step(30)
    teng.step(30)
    assert teng.events == jeng.events


def test_tick_cost_analysis_leaves_the_engine_unchanged(monkeypatch):
    eng = _scene("port")
    hrvo = step_mod.hrvo_select

    def counted(*args, **kw):
        crowd_cuda.launches += 1       # as the kernel's wrapper on the card
        return hrvo(*args, **kw)

    monkeypatch.setattr(step_mod, "hrvo_select", counted)
    monkeypatch.setattr(crowd_cuda, "launches", 5)
    monkeypatch.setattr(flowfield_cuda, "launches_chunk", 7)
    eng.step(5)
    assert crowd_cuda.launches > 5, "the counting wrapper is on the path"
    before = (state_to_numpy(eng.state), eng._frame, eng.state.tick,
              {k: v.clone() for k, v in vars(eng._acc).items()},
              crowd_cuda.launches, flowfield_cuda.launches_chunk)
    cost = eng.tick_cost_analysis(2.0)
    after = (state_to_numpy(eng.state), eng._frame, eng.state.tick,
             vars(eng._acc), crowd_cuda.launches,
             flowfield_cuda.launches_chunk)
    assert cost["tick_flops_upper"] > 0
    assert cost["tick_hbm_bytes_upper"] > state_byte_size(eng.state.ents)
    assert cost["mfu_upper_pct"] > 0
    assert after[1:3] == before[1:3] and after[4:] == before[4:]
    for name, t in before[3].items():
        assert torch.equal(t, after[3][name]), name

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}.")
            else:
                yield prefix + k, np.asarray(v)

    b, a = dict(flat(before[0])), dict(flat(after[0]))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # every substep gate fires in the counted tick: it costs more than a
    # frame with no substep, counted the same way
    idle = OpCounter()
    with idle:
        torch.zeros(4) + 1
    assert cost["tick_flops_upper"] > 1000 * idle.ops


def test_op_counter_counts_matmuls_reductions_and_views():
    c = OpCounter()
    a, b = torch.ones(4, 8), torch.ones(8, 3)
    with c:
        a @ b                  # 2 * 4 * 3 * 8
        a.sum()                # 32 inputs
        a.view(32)             # a view: nothing
        a * 2.0                # 32 outputs
    assert c.ops == 192 + 32 + 32
    assert c.bytes == 4 * (32 + 24 + 12) + 4 * (32 + 1) + 4 * (32 + 32)


def test_perf_scopes_counters_and_trace(tmp_path):
    p = Perf()
    p.begin_tick()
    with p.scope("outer"):
        with p.scope("inner"):
            torch.ones(3).sum()
    p.begin_tick()
    assert [(e["name"], e["parent"]) for e in p.prev_frame_perfstats()] == [
        ("outer", -1), ("inner", 0)]
    assert "  inner: " in p.report_tree()
    eng = Engine(EngineConfig(**dataclasses.asdict(small_cfg())),
                 device="cpu")
    assert eng.counters is eng.perf.counters
    assert eng.counters["blk_update_ms"] == 0.0
    with p.device_trace(str(tmp_path / "trace")):
        torch.ones(8).cumsum(0)
    with open(os.path.join(tmp_path, "trace", "trace.json")) as f:
        assert json.load(f)["traceEvents"]
