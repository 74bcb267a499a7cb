"""A run of the harness at a tiny size on the CPU, past its look for a
card: one last line on standard output with the result's keys."""

import json

import pytest

from benchmark import run
from benchmark.tests.tiny import TinySpec, use_tiny, workload

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.mark.parametrize("kind,trace", [("scan", 0), ("frame", 0),
                                            ("frame", 1), ("coldorders", 1)])
def test_a_cpu_run_prints_one_result_line(monkeypatch, capsys, kind,
                                          trace):
    use_tiny(monkeypatch)
    rc = run.report(TinySpec(), workload(kind), seed=2 ** 31 + 12345,
                    seconds=0.5, trace=bool(trace), device="cpu")
    assert rc == 0
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert KEYS <= set(last) and list(last)[-1] == "checks"
    assert last["correct"] is True, last["checks"]
    assert last["device"]["platform"] == "cpu"
    assert "setup_s" in last["metrics"] or trace
    for name, v in last["checks"].items():
        assert f"check {name}:" in out.err
    assert out.err.strip().splitlines()[-1].startswith("check ")
    if kind == "frame" and not trace:
        assert {"frame_ms", "frame_ms_p99", "order_ms_mean",
                "setup_s"} <= set(last["metrics"])
        assert last["attempted"] > 0
    if kind == "coldorders":
        assert {"order_ms_mean.cold", "field_cache_hit_pct.cold",
                "frame_ms.cold"} <= set(last["metrics"])


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "permafrost_engine_tpu_torch_extra",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                        types.ModuleType("x"))
    assert run.forbidden_modules() == ["jaxlib"]


def test_a_generator_extends_the_hooks_and_a_march_need_not_reach_contact(
        monkeypatch):
    """A later mix's generator subclasses ``contact.Cell``: its hooks run
    around every call of the engine's stepping, and a march with
    ``until_death`` false ends after its frames, with or without a
    death."""
    from benchmark.generators import contact
    from benchmark.tests.tiny import CONF, traffic

    use_tiny(monkeypatch)
    calls = []

    class Cell(contact.Cell):
        def before_call(self, n):
            super().before_call(n)
            calls.append(("before", n))

        def after_call(self, n):
            super().after_call(n)
            calls.append(("after", n))

    tr = dict(traffic("scan"), waves=None,
              march={"chunk_frames": 30, "min_frames": 30,
                     "until_death": False, "max_frames": 30,
                     "thicken_frames": 0})
    cell = Cell(CONF, tr, 5, "cpu")
    cell.setup()
    assert cell.split["frames_marched"] == 30
    win = cell.window(0.2)
    assert win["frames"] > 0 and calls
    assert calls[:2] == [("before", 60), ("after", 60)]


def test_reinforcements_rally_in_one_flock_a_side(monkeypatch):
    """Every wave orders a side's new units with its living earlier
    reinforcements, so each side's reinforcements share one flock (one
    nav layer on the tiny map) however many waves come."""
    from benchmark.generators import contact
    from benchmark.tests.tiny import CONF, traffic

    use_tiny(monkeypatch)
    cell = contact.Cell(CONF, dict(traffic("scan"), call_frames=30,
                                   waves={"period_frames": 30}), 9, "cpu")
    cell.setup()
    cell.drive(600)
    assert len(cell.wave_log) >= 10 and sum(map(sum, cell.wave_log)) > 0
    flock = cell.eng.ents_host("flock")["flock"]
    for side in (0, 1):
        uids = [u for v in cell.reinforcements[side].values() for u in v
                if u in cell.eng.uid_to_slot]
        assert len({int(flock[cell.eng.uid_to_slot[u]]) for u in uids}) <= 1
