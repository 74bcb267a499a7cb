"""The reader of the game loop's graph share (``benchmark/metrics/
tick_graph_pct``): ``tick.graph_frames`` over it and
``tick.eager_frames``, in %, from a window's counter deltas; None where
the program has neither counter (a program that does not count them);
``BENCHMARK.json`` holds its two entries, one per frame cell."""

import pytest

from benchmark.spec import Spec, reader
from benchmark.tests.tiny import TinySpec, use_tiny, workload

NAMES = ["tick_graph_pct.frame", "tick_graph_pct.combined"]


def _m(counters, frames=250):
    return {"window": {"frames": frames, "counters": dict(counters)}}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("counters,want", [
    ({"tick.graph_frames": 250.0}, 100.0),
    ({"tick.graph_frames": 150.0, "tick.eager_frames": 50.0}, 75.0),
    ({"tick.eager_frames": 250.0}, 0.0),
    ({"tick.graph_frames": 0.0, "tick.eager_frames": 0.0}, None),
    ({"step.n": 250.0, "step.ms": 4000.0}, None),
], ids=["graphed", "mixed", "eager", "no_frames", "no_counters"])
def test_reader_gives_the_graphed_share(name, counters, want):
    got = reader(name)(_m(counters))
    assert got == (None if want is None else pytest.approx(want))


def test_reader_reads_a_recorded_frame_window(monkeypatch):
    """A tiny frame cell's window on the CPU: every ``step(1)`` goes through
    the segment stepper (100%); with ``micro_batching`` off none does."""
    use_tiny(monkeypatch)
    spec, wl = TinySpec(), workload("frame")
    cell = spec.generator(wl)(spec.config(wl), spec.traffic(wl),
                              2 ** 31 + 777, "cpu")
    cell.setup()
    read = reader("tick_graph_pct.frame")
    win = cell.window(0.3)
    assert win["frames"] > 0
    assert read({"window": win}) == pytest.approx(100.0)
    cell.eng.micro_batching = False
    assert read({"window": cell.window(0.3)}) == pytest.approx(0.0)


def test_benchmark_json_holds_the_graph_share():
    per = {m["name"]: m for m in Spec.load().doc["per_layer"]}
    want = {"tick_graph_pct.frame": (["flat.contact.frame"], "frame_ms"),
            "tick_graph_pct.combined": (["combined.contact.frame"],
                                        "frame_ms_p99")}
    for name, (cells, moves) in want.items():
        m = per[name]
        assert m["workloads"] == cells and m["moves"] == moves
        assert m["unit"] == "%" and m["better"] == "higher"
        assert m["source"] == "program_counter"
        assert m["layer"] == per["engine_host_ms.frame"]["layer"]
