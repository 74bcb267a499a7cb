"""The readers of the program's spans (``benchmark/metrics/frame_wait_ms``,
``order_wait_ms``, ``order_plan_ms``, ``order_install_ms``,
``cadence_wait_ms``, ``cadence_work_ms``): each, on a window's counter
deltas, gives its ratio, and None where its counters are absent (a
program without the spans) or its count is 0; ``BENCHMARK.json`` holds
their entries with the cells, source and metric moved that they are
for."""

import pytest

from benchmark.spec import Spec, reader

COUNTERS = {
    "step.n": 200.0, "step.ms": 3400.0, "step.wait_ms": 500.0,
    "order.n": 16.0, "order.ms": 480.0, "order.wait_ms": 32.0,
    "order.plan.ms": 200.0, "order.plan.wait_ms": 8.0,
    "order.install.ms": 160.0, "order.install.wait_ms": 0.0,
    "cadence.n": 10.0, "cadence.ms": 1800.0, "cadence.wait_ms": 1400.0,
}


def _m(counters, frames=250):
    return {"window": {"frames": frames, "counters": dict(counters)}}


@pytest.mark.parametrize("name,want", [
    ("frame_wait_ms.frame", 500.0 / 250),
    ("frame_wait_ms.combined", 500.0 / 250),
    ("order_wait_ms", 32.0 / 16),
    ("order_wait_ms.combined", 32.0 / 16),
    ("order_plan_ms", (200.0 - 8.0) / 16),
    ("order_plan_ms.combined", (200.0 - 8.0) / 16),
    ("order_install_ms", 160.0 / 16),
    ("order_install_ms.combined", 160.0 / 16),
    ("cadence_wait_ms.scan", 1400.0 / 10),
    ("cadence_work_ms.scan", (1800.0 - 1400.0) / 10),
])
def test_reader_gives_its_ratio(name, want):
    assert reader(name)(_m(COUNTERS)) == pytest.approx(want)


@pytest.mark.parametrize("name,count", [
    ("frame_wait_ms.frame", "step.n"),
    ("order_wait_ms", "order.n"),
    ("order_plan_ms", "order.n"),
    ("order_install_ms", "order.n"),
    ("cadence_wait_ms.scan", "cadence.n"),
    ("cadence_work_ms.scan", "cadence.n"),
])
def test_reader_finds_nothing_without_its_counters(name, count):
    read = reader(name)
    # the parent program: the window's counters hold no span keys
    assert read(_m({"blk_snapshot_ms": 3.0})) is None
    assert read(_m(dict(COUNTERS, **{count: 0.0}))) is None


def test_reader_without_the_part_span_finds_nothing():
    c = {k: v for k, v in COUNTERS.items() if not k.startswith("order.plan")}
    assert reader("order_plan_ms")(_m(c)) is None
    assert reader("order_wait_ms")(_m(c)) == pytest.approx(2.0)


def test_benchmark_json_holds_the_span_metrics():
    spec = Spec.load()
    per = {m["name"]: m for m in spec.doc["per_layer"]}
    frame, comb = ["flat.contact.frame"], ["combined.contact.frame"]
    scans = ["combined.contact.scan", "flat.contact.scan"]
    want = {
        "frame_wait_ms.frame": (frame, "frame_ms"),
        "frame_wait_ms.combined": (comb, "frame_ms_p99"),
        "order_wait_ms": (frame, "order_ms_mean"),
        "order_wait_ms.combined": (comb, "frame_ms_p99"),
        "order_plan_ms": (frame, "order_ms_mean"),
        "order_plan_ms.combined": (comb, "frame_ms_p99"),
        "order_install_ms": (frame, "order_ms_mean"),
        "order_install_ms.combined": (comb, "frame_ms_p99"),
        "cadence_wait_ms.scan": (scans, "sim_fps"),
        "cadence_work_ms.scan": (scans, "sim_fps"),
    }
    for name, (cells, moves) in want.items():
        m = per[name]
        assert (m["workloads"], m["moves"], m["source"], m["unit"]) == (
            cells, moves, "program_span", "ms"), name
        for w in cells:
            assert m in spec.metrics(spec.workload(w), True)
