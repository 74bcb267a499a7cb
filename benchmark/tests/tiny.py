"""A cell at a size a CPU test can hold: a 1x1-chunk flat map, 12 units
a side 30 world units apart, 8-joint skinning, short contact and
windows. ``use_tiny(monkeypatch)`` moves the scene's spawn blocks and
goals onto that map and holds it to ``battle10k_combined``'s limits;
``TinySpec`` stands for ``BENCHMARK.json``."""

from __future__ import annotations

from benchmark import run, scene
from benchmark.spec import Spec

CONF = {"name": "tiny", "n_per_side": 12, "terrain": False, "full": False,
        "archer_share": 0.2, "arms": {},
        "engine": {"max_ents": 48, "chunks_r": 1, "chunks_c": 1,
                   "skin_joints": 8}}


def traffic(stepping: str) -> dict:
    scan = stepping == "scan"
    return {"generator": "contact", "stepping": stepping,
            "call_frames": 60 if scan else 1, "check_call_frames": 30,
            "march": {"chunk_frames": 60, "min_frames": 0,
                      "until_death": True, "max_frames": 3000,
                      "thicken_frames": 60},
            "warm_frames": 0 if scan else 30, "waves": {"period_frames": 60},
            "orders": None if scan else {
                "side": 0, "groups": 2, "period_frames": 15,
                "rally_points": 4, "front_radius": 60.0},
            "trace_frames": 30, "check_frames": 30}


class TinySpec(Spec):
    """The tiny cell under the name ``tiny.<stepping>``, with the
    metrics of the real ``BENCHMARK.json``."""

    def __init__(self):
        real = Spec.load()
        self.doc = real.doc

    def config(self, wl):
        return CONF

    def traffic(self, wl):
        return traffic(wl["traffic"])

    def metrics(self, wl, trace):
        group = self.doc["per_layer" if trace else "end_to_end"]
        kind = wl["traffic"]
        return [m for m in group if "workloads" not in m
                or any(w.endswith(kind) for w in m["workloads"])]


def workload(stepping: str) -> dict:
    return {"name": f"tiny.{stepping}", "config": "tiny", "traffic": stepping,
            "chips": 1, "why": "a CPU test"}


def use_tiny(monkeypatch) -> None:
    monkeypatch.setattr(scene, "ARM_BLOCKS", {
        "inf": ((100.0, 100.0, 4, 4.0, 3.0), (130.0, 100.0, 4, 4.0, 3.0))})
    monkeypatch.setattr(scene, "GOALS", ((150.0, 110.0), (90.0, 110.0)))
    real = run.load_limits
    monkeypatch.setattr(run, "load_limits",
                        lambda config: real("battle10k_combined"))
