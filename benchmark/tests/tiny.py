"""A cell at a size a CPU test can hold: a 1x1-chunk flat map, 12 units
a side 30 world units apart, 8-joint skinning, short contact and
windows. ``use_tiny(monkeypatch)`` moves the scene's spawn blocks and
goals onto that map and holds it to ``limits()``; ``TinySpec`` stands for
``BENCHMARK.json``."""

from __future__ import annotations

import json

from benchmark import run, scene
from benchmark.spec import Spec, limits_file

CONF = {"name": "tiny", "n_per_side": 12, "terrain": False, "full": False,
        "archer_share": 0.2, "arms": {},
        "engine": {"max_ents": 48, "chunks_r": 1, "chunks_c": 1,
                   "skin_joints": 8}}


def traffic(kind: str) -> dict:
    """The tiny mix of `kind`: ``scan`` or ``frame`` (``contact``'s), or
    ``coldorders`` (frame stepping with that generator's orders)."""
    if kind == "coldorders":
        return dict(traffic("frame"), generator="coldorders", orders={
            "side": 0, "groups": 2, "period_frames": 15})
    scan = kind == "scan"
    return {"generator": "contact", "stepping": kind,
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
    """The tiny cell under the name ``tiny.<kind>``, with the metrics of
    the real ``BENCHMARK.json`` whose cells' names hold the kind."""

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
                or any(kind in w.split(".") for w in m["workloads"])]


def workload(kind: str) -> dict:
    return {"name": f"tiny.{kind}", "config": "tiny", "traffic": kind,
            "chips": 1, "why": "a CPU test"}


def limits() -> dict:
    """The tiny cell's limits: ``benchmark/limits/battle10k_combined.json``
    less ``formation_cells_differ``, since the tiny battle gives no order
    in formation."""
    with open(limits_file("battle10k_combined")) as f:
        out = json.load(f)
    del out["formation_cells_differ"]
    return out


def use_tiny(monkeypatch) -> None:
    monkeypatch.setattr(scene, "ARM_BLOCKS", {
        "inf": ((100.0, 100.0, 4, 4.0, 3.0), (130.0, 100.0, 4, 4.0, 3.0))})
    monkeypatch.setattr(scene, "GOALS", ((150.0, 110.0), (90.0, 110.0)))
    tiny = limits()
    monkeypatch.setattr(run, "load_limits", lambda config: dict(tiny))
