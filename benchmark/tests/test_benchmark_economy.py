"""The economy match and the structure drops at a size a CPU test holds:
``tiny.CONF``'s battle on its 1x1-chunk map, with one base a team (a
storage, two gold nodes, one gas node, six workers) and one builder a
player, given a building every 120 frames. A seeded run is correct with
every number 0 while the economy gives orders and founds buildings; a
harvest that takes one unit too many reads ``resources_differ`` and is
not correct; a drop run records a drop and a lift and is correct. The
plain economy reference imports neither the port nor JAX, and a traced
tiny match loads no JAX module."""

import json
import subprocess
import sys

import pytest

from benchmark import check, run
from benchmark.spec import ROOT, Spec, limits_file
from benchmark.tests import tiny

CONF = dict(
    tiny.CONF, name="tiny_match",
    engine={"max_ents": 96, "max_flocks": 64, "chunks_r": 1, "chunks_c": 1,
            "skin_joints": 0},
    economy={"players_per_team": 1, "bases_per_player": 1, "gold_nodes": 2,
             "gold_amount": 60, "gas_nodes": 1, "gas_amount": 90,
             "gold_workers": 4, "gas_workers": 2, "builders_per_player": 1,
             "worker": {"speed": 20.0, "gather": 1, "carry": 5},
             "building": {"radius": 3.0, "hp": 500.0, "gold": 50},
             "base_x": [48.0], "base_z": [128.0], "base_jitter": 8.0,
             "node_distance": 12.0, "building_distance": [18.0, 30.0]})
SEED = 2 ** 31 + 7


def traffic(kind: str, check_frames: int) -> dict:
    """The tiny ``economy`` or ``drop`` mix: ``tiny``'s frame traffic,
    the economy's without player orders."""
    base = dict(tiny.traffic("frame"), check_frames=check_frames)
    if kind == "economy":
        return dict(base, generator="economy", orders=None,
                    builds={"period_frames": 120})
    return dict(base, generator="drop",
                drops={"period_frames": 20, "lift_after_frames": 10})


class EconomySpec(Spec):
    """The tiny cell of `kind` with the metrics of the real
    ``BENCHMARK.json`` cell it stands for."""

    CELLS = {"economy": "match4v4.economy.frame",
             "drop": "combined.drop.frame"}

    def __init__(self, kind: str, check_frames: int):
        self.doc = Spec.load().doc
        self.kind, self.check_frames = kind, check_frames

    def config(self, wl):
        return CONF if self.kind == "economy" else tiny.CONF

    def traffic(self, wl):
        return traffic(self.kind, self.check_frames)

    def metrics(self, wl, trace):
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m
                or self.CELLS[self.kind] in m["workloads"]]


def _measure(monkeypatch, kind: str, check_frames: int, trace=False):
    """One tiny run of `kind` through ``run.measure``: (its result, the
    cell ``check.verify`` judged)."""
    tiny.use_tiny(monkeypatch)
    config = "match4v4_economy" if kind == "economy" else "battle10k_combined"
    with open(limits_file(config)) as f:
        lim = json.load(f)
    if kind == "drop":
        lim = tiny.limits()
        from benchmark.generators import drop

        monkeypatch.setattr(drop, "SPOTS", ((120.0, 60.0), (120.0, 160.0)))
        monkeypatch.setattr(drop, "RADIUS", 6.0)
    monkeypatch.setattr(run, "load_limits", lambda c: dict(lim))
    seen = {}
    verify = check.verify

    def spy(cell, frames, **kw):
        seen["cell"] = cell
        seen["marks"] = (getattr(cell, "drops", 0), getattr(cell, "lifts", 0),
                         getattr(cell, "founded", 0))
        return verify(cell, frames, **kw)

    monkeypatch.setattr(check, "verify", spy)
    wl = {"name": f"tiny.{kind}.frame", "config": config,
          "traffic": f"{kind}.frame", "chips": 1, "why": "a CPU test"}
    out = run.measure(EconomySpec(kind, check_frames), wl, seed=SEED,
                      seconds=0.5, trace=trace, device="cpu", t_start=0.0,
                      log=lambda s: None)
    return out, seen


def test_tiny_match_is_correct(monkeypatch):
    out, seen = _measure(monkeypatch, "economy", 240)
    checks = out["checks"]
    assert out["correct"] is True, checks
    assert all(v["value"] == 0 for v in checks.values()), checks
    assert {"resources_differ", "harvester_states_differ",
            "economy_orders_differ", "building_progress_gap"} <= set(checks)
    cell = seen["cell"]
    calls = [c[0] for t in cell.eco_rec.ticks for c in t["calls"]]
    assert len(cell.eco_rec.ticks) == 20
    assert calls.count("move") >= 20 and calls.count("stop") >= 20
    assert cell.founded > seen["marks"][2]     # founded in the check
    assert cell.founded_frames


def test_a_harvest_broken_by_one_unit_is_not_correct(monkeypatch):
    """Each harvesting worker's load gains one unit after the port's
    harvest: ``resources_differ`` reads it."""
    from permafrost_engine_tpu_torch.game import economy

    orig = economy.Economy._tick_harvesters

    def broken(self):
        harvesting = [h for h in self.harvesters.values()
                      if h.state == economy.HarvesterState.HARVESTING]
        orig(self)
        for h in harvesting[:1]:
            for name in h.carried:
                h.carried[name] += 1

    monkeypatch.setattr(economy.Economy, "_tick_harvesters", broken)
    out, _ = _measure(monkeypatch, "economy", 120)
    assert out["correct"] is False
    assert out["checks"]["resources_differ"]["value"] > 0, out["checks"]


def test_tiny_drop_records_a_drop_and_a_lift(monkeypatch):
    out, seen = _measure(monkeypatch, "drop", 30)
    assert out["correct"] is True, out["checks"]
    assert all(v["value"] == 0 for v in out["checks"].values())
    cell = seen["cell"]
    drops, lifts, _ = seen["marks"]
    assert cell.drops > drops and cell.lifts > lifts


def test_the_economy_reference_imports_alone():
    code = ("import sys, benchmark.reference.economy; print(sorted({"
            "m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', "
            "'flax', 'permafrost_engine_tpu', 'permafrost_engine_tpu_torch'}"
            "))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip() == "[]"


SCRIPT = """
import json, sys
import pytest
from benchmark import run
from benchmark.tests import test_benchmark_economy as t
mp = pytest.MonkeyPatch()
out, _ = t._measure(mp, "economy", 24, trace=True)
print(json.dumps({"correct": out["correct"],
                  "forbidden": run.forbidden_modules(),
                  "port": "permafrost_engine_tpu_torch" in sys.modules}))
"""


def test_a_traced_tiny_match_loads_no_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["port"] and out["correct"]
    assert out["forbidden"] == []
