"""A configuration is added as new files alone: in a copy of the
benchmark's files, a configuration file, its limits file, a traffic file,
a generator with a host system of its own (a recorder, ``judge_extra``
and ``host_columns``) and its plain reference, with entries in
``BENCHMARK.json``, run at a tiny size on the CPU in a fresh interpreter.
And a run holds the numbers reported to the limits named: a limit that
nothing reads fails the run, a number with no limit stops it, and a
configuration with no limits file stops before set-up."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.spec import BENCH_DIR, ROOT
from benchmark.tests.tiny import CONF, TinySpec, limits, traffic, use_tiny, \
    workload

GENERATOR = '''"""The drill generator: contact's frame traffic, and a host system that
every ``period_frames`` frames, after the tick, sets side ``side``'s
living wounded units to a stance, HOLD_POSITION and AGGRESSIVE in turn."""

import numpy as np

from benchmark import check
from benchmark.generators import contact

STANCES = (1, 0)


def wounded(hp, max_hp, alive, faction, side):
    """The host system's choice: the slots of a side's living wounded
    units."""
    return np.flatnonzero(alive & (faction == side) & (hp < max_hp))


class DrillRecorder(check._Patches):
    """Copies the inputs and the answer of every ``wounded`` call."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __enter__(self):
        import sys

        def wrap(orig):
            def call(*args):
                out = orig(*args)
                self.calls.append((args, np.array(out)))
                return out
            return call

        self._patch(sys.modules[__name__], "wounded", wrap)
        return self


class Cell(contact.Cell):
    def prepare(self):
        super().prepare()
        self.drills = 0
        self.drilled = False

    def after_call(self, n):
        super().after_call(n)
        d = self.traffic["drill"]
        self.drilled = self.frame % d["period_frames"] == 0
        if self.drilled:
            h = self.eng.ents_host("hp", "max_hp", "alive", "faction", "uid")
            slots = wounded(h["hp"], h["max_hp"], h["alive"], h["faction"],
                            d["side"])
            if len(slots):
                self.eng.set_stance([int(u) for u in h["uid"][slots]],
                                    STANCES[self.drills % 2])
            self.drills += 1

    def recorders(self):
        self.drill_rec = DrillRecorder()
        return [self.drill_rec]

    def judge_extra(self, device):
        from benchmark.reference.drill import wounded as plain

        if not self.drill_rec.calls:
            return {}
        differ = 0
        for args, got in self.drill_rec.calls:
            differ += len(set(plain(*args)) ^ set(got.tolist()))
        return {"drill_slots_differ": differ}

    def host_columns(self, n):
        cols = super().host_columns(n)
        return cols + ("stance",) if self.drilled else cols
'''

REFERENCE = '''"""The drill's host system, plainly."""


def wounded(hp, max_hp, alive, faction, side):
    return [i for i in range(len(hp))
            if alive[i] and faction[i] == side and hp[i] < max_hp[i]]
'''

SCRIPT = '''
import json, sys
import numpy as np
import pytest
import torch
torch.set_num_threads(2)
from benchmark import run
from benchmark.generators import contact, drill
from benchmark.spec import Spec
from benchmark.tests import tiny
mode = sys.argv[1]
mp = pytest.MonkeyPatch()
real = run.load_limits
tiny.use_tiny(mp)
mp.setattr(run, "load_limits", real)
if mode == "broken":
    # the host system leaves out the first wounded unit
    ok = drill.wounded
    mp.setattr(drill, "wounded", lambda *a: ok(*a)[1:])
elif mode == "no_host_columns":
    mp.setattr(drill.Cell, "host_columns", contact.Cell.host_columns)
spec = Spec.load()
rc = run.report(spec, spec.workload("tiny_drill.drill.frame"),
                seed=2 ** 31 + 4242, seconds=0.5, trace=False, device="cpu")
assert rc == 0, rc
'''


def _add_config(root) -> None:
    """The benchmark's files under `root`, and a configuration, its
    limits, its traffic, its generator and its reference added as new
    files, with entries in ``BENCHMARK.json``."""
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "benchmark"
    conf = dict(CONF, name="tiny_drill", reduced=[])
    (b / "configs" / "tiny_drill.json").write_text(json.dumps(conf))
    (b / "limits" / "tiny_drill.json").write_text(json.dumps(
        dict(limits(), drill_slots_differ=0)))
    tr = dict(traffic("frame"), generator="drill",
              drill={"period_frames": 5, "side": 0})
    (b / "traffic" / "drill.frame.json").write_text(json.dumps(tr))
    (b / "generators" / "drill.py").write_text(GENERATOR)
    (b / "reference" / "drill.py").write_text(REFERENCE)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"].append({
        "name": "tiny_drill", "source": "a test", "reduced": [],
        "file": "benchmark/configs/tiny_drill.json", "why": "a test"})
    doc["workloads"].append({
        "name": "tiny_drill.drill.frame", "config": "tiny_drill",
        "traffic": "drill.frame", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))


@pytest.mark.parametrize("mode", ["sound", "broken", "no_host_columns"])
def test_a_configuration_added_as_new_files(tmp_path, mode):
    """Sound, the added configuration is correct with its own number in
    ``checks``; with its host system broken its own number reads above
    its limit; with ``host_columns`` not naming the column its host system
    rewrites, ``rows_differ`` does."""
    _add_config(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-c", SCRIPT, mode], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "the generator's own" in res.stdout
    last = json.loads(res.stdout.strip().splitlines()[-1])
    checks = last["checks"]
    assert list(checks) == list(json.loads(
        (tmp_path / "benchmark" / "limits" / "tiny_drill.json").read_text()))
    own = checks["drill_slots_differ"]["value"]
    rows = checks["rows_differ"]["value"]
    if mode == "sound":
        assert last["correct"] is True, checks
        assert own == 0 and rows == 0
    elif mode == "broken":
        assert last["correct"] is False
        assert own > 0 and rows == 0, checks
    else:
        assert last["correct"] is False
        assert own == 0 and rows > 0, checks


@pytest.mark.parametrize("case", ["unread", "unlimited"])
def test_the_numbers_reported_are_the_limits_named(monkeypatch, case):
    """A limit whose number nothing reports makes ``correct`` false and
    reads "missing"; a reported number with no limit stops the run."""
    use_tiny(monkeypatch)
    lim = limits()
    if case == "unread":
        lim["ghost_gap"] = 0.0
    else:
        del lim["fog_differ"]
    monkeypatch.setattr(run, "load_limits", lambda config: dict(lim))

    def measure():
        return run.measure(TinySpec(), workload("frame"), seed=2 ** 31 + 31,
                           seconds=0.3, trace=False, device="cpu",
                           t_start=0.0, log=lambda s: None)

    if case == "unlimited":
        with pytest.raises(run.RunError, match="fog_differ"):
            measure()
        return
    out = measure()
    assert out["correct"] is False
    assert out["checks"]["ghost_gap"] == {"value": run.MISSING, "limit": 0.0}
    assert all(v["value"] == 0 for k, v in out["checks"].items()
               if k != "ghost_gap"), out["checks"]


def test_a_configuration_without_limits_stops_before_set_up(monkeypatch):
    class NoSetUp(TinySpec):
        def generator(self, wl):
            raise AssertionError("set-up began")

    wl = dict(workload("frame"), config="nowhere")
    with pytest.raises(run.RunError, match="benchmark/limits/nowhere.json"):
        run.measure(NoSetUp(), wl, seed=1, seconds=0.3, trace=False,
                    device="cpu", t_start=0.0, log=lambda s: None)
