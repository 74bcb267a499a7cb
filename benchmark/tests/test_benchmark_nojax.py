"""No module of JAX, jaxlib, flax or the JAX package is loaded by a run of
the benchmark: a traced run at a tiny size on the CPU in a fresh
interpreter, then the harness's own check of ``sys.modules``."""

import json
import subprocess
import sys

from benchmark.spec import ROOT

SCRIPT = """
import json, sys
import pytest
from benchmark import run
from benchmark.tests import tiny
mp = pytest.MonkeyPatch()
tiny.use_tiny(mp)
out = run.measure(tiny.TinySpec(), tiny.workload("frame"), seed=99,
                  seconds=0.5, trace=True, device="cpu", t_start=0.0,
                  log=lambda s: None)
print(json.dumps({"correct": out["correct"],
                  "forbidden": run.forbidden_modules(),
                  "port": "permafrost_engine_tpu_torch" in sys.modules}))
"""


def test_a_traced_run_loads_no_jax():
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["port"] and out["correct"]
    assert out["forbidden"] == []
