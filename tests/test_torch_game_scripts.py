"""The game code runs unedited on the port's ``pf``.

``scripts/rts`` imports ``permafrost_engine_tpu.script.pf`` (and the JAX
package's ``core.config`` and ``assets.pfmap``) and touches the engine
through nothing else. A fresh interpreter installs the port launcher's
``sys.meta_path`` finder (``tools/launcher.py``), which resolves every
``permafrost_engine_tpu.*`` import to the same module of
``permafrost_engine_tpu_torch.*``, makes the port's ``pf.init`` default to
``device="cpu"`` (the launcher's ``--cpu``), runs ``scripts/rts/main.setup()`` and
``pf.step(5)`` as ``tests/test_game_scripts.py``'s fixture does, then each
of that file's tests against the live game, in its order. Each test here
is one of them, passing when it passed there; one more holds that no
``jax``, ``jaxlib`` or ``flax`` module and no module of the JAX package
itself was loaded.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GAME_TESTS = ["test_scene_loaded", "test_unit_stat_blocks",
              "test_hotkey_conflict_detected",
              "test_box_select_fills_action_pad",
              "test_pause_resume_via_demo_window", "test_pause_hotkey",
              "test_camera_toggle_key", "test_settings_dialog_apply",
              "test_controlled_faction_switch",
              "test_session_dialog_roundtrip"]

_GAME_RUN = r"""
import json
import pathlib
import sys
import tempfile
import traceback

import pytest

sys.path.insert(0, REPO)
sys.path.insert(0, REPO + "/tests")

from permafrost_engine_tpu_torch.tools import launcher

launcher.install_finder()
launcher.use_cpu()

from permafrost_engine_tpu_torch.script import pf

import test_game_scripts as T
from scripts.rts import main as game_main

assert T.pf is pf, T.pf
game = game_main.setup()
pf.step(5)
assert pf.context().engine.device.type == "cpu"
results = {}
for name in NAMES:
    fn = getattr(T, name)
    args = [game]
    if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount]:
        args.append(pathlib.Path(tempfile.mkdtemp()))
    try:
        fn(*args)
        results[name] = "passed"
    except (Exception, pytest.fail.Exception):
        results[name] = traceback.format_exc()
# every permafrost_engine_tpu.* entry must be the port's module
print("RESULTS " + json.dumps(dict(results=results,
                                   **launcher.jax_modules())))
"""


@pytest.fixture(scope="module")
def port_game_run():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    env["OMP_NUM_THREADS"] = "1"
    code = (f"REPO = {_REPO!r}\nNAMES = {GAME_TESTS!r}\n" + _GAME_RUN)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULTS ")]
    assert res.returncode == 0 and line, res.stderr[-4000:]
    return json.loads(line[-1][len("RESULTS "):])


@pytest.mark.parametrize("name", GAME_TESTS)
def test_game_script_test_passes_on_port(port_game_run, name):
    assert port_game_run["results"][name] == "passed", \
        port_game_run["results"][name]


def test_game_scripts_load_no_jax(port_game_run):
    assert port_game_run["jax"] == [] and port_game_run["jax_pkg"] == []
