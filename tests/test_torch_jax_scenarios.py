"""The JAX package's own scenario test files, unedited, on the port.

Two fresh interpreters, run at once (the soak alone, and the rest),
each install the port launcher's ``sys.meta_path`` finder
(``permafrost_engine_tpu_torch/tools/launcher.py``), which resolves every
``permafrost_engine_tpu.*`` import to the same module of
``permafrost_engine_tpu_torch.*``, makes ``Engine`` and ``pf.init`` default
to the CPU (the launcher's ``--cpu``), and runs these files through
``pytest.main`` (without ``tests/conftest.py``, which sets JAX up):
``tests/test_editor_scripts.py`` (``scripts/editor``),
``test_debug_trace.py``, ``test_blocker_nav.py``, ``test_soak.py`` and
``test_batch_requests.py``. Each of their cases is one case here, passing
when it passes on the port. ``test_batch_requests.py`` counts the calls of
the JAX engine's integrate dispatch, ``NavService._integrate``; in the run
that name is a property over the port's ``NavService._integrate_host``, so
the hook counts the port's integrations (a patch of the port's class in
that interpreter, not an edit of the file). One more case holds that every
``permafrost_engine_tpu.*`` module loaded was the port's.
"""

import json
import os
import subprocess
import sys

import pytest
import torch
torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {
    "test_editor_scripts.py": [
        "test_paint_height_brush", "test_paint_blockers_hits_nav",
        "test_place_select_delete_objects",
        "test_tab_switch_disables_painting", "test_diplomacy_tab",
        "test_menu_save_load_roundtrip"],
    "test_debug_trace.py": [
        "test_paused_frame_step",
        "test_trace_python_records_handler_dispatch",
        "test_log_mem_stats_and_call_graphs", "test_trace_gpu_counters",
        "test_render_log_mask"],
    "test_blocker_nav.py": [
        "test_parked_plug_forces_astar_detour",
        "test_blocker_flip_triggers_replan",
        "test_fully_sealed_by_blockers_falls_back_to_static_path",
        "test_settled_crowd_does_not_churn_replans"],
    "test_soak.py": ["test_battle_soak_invariants"],
    "test_batch_requests.py": [
        "test_replanning_20_flocks_is_one_batch",
        "test_mixed_layer_move_is_one_batch"],
}
NODES = [f"tests/{f}::{name}" for f, names in CASES.items() for name in names]
# two interpreters run at once: the soak alone, and the rest
GROUPS = [[n for n in NODES if "test_soak.py" in n],
          [n for n in NODES if "test_soak.py" not in n]]

_RUN = r"""
import json
import sys

sys.path.insert(0, REPO)
sys.path.insert(0, REPO + "/tests")

from permafrost_engine_tpu_torch.tools import launcher

launcher.install_finder()
launcher.use_cpu()

from permafrost_engine_tpu_torch.nav.service import NavService

NavService._integrate = property(
    lambda self: self._integrate_host,
    lambda self, fn: setattr(self, "_integrate_host", fn))

import pytest


class Collect:
    def __init__(self):
        self.out = {}

    def pytest_runtest_logreport(self, report):
        # a case passes when its setup, call and teardown all pass
        if report.outcome != "passed":
            self.out[report.nodeid] = (f"{report.when} {report.outcome}: "
                                       + report.longreprtext[-4000:])
        elif report.when == "call":
            self.out.setdefault(report.nodeid, "passed")


collect = Collect()
rc = pytest.main(NODES + ["-q", "-p", "no:cacheprovider", "-p", "no:xdist",
                          "-p", "no:randomly", "--noconftest"],
                 plugins=[collect])
print("RESULTS " + json.dumps(dict(rc=int(rc), results=collect.out,
                                   **launcher.jax_modules())))
"""


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("jax_scenarios")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    try:
        for i, nodes in enumerate(GROUPS):
            code = f"REPO = {_REPO!r}\nNODES = {nodes!r}\n" + _RUN
            with open(tmp_path / f"{i}.out", "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code], cwd=_REPO, env=env,
                    stdout=out, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=900)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    merged = dict(rc=0, results={}, jax_pkg=[])
    for i in range(len(GROUPS)):
        out = (tmp_path / f"{i}.out").read_text()
        line = [ln for ln in out.splitlines() if ln.startswith("RESULTS ")]
        assert line, out[-8000:]
        run = json.loads(line[-1][len("RESULTS "):])
        merged["rc"] = max(merged["rc"], run["rc"])
        merged["results"].update(run["results"])
        merged["jax_pkg"] += run["jax_pkg"]
    return merged


@pytest.mark.parametrize("node", NODES)
def test_jax_scenario_passes_on_port(port_run, node):
    assert port_run["results"].get(node) == "passed", \
        port_run["results"].get(node, "not run")


def test_jax_scenarios_ran_on_port_modules(port_run):
    assert port_run["jax_pkg"] == []
    assert port_run["rc"] == 0 and len(port_run["results"]) == len(NODES)
