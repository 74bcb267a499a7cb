"""The port's probes (``permafrost_engine_tpu_torch/tools/probe_*.py``) as
commands, on the CPU at tiny sizes:

* each ``main(["--cpu", ...])`` prints, last, one compact JSON line with the
  probe's keys, and writes it to ``--out`` when given;
* without a CUDA device and without ``--cpu`` each exits non-zero and
  prints nothing on standard output;
* a fresh interpreter that imports all twelve loads no module of JAX or
  of the JAX package.

``probe_overlap`` and ``probe_shard`` run as commands in
``tests/test_torch_probes.py``, beside the JAX package.
"""

import importlib
import json
import os
import subprocess
import sys

import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu_torch.tools import _probe_util as U

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBES = ("probe_ablate", "probe_ablate_move", "probe_drive", "probe_extend",
          "probe_obstacle", "probe_overlap", "probe_render",
          "probe_render_breakdown", "probe_scale", "probe_shard", "probe_soak",
          "probe_steady")
# the way into the melee cut to a few frames
CONTACT = ["--warmup", "6", "--ff-chunk", "6", "--ff-max-frames", "6",
           "--thicken", "6"]
RENDER = ["--w", "160", "--h", "96", "--ents", "40", "--frames", "2"]
# per probe: tiny flags, and the keys of its last line
CASES = {
    "probe_soak": (["--n-per-side", "8", "--windows", "2", "--window-frames",
                    "6", "--warmup", "6"],
                   {"windows", "frames", "live", "free", "uids", "max_ents",
                    "wall_s"}),
    "probe_drive": (["--n-per-side", "8", "--frames", "3", "--windows", "1",
                     "--profile-frames", "6"] + CONTACT,
                    {"alive_at_contact", "fps_step", "fps_step_perframe",
                     "fps_step_scan", "fps_all", "tick"}),
    "probe_steady": (["--n-per-side", "8", "--frames", "3", "--windows", "1",
                      "--profile-frames", "6", "--warmup", "6"],
                     {"march_breakdown", "fps_micro", "fps_perframe",
                      "fps_scan", "tick_classes", "tick_ms_mean"}),
    "probe_obstacle": (["--n-per-side", "8", "--frames", "3", "--windows", "1"]
                       + CONTACT, {"phases"}),
    "probe_extend": (["--n-per-side", "8", "--frames", "3"] + CONTACT,
                     {"pre_drop", "drop_ms", "post_drop_0", "post_drop_1",
                      "post_drop_2"}),
    "probe_ablate": (["--n-per-side", "8", "--frames", "1", "--windows", "1",
                      "--warm", "0"] + CONTACT,
                     {"full", "no_move", "no_combat", "no_fog"}),
    "probe_ablate_move": (["--n-per-side", "8", "--frames", "1", "--windows",
                           "1", "--warm", "0"] + CONTACT,
                          {"full", "no_hrvo", "no_boids", "no_neigh",
                           "no_contact", "no_fields", "no_restamp"}),
    "probe_scale": (["--n-per-side", "8", "--frames", "3", "--windows", "1"]
                    + CONTACT,
                    {"max_ents", "alive_at_contact", "fps_step", "fps_step_all",
                     "fps_step_scan", "fps_step_scan_all", "alive_at_end",
                     "finite"}),
    "probe_render": (RENDER + ["--sim", "--sim-frames", "4"],
                     {"resolution", "first_frame_s", "shape", "mean",
                      "render_ms_p50", "render_ms_p90", "render_fps",
                      "sim_plus_render_fps_dec4", "sim_plus_render_fps_dec2"}),
    "probe_render_breakdown": (RENDER + ["--log-frames", "1"],
                               {"resolution", "first_frame_s",
                                "render_ms_p50_no_overlays",
                                "render_ms_p50_full", "passes",
                                "same_frame_ms"}),
}


def _probe(name):
    return importlib.import_module(f"permafrost_engine_tpu_torch.tools.{name}")


@pytest.mark.parametrize("name", list(CASES))
def test_main_prints_its_json_line_last(name, tmp_path, capsys):
    flags, keys = CASES[name]
    path = tmp_path / "out.json"
    ret = _probe(name).main(["--cpu", "--out", str(path)] + flags)
    lines = capsys.readouterr().out.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == keys, sorted(last)
    assert lines[-1] == json.dumps(ret, separators=(",", ":"))
    assert path.read_text() == lines[-1] + "\n"


def test_ablation_mains_count_every_patch_point(capsys):
    for name in ("probe_ablate", "probe_ablate_move"):
        probe = _probe(name)
        out = probe.main(["--cpu"] + CASES[name][0])
        labels = {U.label(*p) for p in probe.POINTS}
        for variant, patches in probe.VARIANTS:
            r = out[variant]
            assert set(r["calls"]) == labels and r["k1_launches"] == 0
            assert set(r["standin_calls"]) <= labels
            for p in patches:
                assert r["calls"][U.label(*p)] == 0
    capsys.readouterr()


@pytest.mark.parametrize("name", PROBES)
def test_no_device_exits_nonzero(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        _probe(name).main([])
    assert exc.value.code not in (0, None)
    cap = capsys.readouterr()
    assert "no CUDA device" in cap.err and cap.out == ""


def test_probes_load_no_jax():
    code = ("import sys\n"
            + "".join(f"import permafrost_engine_tpu_torch.tools.{n}\n"
                      for n in PROBES)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'flax', 'permafrost_engine_tpu')))")
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO,
                         env=dict(os.environ, PYTHONPATH=_REPO),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"
