"""PyTorch port vs the JAX package: the system's entry points.

Each of the port's demos and tools (``permafrost_engine_tpu_torch/demos``,
``permafrost_engine_tpu_torch/tools``) runs on the CPU (``--cpu`` or
``device="cpu"``) against its JAX original (``demos/``, ``tools/``) on the
CPU. Positions are held to ``tests/test_torch_war.py``'s 1e-3 world units;
the minimaps to ``tests/test_torch_scene.py``'s 2 levels. The launcher runs
the game (``scripts/rts``, ``scripts/editor``) and ``tools/model_pipeline.py``
unedited in one fresh interpreter, which must load no module of JAX.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

import demos.editor as jeditor
import demos.stress as jstress
import demos.viewer as jviewer
import permafrost_engine_tpu.render.draw as jdraw
import permafrost_engine_tpu.script.pf as jpf
import tools.export_replay as jreplay
import tools.live_viewer as jlive
from permafrost_engine_tpu.core.config import MoveState
from permafrost_engine_tpu_torch.demos import editor as teditor
from permafrost_engine_tpu_torch.demos import stress as tstress
from permafrost_engine_tpu_torch.demos import viewer as tviewer
from permafrost_engine_tpu_torch.script import pf as tpf
from permafrost_engine_tpu_torch.tools import dump_api
from permafrost_engine_tpu_torch.tools import export_replay as treplay
from permafrost_engine_tpu_torch.tools import live_viewer as tlive

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POS_ATOL = 1e-3     # tests/test_torch_war.py's position tolerance
FRAME_LEVELS = 2    # tests/test_torch_scene.py's frame tolerance


def _jax_ents(eng, *names):
    return {n: np.asarray(getattr(eng.state.ents, n)) for n in names}


def test_stress_matches_jax(background):
    """``build(64)`` on both packages, three ``step_scan(60)`` seconds: the
    alive counts and the event logs equal, positions within POS_ATOL. (It
    requests ``background`` only to start those processes first.)"""
    want_eng, got_eng = jstress.build(64), tstress.build(64, device="cpu")
    for second in range(3):
        want_eng.step_scan(60)
        got_eng.step_scan(60)
        want = _jax_ents(want_eng, "alive", "pos")
        got = got_eng.ents_host("alive", "pos")
        np.testing.assert_array_equal(got["alive"], want["alive"])
        np.testing.assert_allclose(got["pos"], want["pos"], rtol=0,
                                   atol=POS_ATOL, err_msg=f"second {second}")
        assert got_eng.events == want_eng.events
    assert int(got["alive"].sum()) == 128
    assert tstress.report(got_eng)["alive"] == 128
    assert any(k == "motion_start" for k, _ in got_eng.events)


def test_editor_matches_jax(tmp_path, monkeypatch):
    """The generated map's ``.pfmap`` text and the path's reachability."""
    monkeypatch.setattr(sys, "argv", ["editor.py", str(tmp_path / "j.pfmap")])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jeditor.main()
    got = teditor.main([str(tmp_path / "t.pfmap"), "--cpu"])
    assert got["device"] == "cpu"
    assert (tmp_path / "t.pfmap").read_text() == (
        tmp_path / "j.pfmap").read_text() == got["text"]
    want_ok = "path across generated map: reachable" in out.getvalue()
    assert got["reachable"] == want_ok


def test_viewer_minimaps_match_jax(monkeypatch):
    """One simulated second of the viewer: its minimap within FRAME_LEVELS
    of JAX's."""
    want = []
    raster = jdraw.minimap_raster

    def record(*a, **k):
        want.append(raster(*a, **k))
        return want[-1]

    monkeypatch.setattr(jdraw, "minimap_raster", record)
    monkeypatch.setattr(sys, "argv", ["viewer.py", "--seconds", "1"])
    with contextlib.redirect_stdout(io.StringIO()):
        jviewer.main()
        got = tviewer.main(["--seconds", "1", "--cpu"])
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape == (128, 128, 3)
        assert np.abs(g.astype(int) - w.astype(int)).max() <= FRAME_LEVELS
        assert len(np.unique(g.reshape(-1, 3), axis=0)) > 2   # dots drawn


def test_export_replay_records_match_jax(tmp_path, monkeypatch):
    """Two seconds of the replay battle at 32 a side: the recorded u16
    positions within POS_ATOL (one 1/16 u step of quantization more), the
    hp, faction and alive bytes equal, and the HTML written."""
    recorded = {}
    rec = jreplay.record

    def capture(*a, **k):
        recorded["want"] = rec(*a, **k)
        return recorded["want"]

    monkeypatch.setattr(jreplay, "record", capture)
    monkeypatch.setattr(sys, "argv", ["export_replay.py",
                                      str(tmp_path / "j.html"), "--units",
                                      "32", "--seconds", "2"])
    with contextlib.redirect_stdout(io.StringIO()):
        jreplay.main()
        t_pos, t_state = treplay.main([str(tmp_path / "t.html"), "--units",
                                       "32", "--seconds", "2", "--cpu"])
    w_pos, w_state = recorded["want"]
    assert t_pos.shape == w_pos.shape == (20, 128, 2)
    assert np.abs(t_pos.astype(int) - w_pos.astype(int)).max() <= (
        16 * POS_ATOL + 1)
    np.testing.assert_array_equal(t_state, w_state)
    html = (tmp_path / "t.html").read_text()
    assert '"frames": 20' in html and "data:image/png;base64," in html


def _screen_fraction(cam, world_xz, w, h):
    s = cam.world_to_screen((float(world_xz[0]), 0.0, float(world_xz[1])), w, h)
    return s[0] / w, s[1] / h


def test_live_viewer_click_orders_match_jax():
    """The live viewer's scenario at 16 a side on both packages: a left
    click on a unit of side 0 selects it and a right click orders it to
    move. On the port the clicks go through ``POST /input`` of the server
    on 127.0.0.1; on JAX through ``LiveServer.handle_input``. The same unit
    is selected and the same units are moving; ``GET /frame.png`` serves a
    PNG."""
    results = []
    for side in ("jax", "port"):
        if side == "jax":
            eng, cam, a = jlive.default_scenario(16)
            live = jlive.LiveServer(eng, cam, 160, 96)
            pf = jpf
        else:
            eng, cam, a = tlive.default_scenario(16, device="cpu")
            live = tlive.LiveServer(eng, cam, 160, 96)
            pf = tpf
        vw, vh = pf.context().ui.virtual_resolution
        target = pf.context().engine.pos_of(a[3])
        clicks = [dict(type="click", button=1,
                       **dict(zip("xy", _screen_fraction(cam, target, vw, vh)))),
                  dict(type="click", button=3,
                       **dict(zip("xy", _screen_fraction(
                           cam, (target[0] + 40.0, target[1]), vw, vh))))]
        try:
            if side == "jax":
                for msg in clicks:
                    live.handle_input(msg)
                png = None
            else:
                httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                            tlive.make_handler(live))
                thread = threading.Thread(target=httpd.serve_forever,
                                          daemon=True)
                thread.start()
                url = f"http://127.0.0.1:{httpd.server_address[1]}"
                try:
                    for msg in clicks:
                        req = urllib.request.Request(
                            url + "/input", data=json.dumps(msg).encode(),
                            method="POST")
                        with urllib.request.urlopen(req, timeout=60) as r:
                            assert r.status == 204
                    with urllib.request.urlopen(url + "/frame.png",
                                                timeout=120) as r:
                        png = r.read()
                finally:
                    httpd.shutdown()
                    httpd.server_close()
                    thread.join(timeout=10)
            selected = sorted(e.uid for e in pf.get_unit_selection())
            ms = (np.asarray(eng.state.ents.movestate) if side == "jax"
                  else eng.ents_host("movestate")["movestate"])
            moving = sorted(u for u in a if ms[eng.uid_to_slot[u]]
                            == int(MoveState.MOVING))
            results.append((selected, moving, png))
        finally:
            live.stop()
            pf._context = None
    (w_sel, w_mov, _), (g_sel, g_mov, png) = results
    assert g_sel == w_sel and len(g_sel) >= 1
    assert g_mov == w_mov and set(g_sel) <= set(g_mov)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


_LAUNCH = r"""
import json
import os
import sys

from permafrost_engine_tpu_torch.tools import launcher

launcher.CRASH_DIR = os.path.join(TMP, "crash")
runs = [["--cpu", REPO + "/scripts/rts/main.py"],
        ["--cpu", REPO + "/scripts/editor/main.py"],
        [REPO + "/tools/model_pipeline.py", "convert", TMP + "/grid.obj",
         TMP + "/grid.pfobj"],
        [REPO + "/tools/model_pipeline.py", "lods", TMP + "/grid.pfobj"],
        [TMP + "/boom.py"]]
rcs = [launcher.main(argv) for argv in runs]
print("LAUNCH " + json.dumps(dict(rcs=rcs, crash=sorted(os.listdir(
    launcher.CRASH_DIR)), **launcher.jax_modules())))
"""


def _grid_obj(n=8) -> str:
    """A bumpy n x n quad grid as Wavefront OBJ text."""
    lines = []
    for i in range(n + 1):
        for j in range(n + 1):
            lines.append(f"v {i} {0.1 * ((i * 7 + j * 3) % 5)} {j}")
    for i in range(n):
        for j in range(n):
            a = i * (n + 1) + j + 1
            lines.append(f"f {a} {a + 1} {a + n + 2} {a + n + 1}")
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """Starts the subprocesses that the launcher and campaign tests read,
    so that they run while the in-process tests do: the launcher program
    (``_LAUNCH``), ``python demos/campaign.py`` (JAX) and ``python -m
    permafrost_engine_tpu_torch.demos.campaign --cpu``. Each writes its
    output to a file; any still running at the end is killed."""
    tmp = tmp_path_factory.mktemp("entry_points")
    (tmp / "grid.obj").write_text(_grid_obj())
    (tmp / "boom.py").write_text("raise RuntimeError('boom in a script')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=_REPO, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    cmds = {
        "launcher": [sys.executable, "-c",
                     f"REPO = {_REPO!r}\nTMP = {str(tmp)!r}\n" + _LAUNCH],
        "campaign_jax": [sys.executable, os.path.join(_REPO, "demos",
                                                      "campaign.py")],
        "campaign_port": [sys.executable, "-m",
                          "permafrost_engine_tpu_torch.demos.campaign",
                          "--cpu"],
    }
    procs, files = {}, []
    try:
        for name, cmd in cmds.items():
            out = open(tmp / f"{name}.out", "w")
            err = open(tmp / f"{name}.err", "w")
            files += [out, err]
            procs[name] = subprocess.Popen(cmd, cwd=str(tmp), env=env,
                                           stdout=out, stderr=err)
        yield dict(procs=procs, tmp=tmp)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        for f in files:
            f.close()


def _finished(bg, name: str, timeout: float = 900.0):
    """(returncode, stdout, stderr) of background process `name`."""
    rc = bg["procs"][name].wait(timeout=timeout)
    return (rc, (bg["tmp"] / f"{name}.out").read_text(),
            (bg["tmp"] / f"{name}.err").read_text())


@pytest.fixture(scope="module")
def launched(background):
    rc, out, err = _finished(background, "launcher")
    line = [ln for ln in out.splitlines() if ln.startswith("LAUNCH ")]
    assert rc == 0 and line, out[-3000:] + err[-3000:]
    return dict(json.loads(line[-1][len("LAUNCH "):]), out=out, err=err,
                tmp=background["tmp"])


def test_launcher_runs_the_game_unedited(launched):
    assert launched["rcs"][:2] == [0, 0], launched["err"][-3000:]
    assert "RTS GAME COMPLETE" in launched["out"]
    assert "EDITOR SESSION COMPLETE" in launched["out"]


def test_launcher_runs_model_pipeline_unedited(launched):
    assert launched["rcs"][2:4] == [0, 0], launched["err"][-3000:]
    tmp = launched["tmp"]
    assert (tmp / "grid.pfobj").exists() and (tmp / "grid.lod2.pfobj").exists()
    assert "wrote" in launched["out"] and "-> " in launched["out"]


def test_launcher_captures_a_crash(launched):
    assert launched["rcs"][4] == 1
    reports = [f for f in launched["crash"] if f.startswith("crash_")]
    assert len(reports) == 1 and not any(
        f.startswith("fault_") for f in launched["crash"])
    text = (launched["tmp"] / "crash" / reports[0]).read_text()
    assert "boom in a script" in text and "torch=" in text
    assert "CUDA_VISIBLE_DEVICES=" in text and "JAX_PLATFORMS" not in text


def test_launcher_loads_no_jax(launched):
    assert launched["jax"] == [] and launched["jax_pkg"] == []
    assert launched["out"].count("launcher modules: ") == 5


def _listing(text: str) -> dict:
    """docs/python_api.txt's entries: functions by name -> signature,
    classes by name -> methods, constants by name."""
    funcs, classes, consts = {}, {}, set()
    section = None
    name = None
    for ln in text.splitlines():
        if ln.startswith("=== "):
            section = ln.split()[1]
        elif not ln.startswith("pf.") and not ln.startswith("    methods: "):
            continue
        elif section == "FUNCTIONS" and ln.startswith("pf."):
            name, sig = ln[3:].split("(", 1)
            funcs[name] = "(" + sig
        elif section == "CLASSES" and ln.startswith("pf."):
            name = ln[3:].split(":", 1)[0]
            classes[name] = []
        elif section == "CLASSES":
            m = ln.split(": ", 1)[1]
            classes[name] = [] if m == "-" else m.split(", ")
        elif section == "CONSTANTS":
            consts.add(ln[3:].split(" = ", 1)[0])
    return dict(funcs=funcs, classes=classes, consts=consts)


# the port's deliberate differences from the listing
SIGNATURE_EXCEPTIONS = {
    # pf.init takes the device of the engine it builds (the card by default)
    "init": "(cfg: 'EngineConfig | None' = None, *, engine: 'Engine | None' "
            "= None, basedir: 'str' = '.', device='cuda') -> 'PfContext'",
}


def test_dump_api_covers_the_jax_listing(tmp_path):
    """Every function (with its signature, but for SIGNATURE_EXCEPTIONS),
    class (with its methods) and constant of ``docs/python_api.txt`` is on
    the port's ``pf``, whose listing ``dump_api`` writes where it is told
    (never over ``docs/python_api.txt``); each constant has the JAX ``pf``'s
    value."""
    with open(os.path.join(_REPO, "docs", "python_api.txt")) as f:
        want = _listing(f.read())
    out = tmp_path / "api.txt"
    with contextlib.redirect_stdout(io.StringIO()):
        dump_api.main([str(out)])
    got = _listing(out.read_text())
    assert out.read_text().startswith("permafrost_engine_tpu_torch `pf`")
    for name, sig in want["funcs"].items():
        assert got["funcs"].get(name) == SIGNATURE_EXCEPTIONS.get(name, sig), name
    for name, methods in want["classes"].items():
        assert set(methods) <= set(got["classes"][name]), name
    for name in want["consts"]:
        assert getattr(tpf, name) == getattr(jpf, name), name
    with pytest.raises(SystemExit):
        dump_api.main([os.path.join(_REPO, "docs", "python_api.txt")])


def test_campaign_matches_jax(background):
    """``python demos/campaign.py`` and the port's ``--cpu`` run to victory
    print the same stage results: the victory and population lines."""
    rc_j, want, err_j = _finished(background, "campaign_jax")
    rc_t, got, err_t = _finished(background, "campaign_port")
    assert rc_j == 0, err_j[-3000:]
    assert rc_t == 0, err_t[-3000:]
    want = [ln for ln in want.splitlines() if ln.strip()]
    assert want[-1] == "CAMPAIGN COMPLETE" and want[0].startswith("victory:")
    assert [ln for ln in got.splitlines() if ln.strip()] == want
