"""Crash-capturing launcher: run a game script on the port.

Port of ``tools/launcher.py``, the counterpart of the engine executable.
The reference's launcher runs the engine under a debugger loop and writes a
minidump and a log on a fault (ref: launcher/main.c:150-243); here
faulthandler dumps to a file, and a script that raises leaves a crash report
with the traceback and the environment in ``crash_reports/``.

The script runs unedited: a ``sys.meta_path`` finder resolves every
``permafrost_engine_tpu.*`` import to the same module of
``permafrost_engine_tpu_torch.*``, so the game (``scripts/rts``,
``scripts/editor``) and numpy tools written against the JAX package's
names (``tools/model_pipeline.py``) run on the port and load no module of
JAX. A script under the repository root that defines ``main()`` is imported
under its module name and its ``main()`` is called (the game's modules pin
JAX's platform when run as ``__main__``); any other script runs as
``__main__``. The game runs on the card; ``--cpu`` makes ``Engine`` and
``pf.init`` default to the CPU. When the script ends the launcher prints
one ``launcher modules:`` line, the JAX modules that were loaded (none).

Run: ``python -m permafrost_engine_tpu_torch.tools.launcher [--cpu]
scripts/rts/main.py [args...]``
"""

from __future__ import annotations

import argparse
import ast
import datetime
import faulthandler
import importlib
import importlib.abc
import importlib.util
import json
import os
import runpy
import subprocess
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CRASH_DIR = os.path.join(ROOT, "crash_reports")

_JAX, _PORT = "permafrost_engine_tpu", "permafrost_engine_tpu_torch"


class PortFinder(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """``permafrost_engine_tpu.X`` -> the port's ``permafrost_engine_tpu_torch.X``
    (the same module object under both names)."""

    def find_spec(self, name, path=None, target=None):
        if name == _JAX or name.startswith(_JAX + "."):
            return importlib.util.spec_from_loader(name, self)
        return None

    def create_module(self, spec):
        return importlib.import_module(_PORT + spec.name[len(_JAX):])

    def exec_module(self, module):
        pass


def install_finder() -> None:
    """Put the port's finder first on ``sys.meta_path`` (once)."""
    if not any(isinstance(f, PortFinder) for f in sys.meta_path):
        sys.meta_path.insert(0, PortFinder())


def use_cpu() -> None:
    """Make ``Engine(...)`` and ``pf.init(...)`` default to the CPU."""
    from permafrost_engine_tpu_torch.game.engine import Engine
    from permafrost_engine_tpu_torch.script import pf

    Engine.__init__.__kwdefaults__["device"] = "cpu"
    pf.init.__kwdefaults__["device"] = "cpu"


def jax_modules() -> dict:
    """The loaded modules of ``jax``, ``jaxlib`` and ``flax``, and the
    ``permafrost_engine_tpu.*`` entries that are not the port's modules."""
    return dict(
        jax=sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "flax")),
        jax_pkg=sorted(m for m, mod in list(sys.modules.items())
                       if m.split(".")[0] == _JAX and mod is not None
                       and not mod.__name__.startswith(_PORT)))


def _main_module(script: str) -> str | None:
    """The module name of a script under the repository root that defines
    a top-level ``main()``; None for any other script."""
    path = os.path.abspath(script)
    rel = os.path.relpath(path, ROOT)
    if rel.startswith(os.pardir) or not rel.endswith(".py"):
        return None
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    if not any(isinstance(n, ast.FunctionDef) and n.name == "main"
               for n in tree.body):
        return None
    return rel[:-3].replace(os.sep, ".")


def run_script(script: str) -> None:
    name = _main_module(script)
    if name is None:
        runpy.run_path(script, run_name="__main__")
    else:
        importlib.import_module(name).main()


def _crash_report(path: str, script: str) -> None:
    import torch

    with open(path, "w") as f:
        f.write(f"script: {script}\nargv: {sys.argv}\n\n")
        f.write(traceback.format_exc())
        f.write("\n--- environment ---\n")
        f.write(f"torch={torch.__version__} cuda={torch.version.cuda} "
                f"cuda_available={torch.cuda.is_available()}\n")
        for k in ("CUDA_VISIBLE_DEVICES", "PYTHONPATH"):
            f.write(f"{k}={os.environ.get(k)}\n")
        try:
            rev = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                                 capture_output=True, text=True, timeout=5)
            f.write(f"git: {rev.stdout.strip() or rev.stderr.strip()}\n")
        except (OSError, subprocess.TimeoutExpired) as e:
            f.write(f"git: {e}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m permafrost_engine_tpu_torch.tools.launcher")
    ap.add_argument("--cpu", action="store_true",
                    help="Engine and pf.init default to the CPU")
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)

    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    install_finder()
    if args.cpu:
        use_cpu()
    sys.argv = [args.script] + args.args

    os.makedirs(CRASH_DIR, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S_%f")
    fault_path = os.path.join(CRASH_DIR, f"fault_{stamp}.log")
    fault_file = open(fault_path, "w")
    faulthandler.enable(file=fault_file, all_threads=True)
    faulthandler.dump_traceback_later(600, repeat=True, file=fault_file)
    try:
        run_script(args.script)
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    except BaseException:
        report = os.path.join(CRASH_DIR, f"crash_{stamp}.txt")
        _crash_report(report, args.script)
        print(f"[launcher] crash captured: {report}", file=sys.stderr)
        traceback.print_exc()
        return 1
    finally:
        faulthandler.cancel_dump_traceback_later()
        faulthandler.disable()
        fault_file.close()
        if os.path.getsize(fault_path) == 0:
            os.remove(fault_path)
        print("launcher modules: " + json.dumps(jax_modules()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
