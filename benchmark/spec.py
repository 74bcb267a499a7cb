"""``BENCHMARK.json``: loading, the checks of its names and units, and
finding each piece of a cell by name.

A workload names its configuration and its traffic mix. The files a cell
resolves to, each found by a name in ``BENCHMARK.json``:

- ``benchmark/configs/<config>.json`` (the configuration entry's
  ``file``): the configuration's sizes, as run;
- ``benchmark/limits/<config>.json`` (``limits_file``): the limit of every
  number that decides ``correct`` for the configuration's cells; a run
  compares each number named there, and a named number that nothing
  reported fails it;
- ``benchmark/traffic/<traffic>.json``: a file of parameters whose
  ``generator`` names the module ``benchmark/generators/<name>.py`` that
  reads it (its ``Cell``, the interface in
  ``benchmark/generators/__init__.py``);
- ``benchmark/metrics/<metric>.py`` for each metric the cell reports,
  whose ``read(m)`` takes the run's measurements and returns the value, or
  None where it finds nothing to read; a metric with no file of its own
  (``frame_ms.combined``) is read by the reader of its name without its
  last suffix (``frame_ms``).

So a configuration is added as new files and entries alone: its
configuration file and its limits file; a traffic file, with a new
generator (subclassing ``contact.Cell``) only where no generator reads
its traffic; the plain reference of what the generator's own numbers
compare, as new modules under ``benchmark/reference/``; and entries in
``BENCHMARK.json`` for the configuration, its cells and any metric name
they add. Nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent

NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _name(value, what: str) -> None:
    if not isinstance(value, str) or not NAME_RE.fullmatch(value):
        raise ValueError(f"{what}: {value!r} is not a name (letters, digits, "
                         "'_', '.', '-', at most 64, not starting with . or -)")


def _line(value, what: str) -> None:
    if (not isinstance(value, str) or not 1 <= len(value) <= 200
            or "\n" in value or "\t" in value):
        raise ValueError(f"{what}: must be 1 to 200 characters on one line")


def validate(doc: dict) -> None:
    """Raise ValueError where `doc` breaks the rules of names, units and
    entries that the benchmark keeps."""
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(doc) != keys:
        raise ValueError(f"BENCHMARK.json keys {sorted(doc)} != {sorted(keys)}")
    seen: set = set()
    for c in doc["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            raise ValueError(f"config {c.get('name')}: keys {sorted(c)}")
        _name(c["name"], "config name")
        _line(c["source"], f"config {c['name']} source")
        _line(c["why"], f"config {c['name']} why")
        for k in c["reduced"]:
            _name(k, f"config {c['name']} reduced key")
    for w in doc["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            raise ValueError(f"workload {w.get('name')}: keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            _name(w[k], f"workload {k}")
        _line(w["why"], f"workload {w['name']} why")
        if w["chips"] not in (1, 4):
            raise ValueError(f"workload {w['name']}: chips must be 1 or 4")
    for group in ("end_to_end", "per_layer"):
        for m in doc[group]:
            want = ({"name", "unit", "better", "bound", "source"}
                    if group == "end_to_end" else
                    {"name", "unit", "better", "source", "layer", "moves"})
            if not set(m) - {"workloads"} == want:
                raise ValueError(f"metric {m.get('name')}: keys {sorted(m)}")
            _name(m["name"], "metric name")
            if m["name"] in seen:
                raise ValueError(f"metric {m['name']} twice")
            seen.add(m["name"])
            if not isinstance(m["unit"], str) or not UNIT_RE.fullmatch(
                    m["unit"]):
                raise ValueError(f"metric {m['name']}: unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                raise ValueError(f"metric {m['name']}: better {m['better']!r}")
            if m["source"] not in SOURCES:
                raise ValueError(f"metric {m['name']}: source {m['source']!r}")
            if group == "per_layer":
                _line(m["layer"], f"metric {m['name']} layer")


class Spec:
    """A loaded, checked ``BENCHMARK.json``."""

    def __init__(self, doc: dict):
        validate(doc)
        self.doc = doc
        self.configs = {c["name"]: c for c in doc["configs"]}
        self.workloads = {w["name"]: w for w in doc["workloads"]}

    @classmethod
    def load(cls, path: Path | None = None) -> "Spec":
        with open(path or ROOT / "BENCHMARK.json") as f:
            return cls(json.load(f))

    def workload(self, name: str) -> dict:
        if name not in self.workloads:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return self.workloads[name]

    def config(self, wl: dict) -> dict:
        """The workload's configuration file, parsed."""
        with open(ROOT / self.configs[wl["config"]]["file"]) as f:
            return json.load(f)

    def traffic(self, wl: dict) -> dict:
        with open(BENCH_DIR / "traffic" / f"{wl['traffic']}.json") as f:
            return json.load(f)

    def generator(self, wl: dict):
        """The ``Cell`` class of the generator the workload's traffic file
        names."""
        return generator(self.traffic(wl)["generator"])

    def metrics(self, wl: dict, trace: bool) -> list[dict]:
        """The metrics a run of the workload reports: the end-to-end ones
        (``trace`` false) or the per-layer ones, each kept where its
        ``workloads`` list names the cell or it has none."""
        group = self.doc["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if "workloads" not in m or wl["name"] in m["workloads"]]


def generator(name: str):
    """The ``Cell`` class of ``benchmark/generators/<name>.py``."""
    if not name.isidentifier():
        raise ValueError(f"generator {name!r} is not a module name")
    return importlib.import_module(f"benchmark.generators.{name}").Cell


def limits_file(config: str) -> Path:
    """The limits file of configuration `config`."""
    return BENCH_DIR / "limits" / f"{config}.json"


def reader(name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``, or of the
    name without its last suffix where the metric has no file of its
    own."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        return reader(name.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
