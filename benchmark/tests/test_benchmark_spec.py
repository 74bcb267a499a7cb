"""BENCHMARK.json: every workload resolves to its files (configuration,
limits, traffic, generator), every metric to its reader, every generator
to a traffic file that names it, and names or units outside the allowed
characters are refused."""

import copy
import json

import pytest

from benchmark.generators import contact
from benchmark.spec import (BENCH_DIR, ROOT, Spec, generator, limits_file,
                            reader, validate)


def test_every_workload_resolves_to_its_files():
    spec = Spec.load()
    for name, wl in spec.workloads.items():
        conf = spec.config(wl)
        assert conf["name"] == wl["config"]
        assert conf["reduced"] == spec.configs[wl["config"]]["reduced"]
        assert json.loads(limits_file(wl["config"]).read_text())
        tr = spec.traffic(wl)
        assert tr["stepping"] in ("scan", "frame")
        assert callable(spec.generator(wl))
        for trace in (False, True):
            mets = spec.metrics(wl, trace)
            assert mets, (name, trace)
            for m in mets:
                assert callable(reader(m["name"]))
        names = {m["name"] for m in spec.metrics(wl, False)}
        assert "setup_s" in names and len(names) >= 2
    # every generator reads some traffic file, and every traffic file's
    # generator resolves to a cell of the interface
    named = set()
    for path in sorted((BENCH_DIR / "traffic").glob("*.json")):
        tr = json.loads(path.read_text())
        assert issubclass(generator(tr["generator"]), contact.Cell), path
        named.add(tr["generator"])
    mods = {p.stem for p in (BENCH_DIR / "generators").glob("*.py")}
    assert mods - {"__init__"} == named


def test_per_layer_moves_a_metric_of_each_of_its_cells():
    spec = Spec.load()
    for m in spec.doc["per_layer"]:
        for w in m["workloads"]:
            e2e = {x["name"] for x in spec.metrics(spec.workload(w), False)}
            assert m["moves"] in e2e, (m["name"], w)


def test_paths_hold_the_files_the_entries_name():
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in doc["configs"]:
        assert c["file"].startswith(doc["paths"][0] + "/")
        assert (ROOT / c["file"]).exists()
    for w in doc["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()


@pytest.mark.parametrize("where,value", [
    (("end_to_end", 0, "name"), "sim fps"),
    (("end_to_end", 0, "name"), "sim/fps"),
    (("end_to_end", 0, "name"), ".sim_fps"),
    (("end_to_end", 0, "unit"), "frames per second"),
    (("end_to_end", 0, "unit"), "µs"),
    (("per_layer", 0, "name"), "x" * 65),
    (("workloads", 0, "name"), "combined,contact"),
    (("workloads", 0, "config"), "battle 10k"),
    (("configs", 0, "reduced"), ["num layers"]),
])
def test_bad_names_and_units_are_refused(where, value):
    doc = copy.deepcopy(Spec.load().doc)
    group, i, key = where
    doc[group][i][key] = value
    with pytest.raises(ValueError):
        validate(doc)


def test_an_unknown_key_is_refused():
    doc = copy.deepcopy(Spec.load().doc)
    doc["end_to_end"][0]["why"] = "a key the contract does not allow"
    with pytest.raises(ValueError):
        validate(doc)
