"""PyTorch port: session save/load and the graph pickler, against the JAX
package's.

* ``tests/test_session.py``'s three cases on the port (on the CPU): the
  round trip at war (bit-equal state after the load and after 60 more
  frames on both engines, and a loaded engine still plans paths); the
  mid-harvest session (every host stream restored, and the loaded engine
  continues bit-identically to the uninterrupted one, which delivers the
  same wood as the JAX engine run through the same calls, positions within
  1e-3); the subsession stack.
* A fresh interpreter saves a mid-harvest session with a live task closure
  to a file, another loads it: both continue exactly as the uninterrupted
  run, neither imports ``jax``, ``jaxlib``, ``flax`` or the JAX package.
* The port's pickler: the tensor reduce (a tensor comes back with its
  values and dtype onto the device the loader names, one object where it
  was shared) and a sample of ``tests/test_pickle.py``'s cases (closures
  sharing a cell, shared identity, recursive containers) through both
  picklers, with the same results.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)

from permafrost_engine_tpu.core import pickling as jgp
from permafrost_engine_tpu.core import session as jsession
from permafrost_engine_tpu.game.economy import HarvesterComp as JHarvester
from permafrost_engine_tpu.game.economy import ResourceComp as JResource
from permafrost_engine_tpu.game.economy import StorageComp as JStorage
from permafrost_engine_tpu.game.engine import Engine as JaxEngine
from permafrost_engine_tpu_torch.core import pickling as tgp
from permafrost_engine_tpu_torch.core.config import (DiplomacyState,
                                                     EngineConfig, EntityFlags)
from permafrost_engine_tpu_torch.core.session import (SubsessionStack,
                                                      load_session_bytes,
                                                      save_session_bytes)
from permafrost_engine_tpu_torch.game.economy import (HarvesterComp,
                                                      HarvesterState,
                                                      ResourceComp,
                                                      StorageComp)
from permafrost_engine_tpu_torch.game.engine import Engine
from permafrost_engine_tpu_torch.state.convert import state_to_numpy
import test_combat
import test_engine_move

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tcfg(cfg):
    return EngineConfig(**dataclasses.asdict(cfg))


def build_engine():
    """tests/test_session.py's build_engine on the port."""
    eng = Engine(_tcfg(test_combat.small_cfg()), device="cpu")
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(3)
    eng.spawn_batch((rng.random((6, 2)) * 100 + 30).astype(np.float32),
                    faction=0, max_speed=40.0)
    eng.spawn_batch((rng.random((4, 2)) * 50 + 150).astype(np.float32),
                    faction=1)
    uids = list(eng.uid_to_slot)
    eng.move(uids[:6], (200.0, 200.0))
    return eng


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    else:
        yield prefix, np.asarray(tree)


def assert_states_equal(a, b):
    la = dict(_leaves(state_to_numpy(a.state)))
    lb = dict(_leaves(state_to_numpy(b.state)))
    assert la.keys() == lb.keys()
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)


def test_save_load_roundtrip_and_determinism():
    eng = build_engine()
    eng.step(30)
    restored = load_session_bytes(save_session_bytes(eng), device="cpu")
    assert restored.device == torch.device("cpu")
    assert_states_equal(eng, restored)
    assert restored.uid_to_slot == eng.uid_to_slot
    assert restored._next_uid == eng._next_uid
    assert restored._inflight is None
    # both continue identically, through the war cadence at frames 60, 90
    eng.step(60)
    restored.step(60)
    assert_states_equal(eng, restored)
    assert restored.events == eng.events
    uids = list(restored.uid_to_slot)
    assert restored.move(uids[:2], (50.0, 220.0))


def _mid_harvest(kind):
    """tests/test_session.py's mid-harvest scene on either engine, run to
    mid-cycle."""
    if kind == "jax":
        eng = JaxEngine(test_engine_move.small_cfg())
        comps = JHarvester, JResource, JStorage
    else:
        eng = Engine(_tcfg(test_engine_move.small_cfg()), device="cpu")
        comps = HarvesterComp, ResourceComp, StorageComp
    eng.economy_period = 3
    h = eng.spawn_batch(np.array([[100.0, 100.0]], np.float32),
                        max_speed=120.0)[0]
    eng.economy.harvesters[h] = comps[0](gather_speeds={"Wood": 5},
                                         max_carry={"Wood": 10})
    r = eng.spawn_batch(np.array([[140.0, 100.0]], np.float32),
                        flags=int(EntityFlags.RESOURCE))[0]
    eng.economy.resources[r] = comps[1]("Wood", 30, 30)
    s = eng.spawn_batch(np.array([[100.0, 140.0]], np.float32),
                        flags=int(EntityFlags.STORAGE_SITE))[0]
    eng.economy.storages[s] = comps[2](capacity={"Wood": 100})
    eng.regions.add_circle("depot", (100.0, 140.0), 30.0)
    eng.selection.selection = [h]
    eng.anim.register(h, model="worker")
    eng.audio.tracks = ["theme"]
    eng.audio.play_music("theme")
    eng.economy.gather(h, r)
    for _ in range(20):
        eng.step(6)
        if eng.economy.harvesters[h].state in (HarvesterState.HARVESTING,
                                               HarvesterState.TO_STORAGE):
            break
    return eng, h, r, s


def _deliver(eng, s):
    for _ in range(80):
        eng.step(6)
        if eng.economy.storages[s].stored.get("Wood", 0) >= 20:
            break


def test_mid_harvest_session_continues_identically():
    eng, h, r, s = _mid_harvest("port")
    st = eng.economy.harvesters[h].state
    assert st in (HarvesterState.HARVESTING, HarvesterState.TO_STORAGE)
    restored = load_session_bytes(save_session_bytes(eng), device="cpu")
    assert restored.economy.harvesters[h].state == st
    assert (restored.economy.harvesters[h].carried
            == eng.economy.harvesters[h].carried)
    assert (restored.economy.resources[r].amount
            == eng.economy.resources[r].amount)
    assert "depot" in restored.regions.regions
    assert restored.selection.selection == [h]
    assert h in restored.anim.states
    assert restored.audio.current == "theme" and restored.audio.playing

    # the JAX engine through the same calls, saved and loaded by its own
    # session code
    jeng, _, _, js = _mid_harvest("jax")
    jrest = jsession.load_session_bytes(jsession.save_session_bytes(jeng))
    for e in (eng, restored, jeng, jrest):
        _deliver(e, s)
    assert (eng.economy.storages[s].stored
            == restored.economy.storages[s].stored
            == jrest.economy.storages[js].stored)
    assert restored.economy.storages[s].stored.get("Wood", 0) >= 20
    assert restored._frame == eng._frame == jrest._frame
    assert_states_equal(eng, restored)
    assert restored.events == eng.events == jrest.events
    np.testing.assert_allclose(restored.state.ents.pos.numpy(),
                               np.asarray(jrest.state.ents.pos), atol=1e-3)


def test_subsession_stack():
    eng = build_engine()
    stack = SubsessionStack(device="cpu")
    p_before = eng.pos_of(1).copy()
    stack.push(eng)
    assert stack.depth == 1
    eng.step(120)
    assert np.linalg.norm(eng.pos_of(1) - p_before) > 1.0
    restored = stack.pop()
    np.testing.assert_allclose(restored.pos_of(1), p_before)
    assert stack.depth == 0
    with pytest.raises(IndexError):
        stack.pop()


# -- a fresh interpreter saves, another loads --------------------------------

_FRESH = """
import hashlib, sys
import numpy as np
from permafrost_engine_tpu_torch.core.config import EngineConfig, EntityFlags
from permafrost_engine_tpu_torch.core.events import EventType
from permafrost_engine_tpu_torch.core.sched import Sleep
from permafrost_engine_tpu_torch.core.session import (load_session_bytes,
                                                      save_session_bytes)
from permafrost_engine_tpu_torch.game.economy import (HarvesterComp,
                                                      ResourceComp, StorageComp)
from permafrost_engine_tpu_torch.game.engine import Engine
from permafrost_engine_tpu_torch.state.convert import state_to_numpy


def digest(eng):
    h = hashlib.sha256()
    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            h.update(np.ascontiguousarray(t).tobytes())
    walk(state_to_numpy(eng.state))
    eco = eng.economy
    h.update(repr((sorted((u, vars(c)) for u, c in eco.harvesters.items()),
                   sorted((u, c.stored) for u, c in eco.storages.items()),
                   eng.events, eng._frame)).encode())
    return h.hexdigest()[:16]


def continue_(eng, marks):
    eng.bus.subscribe(EventType.SCRIPT_BASE + 1, marks.append)
    for _ in range(20):
        eng.step(6)
    return digest(eng)


def build():
    cfg = EngineConfig(max_ents=64, chunks_r=2, chunks_c=2, num_layers=1,
                       max_flocks=8, max_projectiles=32, field_slab_slots=16,
                       los_slab_slots=16)
    eng = Engine(cfg, device="cpu")
    eng.economy_period = 3
    h = eng.spawn_batch(np.array([[100.0, 100.0]], np.float32),
                        max_speed=120.0)[0]
    eng.economy.harvesters[h] = HarvesterComp(gather_speeds={"Wood": 5},
                                              max_carry={"Wood": 10})
    r = eng.spawn_batch(np.array([[140.0, 100.0]], np.float32),
                        flags=int(EntityFlags.RESOURCE))[0]
    eng.economy.resources[r] = ResourceComp("Wood", 30, 30)
    s = eng.spawn_batch(np.array([[100.0, 140.0]], np.float32),
                        flags=int(EntityFlags.STORAGE_SITE))[0]
    eng.economy.storages[s] = StorageComp(capacity={"Wood": 100})
    eng.economy.gather(h, r)
    bus, label = eng.bus, "ticker"

    def ticker(task):
        # the closure captures the bus (a session token) and a label; its
        # world mutation goes through task.effect, so a replay skips it
        task.state["n"] = 0
        while True:
            yield Sleep(7)
            task.state["n"] += 1
            task.effect(bus.notify, EventType.SCRIPT_BASE + 1,
                        (label, task.state["n"]))

    eng.sched.create(ticker)
    return eng


mode, path = sys.argv[1], sys.argv[2]
if mode == "save":
    eng = build()
    eng.step(60)
    with open(path, "wb") as f:
        f.write(save_session_bytes(eng))
    marks = []
    print("after", continue_(eng, marks), marks[-1])
else:
    with open(path, "rb") as f:
        eng = load_session_bytes(f.read(), device="cpu")
    assert len(eng.sched.tasks) == 1
    marks = []
    print("after", continue_(eng, marks), marks[-1])
bad = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "jaxlib", "flax", "permafrost_engine_tpu"))
assert not bad, bad
"""


def test_fresh_interpreter_save_and_load(tmp_path):
    """One fresh interpreter saves a mid-harvest session with a live task
    closure and continues; another loads the blob and continues: equal
    state and economy digests, equal task marks, no JAX module in either."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = _REPO
    env["OMP_NUM_THREADS"] = "1"
    path = str(tmp_path / "session.bin")
    out = []
    for mode in ("save", "load"):
        res = subprocess.run([sys.executable, "-c", _FRESH, mode, path],
                             cwd=_REPO, env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        out.append(res.stdout.strip().splitlines()[-1])
    assert out[0] == out[1], out
    # marks every 7 frames, from frame 8 to frame 176 of the 180
    assert "('ticker', 25)" in out[0]


# -- the pickler -----------------------------------------------------------------


def test_tensor_reduce_restores_onto_the_loaders_device():
    a = torch.arange(6, dtype=torch.int32).reshape(2, 3)
    b = torch.tensor([True, False])
    blob = tgp.dumps({"a": a, "again": a, "b": b, "f": torch.zeros(2)})
    got = tgp.loads(blob, device="cpu")
    assert got["a"] is got["again"]
    assert got["a"].dtype == torch.int32 and torch.equal(got["a"], a)
    assert got["b"].dtype == torch.bool and torch.equal(got["b"], b)
    assert got["f"].device == torch.device("cpu")
    # the stream names no JAX module and refers to torch by name only
    assert b"jax" not in blob and b"flax" not in blob


def _closure_pair():
    c = 0

    def inc():
        nonlocal c
        c += 1
        return c

    def get():
        return c
    return inc, get


def _pickle_cases(gp, **kw):
    """A sample of tests/test_pickle.py through one pickler; returns what
    each case observes."""
    out = {}
    inc, get = _closure_pair()
    inc()
    inc2, get2 = gp.loads(gp.dumps((inc, get)), **kw)
    out["closure"] = (get2(), inc2(), get2())
    shared = {"k": [1, 2]}
    box = gp.loads(gp.dumps([shared, shared, (shared,)]), **kw)
    out["shared"] = (box[0] is box[1], box[2][0] is box[0], box[0])
    fbox = gp.loads(gp.dumps({"a": shared, "fn": (lambda: shared)}), **kw)
    out["shared_closure"] = fbox["fn"]() is fbox["a"]
    lst = [1]
    lst.append(lst)
    d = {}
    d["self"] = d
    t = ([],)
    t[0].append(t)
    got = gp.loads(gp.dumps((lst, d, t)), **kw)
    out["recursive"] = (got[0][1] is got[0], got[1]["self"] is got[1],
                        got[2][0][0] is got[2])
    return out


def test_pickle_cases_match_jax():
    port = _pickle_cases(tgp, device="cpu")
    assert port == _pickle_cases(jgp)
    assert port["closure"] == (1, 2, 2)
    assert all(port["recursive"]) and port["shared_closure"]


def test_blob_stores_no_jax_names():
    """The port's safe roots name torch and the port, not the JAX stack."""
    roots = tgp._SAFE_MODULE_ROOTS
    assert {"torch", "permafrost_engine_tpu_torch"} <= roots
    assert not roots & {"jax", "jaxlib", "flax", "permafrost_engine_tpu"}
    blob = save_session_bytes(build_engine())
    assert b"permafrost_engine_tpu." not in blob and b"jax" not in blob
    boot = pickle.loads(blob)["boot"]
    assert boot["cfg"]["max_ents"] == 32
