"""Session save/load: full-engine checkpoint and resume.

Port of ``permafrost_engine_tpu/core/session.py``. The reference serializes
the entire engine session — global state, every subsystem's entity
streams, and the whole Python interpreter — through self-describing attr
records (ref: src/session.c:176-233, src/lib/public/attr.h:44-73,
py_pickle.c). Here nearly all simulation state lives in one tree of
tensors:

  * device state -> ``state/convert.state_to_numpy``'s dicts of numpy
    arrays (exact), restored through ``state_from_numpy`` on the device
    the loader asks for: the blob does not depend on the device that saved
    it
  * host bookkeeping (uid<->slot maps, free lists, flock/field caches,
    settings, task states) -> a graph-pickled dict (``core/pickling.py``)
  * resumed sessions continue deterministically: the tick is pure and the
    saved state includes tick counters, velocity histories and
    interpolation sources (the reference's determinism contract,
    SURVEY §5 checkpoint notes)

Beyond the JAX blob, the port's carries the host state a continuation
reads that the JAX loader resets: the nav cadence's pending snapshot and
field signatures, the replan clocks, the nav and diplomacy versions, the
nav service's derived host state (portal graphs, islands, blocked-edge
cache, detour flags) and the economy's transport counts. So a loaded
engine continues bit-identically to the uninterrupted one, at war too.

A subsession stack (exec_push/exec_pop, ref: session.h:58-60) is layered
on top by keeping saved blobs in memory.
"""

from __future__ import annotations

import dataclasses
import io
import pickle

import numpy as np

from permafrost_engine_tpu_torch.core import pickling as graphpickle
from permafrost_engine_tpu_torch.core.config import EngineConfig
from permafrost_engine_tpu_torch.state.convert import (state_from_numpy,
                                                       state_to_numpy)

FORMAT_VERSION = 4


def engine_tokens(engine) -> dict[str, object]:
    """Engine-side singletons swapped for named tokens in the blob and
    re-bound to the freshly built engine at load. Script closures that
    captured e.g. the event bus keep working after a fresh-process load."""
    return {
        "ENGINE": engine, "BUS": engine.bus, "SCHED": engine.sched,
        "SETTINGS": engine.settings, "ECONOMY": engine.economy,
        "NAV": engine.nav, "REGIONS": engine.regions,
        "SELECTION": engine.selection, "ANIM": engine.anim,
        "AUDIO": engine.audio, "PERF": engine.perf,
    }


def _picklable(obj) -> bool:
    return graphpickle.picklable(obj)


def _cadence_snapshot(engine):
    """The nav cadence's pending device snapshot as host arrays."""
    if engine._sigs_inflight is None:
        return None
    frame, snap = engine._sigs_inflight
    return frame, tuple(None if t is None else t.cpu().numpy() for t in snap)


def save_session_bytes(engine, *, script_state=None, extra_tokens=None,
                       by_value=None) -> bytes:
    """Serialize an Engine (game/engine.py) to bytes.

    Covers every subsystem's state the way the reference's subsession_save
    serializes per-subsystem entity streams (ref: src/session.c:176-233,
    src/game/game.c:3679-3713): device state, nav caches (flow + LOS),
    economy/garrison components, regions, selection, anim, audio, and
    scheduler tasks (live tasks resume mid-execution via replay logs).

    `script_state` (any object graph — a script layer's whole context
    image) rides in the same GraphPickler stream as the host dict, so
    objects shared between task closures and event handlers keep one
    identity across the save (the reference gets this from pickling the
    whole interpreter in one pass, py_pickle.c).
    """
    engine.flush_deltas()   # no in-flight events may be lost in the blob
    state_np = state_to_numpy(engine.state)
    tokens = {id(o): name for name, o in engine_tokens(engine).items()}
    for oid, name in (extra_tokens or {}).items():
        tokens[oid] = name

    def probe(rec):
        # serializability under the REAL save conditions: tokenized
        # engine singletons + the script-territory by-value policy
        return graphpickle.picklable(rec, tokens=tokens, by_value=by_value)

    eco = engine.economy
    host = {
        "frame": engine._frame,
        "sim_state": engine.sim_state,
        "economy_period": engine.economy_period,
        "drain_period": engine.drain_period,
        "seek_refresh_period": engine.seek_refresh_period,
        "next_uid": engine._next_uid,
        "free_slots": list(engine._free_slots),
        "uid_to_slot": dict(engine.uid_to_slot),
        "unit_type": dict(engine.unit_type),
        "slot_uid": engine._slot_uid,
        "free_flocks": list(engine._free_flocks),
        "gslot_owner": dict(engine._gslot_owner),
        "seek_flocks": dict(engine._seek_flocks),
        "chase_gslot": dict(engine._chase_gslot),
        "host_factions": set(engine._host_factions),
        "host_diplomacy": engine._host_diplomacy,
        "structures": dict(engine._structures),
        # the nav service's keys: nav_* and nav_derived
        **engine.nav.host_state(),
        "cadence": {
            "sigs_inflight": _cadence_snapshot(engine),
            "seek_created": dict(engine._seek_created),
            "field_sigs": dict(engine._field_sigs),
            "blocker_replan_frame": dict(engine._blocker_replan_frame),
            "nav_version": engine._nav_version,
            "diplo_version": engine._diplo_version,
        },
        "events": list(engine.events),
        # host subsystems (ref: G_SaveEntityState streams)
        "economy": {
            "resources": eco.resources, "harvesters": eco.harvesters,
            "storages": eco.storages, "buildings": eco.buildings,
            "builders": eco.builders, "garrisons": eco.garrisons,
            "population": eco.population,
            "resource_icons": eco.resource_icons,
            "_transport_assigned": eco._transport_assigned,
        },
        "regions": engine.regions.regions,
        "selection": {
            "enabled": engine.selection.enabled,
            "selection": list(engine.selection.selection),
            "hovered": engine.selection.hovered,
        },
        "anim_states": engine.anim.states,
        "anim_models": {k: v for k, v in engine.anim.models.items()
                        if _picklable(v)},
        "audio": engine.audio.__dict__,
        # scheduler image: replayable tasks resume mid-execution via their
        # resume/effect logs; others restart from entry with their state
        # (ref: py_task.c:654 mid-execution fiber pickling)
        "sched": engine.sched.snapshot(probe=probe),
        "settings": engine.settings.snapshot(),
    }

    # boot (plain pickle): just enough to construct the Engine that the
    # graph-pickled part's tokens resolve against
    boot = {
        "cfg": dataclass_dict(engine.cfg),
        "nav_terrain_cost": engine.nav.terrain_cost,
        "map_data": engine.map_data,
    }
    rest = graphpickle.dumps({"host": host, "script": script_state},
                             tokens=tokens, by_value=by_value)
    buf = io.BytesIO()
    pickle.dump({"version": FORMAT_VERSION, "boot": boot,
                 "state": state_np, "rest": rest}, buf, protocol=4)
    return buf.getvalue()


def dataclass_dict(cfg) -> dict:
    """An ``EngineConfig`` as a plain dict of its fields."""
    return dataclasses.asdict(cfg)


def load_session_bytes(data: bytes, *, device="cuda", extra_resolve=None,
                       return_script: bool = False):
    """Reconstruct an Engine on `device` (the card unless the caller asks
    for ``"cpu"``) from bytes; returns the new Engine (or
    `(engine, script_state)` with return_script=True).

    `extra_resolve(engine) -> dict[str, object]` supplies additional
    token bindings (a script layer binds its fresh context)."""
    from permafrost_engine_tpu_torch.game.engine import Engine

    blob = pickle.loads(data)
    version = blob.get("version")
    if version != FORMAT_VERSION:
        raise ValueError(
            f"unsupported session version {version} "
            f"(expected {FORMAT_VERSION}; the device-state schema is not "
            f"compatible across versions)")

    boot = blob["boot"]
    cfg = EngineConfig(**boot["cfg"])
    engine = Engine(cfg, device=device,
                    cost_base=np.asarray(boot["nav_terrain_cost"]))
    if boot.get("map_data") is not None:
        # restores heights + the height-aware tick before state overwrite
        engine.load_map_data(boot["map_data"])
    engine.state = state_from_numpy(blob["state"], engine.device)

    resolve = {name: o for name, o in engine_tokens(engine).items()}
    for name, o in (extra_resolve(engine) if extra_resolve else {}).items():
        resolve[name] = o
    rest = graphpickle.loads(blob["rest"], resolve=resolve,
                             device=engine.device)
    host = rest["host"]
    script_state = rest.get("script")

    engine._frame = host["frame"]
    engine.sim_state = host["sim_state"]
    engine.economy_period = host["economy_period"]
    engine.drain_period = host["drain_period"]
    engine.seek_refresh_period = host["seek_refresh_period"]
    engine._next_uid = host["next_uid"]
    engine._free_slots = list(host["free_slots"])
    engine.uid_to_slot = dict(host["uid_to_slot"])
    engine.unit_type = {k: tuple(v) for k, v in host["unit_type"].items()}
    engine._slot_uid = np.asarray(host["slot_uid"])
    engine._free_flocks = list(host["free_flocks"])
    engine._gslot_owner = dict(host["gslot_owner"])
    engine._seek_flocks = dict(host["seek_flocks"])
    engine._chase_gslot = dict(host["chase_gslot"])
    engine._host_factions = set(host["host_factions"])
    engine._host_diplomacy = np.asarray(host["host_diplomacy"])
    engine._structures = dict(host["structures"])
    engine.events = list(host["events"])

    engine.nav.load_host_state(host)

    cad = host["cadence"]
    if cad["sigs_inflight"] is not None:
        frame, arrays = cad["sigs_inflight"]
        engine._sigs_inflight = (frame, tuple(
            None if a is None else engine._to_device(a) for a in arrays))
    engine._seek_created = dict(cad["seek_created"])
    engine._field_sigs = dict(cad["field_sigs"])
    engine._blocker_replan_frame = dict(cad["blocker_replan_frame"])
    engine._nav_version = cad["nav_version"]
    engine._diplo_version = cad["diplo_version"]

    # host subsystems
    eco = engine.economy
    for field, value in host["economy"].items():
        setattr(eco, field, value)
    engine.regions.regions = host["regions"]
    sel = host["selection"]
    engine.selection.enabled = sel["enabled"]
    engine.selection.selection = list(sel["selection"])
    engine.selection.hovered = sel["hovered"]
    engine.anim.states = host["anim_states"]
    engine.anim.models.update(host["anim_models"])
    engine.audio.__dict__.update(host["audio"])
    engine.sched.restore(host["sched"])
    engine.settings.restore(host["settings"])
    if return_script:
        return engine, script_state
    return engine


def save_session(engine, path: str) -> None:
    with open(path, "wb") as f:
        f.write(save_session_bytes(engine))


def load_session(path: str, *, device="cuda"):
    with open(path, "rb") as f:
        return load_session_bytes(f.read(), device=device)


class SubsessionStack:
    """exec_push/exec_pop semantics (ref: session.h:58-60): push saves the
    current session and starts a fresh one; pop restores, on `device`."""

    def __init__(self, device="cuda"):
        self.device = device
        self._stack: list[bytes] = []

    def push(self, engine) -> None:
        self._stack.append(save_session_bytes(engine))

    def pop(self):
        if not self._stack:
            raise IndexError("subsession stack empty")
        return load_session_bytes(self._stack.pop(), device=self.device)

    def pop_to_root(self):
        if not self._stack:
            raise IndexError("subsession stack empty")
        root = self._stack[0]
        self._stack.clear()
        return load_session_bytes(root, device=self.device)

    @property
    def depth(self) -> int:
        return len(self._stack)
