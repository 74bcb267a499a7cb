"""Cooperative task scheduler: generator-based tasks with microkernel IPC.

The port's own copy of ``permafrost_engine_tpu/core/sched.py``, on the
port's ``core/events.py``.

The reference runs game logic in userspace fibers with a
Send/Receive/Reply IPC protocol, AwaitEvent integration with the event
bus, and a name server (ref: src/sched.c:155-178, src/sched.h:94-133,
src/task.h:51-70). The device does all the heavy lifting here, so tasks
are host-side Python generators that *yield request objects* — the same
request protocol, without assembly context switches:

    def my_task(task):
        msg, sender = yield Receive()
        yield Reply(sender, "ack")
        yield Sleep(30)          # 30 ticks
        ev = yield AwaitEvent(EventType.MOTION_END)

Determinism: tasks run in creation order each tick, a fixed quota per
tick.

Mid-execution persistence (the py_pickle.c/py_task.c:654 analogue):
CPython 3 cannot pickle a live generator frame, so suspended tasks are
persisted by DETERMINISTIC REPLAY instead — the scheduler records every
value fed into the generator (the resume log) plus the results of any
world mutations routed through `task.effect(fn, *args)` (the effect
log). On session load the generator is re-created and fast-forwarded by
replaying the logs: recorded resume values are fed back in and effect()
returns recorded results without re-executing, so the frame lands back
on the exact yield it was suspended at, locals reconstructed by the
task's own code. Requirements (documented contract): the code between
yields must be deterministic given the same resume values, and world
mutations must go through effect(). Tasks that exceed the replay-log cap
or yield unpicklable values fall back to restart-from-entry with their
persisted `state` dict (the previous behavior).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Generator

from permafrost_engine_tpu_torch.core.events import EventBus, EventType


# -- request protocol (ref: sched.h:120-133) -----------------------------------

@dataclasses.dataclass
class Yield:
    """Reschedule; resume next tick."""


@dataclasses.dataclass
class Sleep:
    ticks: int


@dataclasses.dataclass
class Send:
    to: int          # tid
    msg: Any


@dataclasses.dataclass
class Receive:
    """Block until a message arrives; yields (msg, sender_tid)."""


@dataclasses.dataclass
class Reply:
    to: int
    msg: Any


@dataclasses.dataclass
class AwaitEvent:
    event: int


@dataclasses.dataclass
class Register:
    name: str


@dataclasses.dataclass
class WhoIs:
    name: str        # yields tid or None


_RUNNING, _READY, _BLOCKED_RECV, _BLOCKED_REPLY, _BLOCKED_EVENT, _SLEEPING, _DONE = range(7)


REPLAY_LOG_CAP = 2048   # resumes; beyond this a task is restart-only


class ReplayMismatch(RuntimeError):
    """Replay diverged from the recorded run (non-deterministic task)."""


class Task:
    def __init__(self, tid: int, fn: Callable, args: tuple, name: str | None):
        self.tid = tid
        self.fn = fn
        self.args = args
        self.name = name or fn.__name__
        self.state: dict = {}           # picklable user state
        self.state0: dict | None = None  # state at generator start — the
        # base a restore-replay re-derives from (body mutations like
        # `state["n"] += 1` re-run during replay; starting from the saved
        # state would double-apply them)
        self.gen: Generator = fn(self, *args)
        self.status = _READY
        self.inbox: deque[tuple[Any, int]] = deque()
        self.reply_waiters: deque[int] = deque()   # tids awaiting our reply
        self.wake_tick = 0
        self.send_value: Any = None     # value passed into next resume
        self.result: Any = None
        # mid-execution persistence (deterministic replay)
        self.replayable = True
        self.resume_log: list = []      # values sent into the generator
        self.request_log: list[str] = []  # yielded request type names
        self.effect_log: list = []      # recorded effect() results
        self.replaying = False
        self._replay_effects: deque = deque()

    def effect(self, fn: Callable, *args, **kw):
        """Run a world mutation exactly once across save/replay: executed
        live, skipped on replay with the recorded result returned."""
        if self.replaying:
            if not self._replay_effects:
                raise ReplayMismatch(f"task {self.tid}: effect underflow")
            return self._replay_effects.popleft()
        res = fn(*args, **kw)
        if self.replayable:
            self.effect_log.append(res)
        return res


class Scheduler:
    """Deterministic cooperative scheduler (ref: src/sched.c)."""

    def __init__(self, events: EventBus | None = None, max_tasks: int = 8192):
        self.events = events
        self.max_tasks = max_tasks
        self.tasks: dict[int, Task] = {}
        self._next_tid = 1
        self._names: dict[str, int] = {}
        self._tick = 0
        self._event_waiters: dict[int, list[int]] = {}

    # -- task management ---------------------------------------------------------

    def create(self, fn: Callable, *args, name: str | None = None) -> int:
        if len(self.tasks) >= self.max_tasks:
            raise RuntimeError("task table full")
        tid = self._next_tid
        self._next_tid += 1
        self.tasks[tid] = Task(tid, fn, args, name)
        return tid

    def alive(self, tid: int) -> bool:
        return tid in self.tasks and self.tasks[tid].status != _DONE

    def send(self, tid: int, msg: Any, sender: int = 0) -> None:
        """Host -> task message injection."""
        t = self.tasks.get(tid)
        if t is None:
            return
        t.inbox.append((msg, sender))
        if t.status == _BLOCKED_RECV:
            t.status = _READY
            t.send_value = t.inbox.popleft()

    def post_event(self, event: int, arg: Any = None) -> None:
        """Wake tasks awaiting this event (wire the engine's event drain
        here; ref: Task_AwaitEvent, task.h:62)."""
        for tid in self._event_waiters.pop(int(event), []):
            t = self.tasks.get(tid)
            if t is not None and t.status == _BLOCKED_EVENT:
                t.status = _READY
                t.send_value = arg

    # -- the tick ------------------------------------------------------------------

    def tick(self, quota: int | None = None) -> int:
        """Run every ready task one step (requests are cheap; a task runs
        until it yields). Returns number of task resumptions."""
        self._tick += 1
        runs = 0
        for tid in sorted(self.tasks):
            t = self.tasks.get(tid)
            if t is None:
                continue
            if t.status == _SLEEPING and self._tick >= t.wake_tick:
                t.status = _READY
            while t.status == _READY:
                runs += 1
                if quota is not None and runs > quota:
                    return runs
                if not self._resume(t):
                    break
        # reap finished tasks
        for tid in [k for k, v in self.tasks.items() if v.status == _DONE]:
            t = self.tasks.pop(tid)
            if t.name in self._names and self._names[t.name] == tid:
                del self._names[t.name]
        return runs

    def _resume(self, t: Task) -> bool:
        """Advance a task one request. Returns True if it stays READY."""
        val, t.send_value = t.send_value, None
        if t.replayable and not t.replaying:
            if t.state0 is None:
                import copy
                t.state0 = copy.deepcopy(t.state)
            t.resume_log.append(val)
            if len(t.resume_log) > REPLAY_LOG_CAP:
                t.replayable = False
                t.resume_log = []
                t.request_log = []
                t.effect_log = []
        try:
            req = t.gen.send(val)
        except StopIteration as e:
            t.result = getattr(e, "value", None)
            t.status = _DONE
            # release reply-waiters of a dead task
            for wtid in t.reply_waiters:
                w = self.tasks.get(wtid)
                if w and w.status == _BLOCKED_REPLY:
                    w.status = _READY
                    w.send_value = None
            if self.events is not None:
                self.events.notify(int(EventType.SCRIPT_TASK_FINISHED),
                                   (t.tid, t.result))
            return False
        except Exception:
            # A faulting task dies; the engine keeps running (ref: the
            # reference displays the error and emits
            # EVENT_SCRIPT_TASK_EXCEPTION, py_task.c task_main's S_ShowLastError)
            import traceback
            traceback.print_exc()
            t.result = None
            t.status = _DONE
            for wtid in t.reply_waiters:
                w = self.tasks.get(wtid)
                if w and w.status == _BLOCKED_REPLY:
                    w.status = _READY
                    w.send_value = None
            if self.events is not None:
                self.events.notify(int(EventType.SCRIPT_TASK_EXCEPTION),
                                   (t.tid, traceback.format_exc()))
            return False

        if t.replayable and not t.replaying:
            t.request_log.append(type(req).__name__)
        if isinstance(req, Yield):
            t.status = _SLEEPING
            t.wake_tick = self._tick + 1
        elif isinstance(req, Sleep):
            t.status = _SLEEPING
            t.wake_tick = self._tick + max(1, req.ticks)
        elif isinstance(req, Send):
            target = self.tasks.get(req.to)
            if target is None:
                t.send_value = None     # send to dead task: None reply
                return True
            target.inbox.append((req.msg, t.tid))
            target.reply_waiters.append(t.tid)
            if target.status == _BLOCKED_RECV:
                target.status = _READY
                target.send_value = target.inbox.popleft()
            t.status = _BLOCKED_REPLY
        elif isinstance(req, Receive):
            if t.inbox:
                t.send_value = t.inbox.popleft()
                return True
            t.status = _BLOCKED_RECV
        elif isinstance(req, Reply):
            target = self.tasks.get(req.to)
            if target is not None and target.status == _BLOCKED_REPLY:
                target.status = _READY
                target.send_value = req.msg
            if req.to in t.reply_waiters:
                t.reply_waiters.remove(req.to)
            return True
        elif isinstance(req, AwaitEvent):
            t.status = _BLOCKED_EVENT
            self._event_waiters.setdefault(int(req.event), []).append(t.tid)
        elif isinstance(req, Register):
            self._names[req.name] = t.tid
            return True
        elif isinstance(req, WhoIs):
            t.send_value = self._names.get(req.name)
            return True
        else:
            raise TypeError(f"task {t.tid} yielded non-request {req!r}")
        return False

    # -- mid-execution persistence (deterministic replay) -----------------------

    def snapshot(self, probe=None) -> dict:
        """Serializable scheduler image. Replayable live tasks carry their
        resume/effect logs; others degrade to restart-from-entry records.

        `probe(rec) -> bool` tests serializability — session saves pass a
        GraphPickler probe (core/pickling.py), so closure/lambda entries
        and captured script objects survive; the stock-pickle default is
        kept for direct snapshot() callers."""
        if probe is None:
            import pickle

            def probe(rec):
                try:
                    pickle.dumps(rec, protocol=4)
                    return True
                except Exception:
                    return False
        tasks = []
        for t in self.tasks.values():
            if t.status == _DONE:
                continue
            rec = {
                "tid": t.tid, "name": t.name, "state": t.state,
                "fn": t.fn, "args": t.args,
                "status": t.status,
                "wake_delta": max(0, t.wake_tick - self._tick),
                "inbox": list(t.inbox),
                "reply_waiters": list(t.reply_waiters),
                "awaited_events": [ev for ev, tids in
                                   self._event_waiters.items()
                                   if t.tid in tids],
            }
            if t.replayable:
                rec.update(resume_log=t.resume_log,
                           request_log=t.request_log,
                           effect_log=t.effect_log,
                           state0=t.state0)
            if not probe(rec):
                # retry without the logs (some yielded value unserializable)
                rec.pop("resume_log", None)
                rec.pop("request_log", None)
                rec.pop("effect_log", None)
                if not probe(rec):
                    continue        # unserializable entry: drop (documented)
            tasks.append(rec)
        return {"tick": self._tick, "next_tid": self._next_tid,
                "names": dict(self._names), "tasks": tasks}

    def restore(self, snap: dict) -> int:
        """Rebuild tasks from a snapshot(); returns how many resumed
        mid-execution (vs restarted from entry)."""
        self.tasks.clear()
        self._event_waiters.clear()
        self._tick = snap.get("tick", 0)
        self._next_tid = snap.get("next_tid", 1)
        self._names = dict(snap.get("names", {}))
        resumed = 0
        for rec in snap.get("tasks", []):
            t = Task(rec["tid"], rec["fn"], tuple(rec["args"]), rec["name"])
            t.state = rec.get("state", {})
            replayed = False
            if "resume_log" in rec:
                # A failed (non-deterministic) replay leaves t.state as the
                # half-completed body mutated it; keep a pristine copy so the
                # restart-from-entry fallback sees the snapshotted state.
                import copy
                pristine = copy.deepcopy(t.state)
                base = rec.get("state0")
                if base is not None and isinstance(t.state, dict):
                    # replay re-derives the saved state from the generator-
                    # start base; reset IN PLACE so identity stays shared
                    # with script-side wrappers unpickled in the same stream
                    t.state.clear()
                    t.state.update(copy.deepcopy(base))
                    t.state0 = base
                try:
                    self._replay(t, rec["resume_log"], rec["request_log"],
                                 rec["effect_log"])
                    replayed = True
                    resumed += 1
                except Exception:
                    # non-deterministic replay: fresh generator, snapshot state
                    t.gen = t.fn(t, *t.args)
                    t.replaying = False
                    if isinstance(t.state, dict):
                        t.state.clear()
                        t.state.update(pristine)
                    else:
                        t.state = pristine
                    t.state0 = None
                    t.resume_log, t.request_log, t.effect_log = [], [], []
            if replayed:
                t.status = rec["status"]
                t.wake_tick = self._tick + rec.get("wake_delta", 0)
                t.inbox = deque(tuple(m) for m in rec.get("inbox", []))
                t.reply_waiters = deque(rec.get("reply_waiters", []))
                for ev in rec.get("awaited_events", []):
                    self._event_waiters.setdefault(int(ev), []).append(t.tid)
            self.tasks[t.tid] = t
        return resumed

    def _replay(self, t: Task, resume_log: list, request_log: list,
                effect_log: list) -> None:
        """Fast-forward a fresh generator through its recorded history."""
        t.replaying = True
        t._replay_effects = deque(effect_log)
        try:
            for i, val in enumerate(resume_log):
                req = t.gen.send(val)
                if type(req).__name__ != request_log[i]:
                    raise ReplayMismatch(
                        f"task {t.tid}: request {i} was {request_log[i]}, "
                        f"replayed {type(req).__name__}")
            if t._replay_effects:
                raise ReplayMismatch(f"task {t.tid}: effect overflow")
        finally:
            t.replaying = False
        t.resume_log = list(resume_log)
        t.request_log = list(request_log)
        t.effect_log = list(effect_log)
