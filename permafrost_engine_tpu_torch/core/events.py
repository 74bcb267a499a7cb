"""Event bus: global + per-entity pub/sub with queued and immediate delivery.

The port's own copy of ``permafrost_engine_tpu/core/events.py`` (same
names and ``EventType`` values).

Mirrors the reference's event system (ref: src/event.h:45-147, event.c):

* engine/script event ranges (EventType enum + arbitrary ints for scripts)
* global handlers and per-entity handlers keyed by uid
* queued delivery (`notify`) drained once per frame by `service_queue`,
  vs immediate synchronous delivery (`notify_immediate`)
* handlers filtered by a simulation-state mask (G_RUNNING / G_PAUSED_*)
* `queued_this_frame` coalescing check used by tick handlers
  (ref: E_QueuedThisFrame, movement.c:4417)
"""

from __future__ import annotations

from collections import defaultdict, deque
from enum import IntEnum
from typing import Any, Callable

from permafrost_engine_tpu_torch.core.config import SimState


class EventType(IntEnum):
    """Engine event range (scripts may use any int >= SCRIPT_BASE)."""
    UPDATE_START = 0
    UPDATE_UI = 1
    UPDATE_END = 2
    TICK_60HZ = 3
    TICK_30HZ = 4
    TICK_20HZ = 5
    TICK_10HZ = 6
    TICK_1HZ = 7
    MOTION_START = 10
    MOTION_END = 11
    ENTITY_DEATH = 12
    ATTACK_START = 13
    PROJECTILE_HIT = 14
    ENTITY_REMOVED = 15
    BUILDING_COMPLETED = 16
    BUILDING_FOUNDED = 17
    RESOURCE_EXHAUSTED = 18
    HARVEST_TARGET_ACQUIRED = 19
    STORAGE_TARGET_ACQUIRED = 20
    REGION_ENTERED = 21
    REGION_EXITED = 22
    GARRISON_ENTERED = 23
    GARRISON_EXITED = 24
    ORDER_ISSUED = 25
    SESSION_LOADED = 26
    SELECTION_CHANGED = 27
    GARRISONED_UNITS_CHANGED = 28
    ANIM_FINISHED = 29
    # -- remainder of the reference's engine event enum
    # (ref: src/event.h:60-131; values here are our own — scripts use the
    # symbolic names, which pf exports under the reference's spellings)
    UPDATE_FACTION = 30
    NEW_GAME = 31
    SELECTED_TILE_CHANGED = 32
    RENDER_3D_PRE = 33
    RENDER_3D_POST = 34
    RENDER_UI = 35
    RENDER_FINISH = 36
    TICK_15HZ = 37
    TICK_5HZ = 38
    TICK_HALFHZ = 39
    ANIM_CYCLE_FINISHED = 40
    MOVE_ISSUED = 41
    ENTITY_DEATH_IMMEDIATE = 42
    ATTACK_END = 43
    GAME_SIMSTATE_CHANGED = 44
    SESSION_POPPED = 45
    SESSION_SAVED = 46
    SESSION_FAIL_LOAD = 47
    SESSION_FAIL_SAVE = 48
    SCRIPT_TASK_EXCEPTION = 49
    SCRIPT_TASK_FINISHED = 50
    BUILD_BEGIN = 51
    BUILD_END = 52
    BUILD_FAIL_FOUND = 53
    BUILD_TARGET_ACQUIRED = 54
    BUILDING_CONSTRUCTED = 55
    ENTITY_DIED = 56
    ENTITY_STOP = 57
    HARVEST_BEGIN = 58
    HARVEST_END = 59
    TRANSPORT_TARGET_ACQUIRED = 60
    STORAGE_SITE_AMOUNT_CHANGED = 61
    RESOURCE_DROPPED_OFF = 62
    RESOURCE_PICKED_UP = 63
    RESOURCE_AMOUNT_CHANGED = 64
    PROJECTILE_DISAPPEAR = 65
    ENTITY_DISAPPEARED = 66
    MOVABLE_ENTITY_UNBLOCK = 67
    MOVABLE_ENTITY_BLOCK = 68
    BUILDING_PLACED = 69
    BUILDING_REMOVED = 70
    RALLY_POINT_SET = 71
    UNIT_BECAME_IDLE = 72
    UNIT_BECAME_ACTIVE = 73
    ENGINE_LAST = 0xFFFF
    SCRIPT_BASE = 0x10000


# simstate masks (ref: event handler registration masks)
ES_RUNNING = 1 << int(SimState.RUNNING)
ES_PAUSED_FULL = 1 << int(SimState.PAUSED_FULL)
ES_PAUSED_UI = 1 << int(SimState.PAUSED_UI_RUNNING)
ES_ALL = ES_RUNNING | ES_PAUSED_FULL | ES_PAUSED_UI

GLOBAL_UID = -1


class EventBus:
    def __init__(self):
        # (uid, event) -> list of (handler, mask)
        self._handlers: dict[tuple[int, int], list[tuple[Callable, int]]] = (
            defaultdict(list))
        self._queue: list[tuple[int, int, Any]] = []  # (uid, event, arg)
        self._queued_this_frame: set[int] = set()
        # script-dispatch tracing (pf.debug.trace_python / log_python):
        # when a predicate is installed and true, every handler invocation
        # is appended to trace_log as (uid, event, handler_qualname)
        # (ref: the reference's script tracing settings, py_script.c)
        self.trace_pred: Callable[[], bool] | None = None
        self.trace_log: deque = deque(maxlen=256)
        # trace_pred is settings lookups behind try/except — too slow to
        # re-evaluate per dispatch on the hot path. It is sampled ONCE per
        # queue drain (i.e. per frame) into trace_enabled; immediate
        # notifies between drains see at most one frame of staleness.
        self.trace_enabled: bool = False

    # -- registration -----------------------------------------------------------

    def subscribe(self, event: int, handler: Callable, *,
                  uid: int = GLOBAL_UID, mask: int = ES_RUNNING) -> None:
        self._handlers[(uid, int(event))].append((handler, mask))

    def unsubscribe(self, event: int, handler: Callable, *,
                    uid: int = GLOBAL_UID) -> None:
        lst = self._handlers.get((uid, int(event)), [])
        self._handlers[(uid, int(event))] = [
            (h, m) for (h, m) in lst if h != handler]

    def unsubscribe_entity(self, uid: int) -> None:
        """Drop all handlers for an entity (on removal)."""
        for key in [k for k in self._handlers if k[0] == uid]:
            del self._handlers[key]

    # -- delivery ----------------------------------------------------------------

    def notify(self, event: int, arg: Any = None, *, uid: int = GLOBAL_UID) -> None:
        """Queued delivery: fired on the next service_queue
        (ref: E_Global_Notify)."""
        self._queue.append((uid, int(event), arg))
        self._queued_this_frame.add(int(event))

    def notify_immediate(self, event: int, arg: Any = None, *,
                         uid: int = GLOBAL_UID,
                         simstate: SimState = SimState.RUNNING) -> None:
        """Synchronous delivery (ref: E_Global_NotifyImmediate)."""
        self._dispatch(uid, int(event), arg, simstate)

    def queued_this_frame(self, event: int) -> bool:
        return int(event) in self._queued_this_frame

    @property
    def pending(self) -> int:
        """Number of queued (not yet serviced) events."""
        return len(self._queue)

    def service_queue(self, simstate: SimState = SimState.RUNNING) -> int:
        """Drain the queue, dispatching to handlers whose mask admits the
        current sim state (ref: E_ServiceQueue). Returns events delivered.
        Events queued *during* servicing run next frame (same as the
        reference's snapshot of the queue head)."""
        queue, self._queue = self._queue, []
        self._queued_this_frame.clear()
        self.refresh_trace()
        n = 0
        for uid, event, arg in queue:
            n += self._dispatch(uid, event, arg, simstate)
        return n

    def refresh_trace(self) -> None:
        """Re-sample trace_pred into the per-frame trace_enabled cache."""
        self.trace_enabled = (self.trace_pred is not None
                              and self.trace_pred())

    def _dispatch(self, uid: int, event: int, arg: Any,
                  simstate: SimState) -> int:
        bit = 1 << int(simstate)
        n = 0
        trace = self.trace_enabled
        for handler, mask in list(self._handlers.get((uid, event), [])):
            if mask & bit:
                if trace:
                    self.trace_log.append(
                        (uid, event, getattr(handler, "__qualname__",
                                             repr(handler))))
                handler(arg)
                n += 1
        return n
