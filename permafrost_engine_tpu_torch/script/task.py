"""pf.Task — scriptable cooperative tasks.

Mirrors the reference's pf.Task class (ref: src/script/py_task.c:120-140):
subclass and override __run__ as a generator; the scheduler protocol
methods (wait / yield_ / send / receive / reply / await_event / sleep /
register / who_is) are exposed as helpers returning request objects to
yield. The reference can pickle tasks mid-execution (py_task.c:654);
CPython 3 cannot pickle live generators, so tasks persist their
`self.state` dict across session save and restart from __run__.

The port's own copy of ``permafrost_engine_tpu/script/task.py``, verbatim
but for the package name, over the port's ``core/sched.py``.
"""

from __future__ import annotations

from permafrost_engine_tpu_torch.core import sched as _s


class Task:
    """Subclass and override __run__ (a generator):

        class Guard(pf.Task):
            def __run__(self):
                while True:
                    ev = yield self.await_event(pf.EVENT_ENTITY_DEATH)
                    ...
    """

    def __init__(self, *args):
        ctx = _ctx()
        self._args = args
        self.state: dict = {}
        self.tid = ctx.engine.sched.create(self._entry, *args,
                                           name=type(self).__name__)
        ctx.tasks[self.tid] = self

    def _entry(self, task, *args):
        import copy
        task.state = self.state
        # the replay base must be the WRAPPER dict's content at generator
        # start (the scheduler's pre-send capture saw its own empty dict
        # before this swap) — see core/sched.py Task.state0
        task.state0 = copy.deepcopy(self.state)
        self._task = task
        return (yield from self.__run__())

    def effect(self, fn, *args, **kw):
        """World mutations that must survive session replay go through
        here (executed live, skipped + result-replayed on session load;
        see core/sched.py mid-execution persistence)."""
        return self._task.effect(fn, *args, **kw)

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_task", None)            # scheduler half is rebuilt on load
        return d

    def __run__(self):
        yield self.yield_()

    # -- request constructors (yield these from __run__) -------------------------

    @staticmethod
    def yield_():
        return _s.Yield()

    @staticmethod
    def sleep(ticks: int):
        return _s.Sleep(ticks)

    @staticmethod
    def send(tid: int, msg):
        return _s.Send(tid, msg)

    @staticmethod
    def receive():
        return _s.Receive()

    @staticmethod
    def reply(tid: int, msg):
        return _s.Reply(tid, msg)

    @staticmethod
    def await_event(event: int):
        return _s.AwaitEvent(event)

    @staticmethod
    def register(name: str):
        return _s.Register(name)

    @staticmethod
    def who_is(name: str):
        return _s.WhoIs(name)

    def wait(self, tid: int):
        """Block until task tid completes (polling sleep)."""
        return _s.Send(tid, ("__wait__",))

    # -- introspection -------------------------------------------------------------

    @property
    def completed(self) -> bool:
        return not _ctx().engine.sched.alive(self.tid)


def _ctx():
    from permafrost_engine_tpu_torch.script import pf
    return pf.context()
