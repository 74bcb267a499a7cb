"""Hierarchical profiler, tick statistics and an operation counter.

Port of ``permafrost_engine_tpu/core/perf.py``. The reference instruments
nearly every hot function with PERF_PUSH/POP macros into per-thread entry
rings, reports name/ms/parent per frame, and adds GPU timestamp queries
resolved N frames late (ref: src/perf.h:47-168, src/perf.c). Here:

* host-side hierarchical scopes (``with perf.scope("device_tick")``). A
  scope named ``X`` adds its duration to ``counters["X.ms"]``, 1 to
  ``counters["X.n"]`` and the part of its duration spent in nested waits
  to ``counters["X.wait_ms"]``. While a ``torch.profiler`` session
  records, it also opens a host range of its name, which lands in the
  same kineto trace, on the same clock, as the device's kernels and
  copies (so an idle gap of the device can be put down to the scope the
  host was in); with no session recording it makes no profiler call,
  only one read of the profiler's enabled flag. The range is a
  function-scope one (``_RecordFunctionFast``): kineto mirrors a
  user-scope ``record_function`` range onto the device's timeline as an
  annotation spanning every kernel launched under it, which a reader of
  the device's busy intervals would count as busy. Scopes nest, so the
  trace's nesting gives each range its parent; the engine runs one order
  at a time, so an order's ranges need no identifier of their own;
* waits (``with perf.wait("step.drain")``, ``perf.fetch(tensor)``): scopes
  around host code that blocks on the device (a ``.cpu()`` of a device
  tensor, ``event.synchronize()``). A wait's duration is added to the
  ``wait_ms`` of every scope that encloses it (a wait inside a wait only
  to its own). A wait given no name is named after the innermost open
  scope opened with ``owner=True``: ``order.fetch`` inside ``order``,
  ``cadence.fetch`` inside ``cadence``, ``fetch`` outside any;
* per-frame reports with parent indices, same shape as ``struct
  perf_info``: a frame runs from one ``begin_tick`` to the next, and only
  scopes opened between a ``begin_tick`` and its ``end_tick`` enter it
  (scopes outside frames, such as ``step_scan``'s segments, only count);
* ``counters``: named host times and counts (the engine's nav cadence and
  host-system timers live here besides the scopes' keys);
* ``device_trace``: a ``torch.profiler`` trace (CPU and CUDA activity,
  the scopes' ranges among them), exported as a Chrome trace, for
  per-kernel deep dives;
* ``OpCounter``: operations and bytes of every torch op run under it (the
  counterpart of XLA's cost analysis, ``Engine.tick_cost_analysis``).

``H100_F32_OPS_S`` is the peak the port's utilisation figures are taken
against.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# NVIDIA H100 SXM (data sheet): f32 operations per second outside the
# tensor cores for operations that are not FMAs (half the sheet's 67e12
# flop/s, which counts an FMA as two)
H100_F32_OPS_S = 33.5e12


class PerfEntry:
    __slots__ = ("name", "ms", "parent")

    def __init__(self, name: str, ms: float, parent: int):
        self.name = name
        self.ms = ms
        self.parent = parent

    def to_dict(self):
        return {"name": self.name, "ms": self.ms, "parent": self.parent}


class _Span:
    """One open scope or wait of a ``Perf`` (the context manager that
    ``Perf.scope`` and ``Perf.wait`` return)."""

    __slots__ = ("perf", "name", "is_wait", "owner", "entry", "gen", "t0",
                 "waited", "rf")

    def __init__(self, perf: "Perf", name: str, is_wait: bool, owner: bool):
        self.perf = perf
        self.name = name
        self.is_wait = is_wait
        self.owner = owner

    def __enter__(self):
        p = self.perf
        if not p.enabled:
            self.t0 = None
            return self
        self.entry = None
        if p._in_frame:
            self.entry = PerfEntry(self.name, 0.0,
                                   p._stack[-1] if p._stack else -1)
            self.gen = p._gen
            p._stack.append(len(p._current))
            p._current.append(self.entry)
        self.waited = 0.0
        p._open.append(self)
        if self.owner:
            p._owners.append(self.name)
        if self.is_wait:
            p._wait_depth += 1
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.t0 is None:
            return False
        ms = (time.perf_counter() - self.t0) * 1e3
        p = self.perf
        if self.rf is not None:
            self.rf.__exit__(*exc)
        p._open.pop()
        if self.owner:
            p._owners.pop()
        if self.is_wait:
            p._wait_depth -= 1
            self.waited = ms
            if p._wait_depth == 0:
                for outer in p._open:
                    outer.waited += ms
        keys = p._keys.get(self.name)
        if keys is None:
            keys = p._keys[self.name] = (self.name + ".ms", self.name + ".n",
                                         self.name + ".wait_ms")
        c = p.counters
        c[keys[0]] += ms
        c[keys[1]] += 1
        c[keys[2]] += self.waited
        if self.entry is not None:
            self.entry.ms = ms
            if p._gen == self.gen:
                p._stack.pop()
        return False


class Perf:
    def __init__(self, keep_frames: int = 8):
        self.enabled = True
        self.keep_frames = keep_frames
        self._frames: list[list[PerfEntry]] = []
        self._current: list[PerfEntry] = []
        self._stack: list[int] = []
        self._frame_start = 0.0
        self._frame_ms = 0.0
        # frames begun (a scope spanning a begin_tick leaves the new
        # frame's stack alone) and whether scopes enter the frame tree now
        self._gen = 0
        self._in_frame = False
        # open scopes and waits, innermost last, across frames
        self._open: list[_Span] = []
        self._owners: list[str] = []
        self._wait_depth = 0
        self._keys: dict[str, tuple[str, str, str]] = {}
        self.counters: dict[str, float] = defaultdict(float)

    # -- frame lifecycle -----------------------------------------------------

    def begin_tick(self) -> None:
        if self._current:
            self._frames.append(self._current)
            self._frames = self._frames[-self.keep_frames:]
        now = time.perf_counter()
        self._frame_ms = (now - self._frame_start) * 1e3 if self._frame_start else 0.0
        self._frame_start = now
        self._current = []
        self._stack = []
        self._gen += 1
        self._in_frame = True

    def end_tick(self) -> None:
        """Close the frame to new tree entries until the next
        ``begin_tick`` (scopes in between still count)."""
        self._in_frame = False

    def scope(self, name: str, *, owner: bool = False) -> _Span:
        """PERF_PUSH/POP pair (ref: perf.h:47-82). With `owner` the scope
        names the unnamed waits inside it (``<name>.fetch``)."""
        return _Span(self, name, False, owner)

    def wait(self, name: str | None = None) -> _Span:
        """A scope around host code that blocks on the device; its
        duration also counts as waiting in every enclosing scope."""
        if name is None:
            name = self._owners[-1] + ".fetch" if self._owners else "fetch"
        return _Span(self, name, True, False)

    def fetch(self, t: torch.Tensor, name: str | None = None):
        """``t.cpu().numpy()`` inside a wait."""
        with self.wait(name):
            return t.cpu().numpy()

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    @contextlib.contextmanager
    def device_trace(self, logdir: str):
        """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
        activity when a device is present) and write a Chrome trace,
        ``trace.json``, to `logdir` (the analogue of the reference's GPU
        timestamp queries, perf.h:155-163); view it in Perfetto or
        chrome://tracing."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

    # -- reports (ref: Perf_Report, pf.prev_frame_perfstats) -------------------

    def prev_frame_ms(self) -> float:
        return self._frame_ms

    def prev_frame_perfstats(self) -> list[dict]:
        if not self._frames:
            return []
        return [e.to_dict() for e in self._frames[-1]]

    def report_tree(self) -> str:
        out = []
        entries = self._frames[-1] if self._frames else self._current
        def depth(i):
            d, p = 0, entries[i].parent
            while p >= 0:
                d += 1
                p = entries[p].parent
            return d
        for i, e in enumerate(entries):
            out.append(f"{'  ' * depth(i)}{e.name}: {e.ms:.3f} ms")
        return "\n".join(out)


_MATMULS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"}


class OpCounter(TorchDispatchMode):
    """Counts the work of every torch op dispatched under it: ``ops`` adds a
    matrix product's 2·M·N·K, a reduction's input elements and any other
    op's output elements (view ops count nothing); ``bytes`` adds every
    operand's and every output's bytes. Both are upper bounds, as XLA's
    cost analysis is: nothing is credited to fusion or caching. Work done
    outside torch (a CUDA kernel launched through ctypes) is not seen."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        name = func._schema.name
        if name in _MATMULS:
            a, b = args[-2], args[-1]
            m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
            batch = a.shape[0] if a.dim() == 3 else 1
            self.ops += 2 * batch * m * n * k
        elif torch.Tag.reduction in func.tags and ins:
            self.ops += max(t.numel() for t in ins)
        else:
            self.ops += sum(t.numel() for t in outs)
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out
