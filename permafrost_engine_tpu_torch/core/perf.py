"""Hierarchical profiler, tick statistics and an operation counter.

Port of ``permafrost_engine_tpu/core/perf.py``. The reference instruments
nearly every hot function with PERF_PUSH/POP macros into per-thread entry
rings, reports name/ms/parent per frame, and adds GPU timestamp queries
resolved N frames late (ref: src/perf.h:47-168, src/perf.c). Here:

* host-side hierarchical scopes (``with perf.scope("device_tick")``);
* per-frame reports with parent indices, same shape as ``struct perf_info``;
* ``counters``: named host times and counts (the engine's nav cadence and
  host-system timers live here);
* ``device_trace``: a ``torch.profiler`` trace (CPU and CUDA activity),
  exported as a Chrome trace, for per-kernel deep dives;
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


class Perf:
    def __init__(self, keep_frames: int = 8):
        self.enabled = True
        self.keep_frames = keep_frames
        self._frames: list[list[PerfEntry]] = []
        self._current: list[PerfEntry] = []
        self._stack: list[int] = []
        self._starts: list[float] = []
        self._frame_start = 0.0
        self._frame_ms = 0.0
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
        self._starts = []

    @contextlib.contextmanager
    def scope(self, name: str):
        """PERF_PUSH/POP pair (ref: perf.h:47-82)."""
        if not self.enabled:
            yield
            return
        parent = self._stack[-1] if self._stack else -1
        idx = len(self._current)
        self._current.append(PerfEntry(name, 0.0, parent))
        self._stack.append(idx)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._current[idx].ms = (time.perf_counter() - t0) * 1e3
            self._stack.pop()

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
