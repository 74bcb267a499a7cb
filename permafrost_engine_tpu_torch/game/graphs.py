"""Segments of the tick as CUDA graphs: the port's ``lax.scan`` dispatch.

The JAX engine runs the frames between two host-cadence boundaries as one
``lax.scan`` dispatch (``Engine.step``'s micro-batching and ``step_scan``).
On the card a segment of k ticks is one CUDA graph replay instead of k
ticks of eager launches; on the CPU the same k ticks run in turn.

* **Keys.** The tick's substep gates are Python ``if``s on the host frame,
  so a graph bakes in which substeps run, and nothing else of the frame.
  A graph is keyed by k and the gates its k frames fire (the tick's
  ``gates(t)``), captured at first use and replayed after; the host frame
  advances by k on each replay. At the defaults one-frame segments need 7
  graphs, one per distinct gate tuple, not one per frame of the cadence
  period, and segments of 30 frames or more as many as (k, first frame
  modulo the period) tells apart.
* **Static buffers.** A graph reads and writes the tensors it was captured
  on. Every tensor leaf of the state and of the accumulator has one buffer,
  shared by all graphs. Before a replay, a leaf that host code rebound to
  another tensor between segments is copied into its buffer and rebound to
  it (host code that writes a leaf in place writes the buffer itself). The
  captured segment ends by copying each leaf's result into its buffer, so
  after a replay the state's leaves are the buffers again.
* **Memory.** All graphs share one memory pool; a graph's outputs live in
  the static buffers, outside the pool, so no pool tensor outlives its
  capture and the graphs may replay in any order.
* **Launch counters.** The kernel wrappers count launches when they are
  called, which a replay does not do. Each graph records the launches its
  capture would have counted and adds them on every replay.
* **Warm-up.** Before a capture the segment runs once eagerly on a scratch
  copy of the state, so every kernel module is loaded and every per-device
  constant is built outside the capture. Its launches are not counted.

A capture that fails raises: nothing falls back to eager stepping.
"""

from __future__ import annotations

import copy
import dataclasses
import time

import torch

from permafrost_engine_tpu_torch.ops import crowd_cuda, flowfield_cuda

# the kernel wrappers' launch counters (module, attribute)
_COUNTERS = ((crowd_cuda, "launches"), (flowfield_cuda, "launches_chunk"),
             (flowfield_cuda, "launches_map"))


def _counts() -> list[int]:
    return [getattr(mod, name) for mod, name in _COUNTERS]


def _set_counts(values) -> None:
    for (mod, name), v in zip(_COUNTERS, values):
        setattr(mod, name, v)


def _leaf_paths(state, acc) -> list[tuple]:
    """(root, field, subfield) of every tensor leaf: root 0 is the state,
    1 the accumulator; subfield None for a tensor held directly."""
    paths = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Tensor):
            paths.append((0, f.name, None))
        elif dataclasses.is_dataclass(v):
            paths += [(0, f.name, g.name) for g in dataclasses.fields(v)
                      if isinstance(getattr(v, g.name), torch.Tensor)]
    return paths + [(1, f.name, None) for f in dataclasses.fields(acc)]


def _get(roots, path) -> torch.Tensor:
    root, field, sub = path
    v = getattr(roots[root], field)
    return v if sub is None else getattr(v, sub)


def _set(roots, path, t: torch.Tensor) -> None:
    root, field, sub = path
    if sub is None:
        setattr(roots[root], field, t)
    else:
        setattr(getattr(roots[root], field), sub, t)


class TickGraphs:
    """Runs ``(state, n, acc=None) -> (state, acc)``: n ticks of `tick` as
    one segment (see the module docstring); `tick.gates(t)` gives the
    substeps it fires at frame t. `period` is the cadence period of those
    gates; `new_acc(device)` makes an empty accumulator when the caller
    gives none."""

    def __init__(self, tick, period: int, new_acc):
        self.tick, self.period, self.new_acc = tick, period, new_acc
        self._graphs: dict[tuple, torch.cuda.CUDAGraph] = {}
        self._buffers: dict[tuple, torch.Tensor] | None = None
        self._pool = None
        # per key: the launches of each counted kernel in one replay
        self.launches: dict[tuple, dict[str, int]] = {}
        self.stats = {"captures": 0, "capture_ms": 0.0, "replays": 0}

    def key(self, n: int, tick: int) -> tuple:
        """The graph key of the n frames after host frame `tick`: n and the
        substeps each frame fires (the tick's ``gates``)."""
        return n, tuple(map(self.tick.gates, range(tick + 1, tick + n + 1)))

    def __call__(self, state, n: int, acc=None):
        dev = state.ents.pos.device
        if acc is None:
            acc = self.new_acc(dev)
        if dev.type == "cpu" or n == 0:
            for _ in range(n):
                state, acc = self.tick(state, acc)
            return state, acc
        if dev.type != "cuda":
            raise RuntimeError(f"TickGraphs: no graphs for device {dev}")
        if self._buffers is None:
            self._buffers = {
                p: _get((state, acc), p).clone(memory_format=torch.contiguous_format)
                for p in _leaf_paths(state, acc)}
        self._bind((state, acc))
        key = self.key(n, state.tick)
        if key not in self._graphs:
            state, acc = self._capture(key, state, acc)
        self._graphs[key].replay()
        state.tick += n
        _set_counts([c + k for c, k in zip(_counts(),
                                           self.launches[key].values())])
        self.stats["replays"] += 1
        return state, acc

    def _bind(self, roots) -> None:
        """Make every leaf its static buffer again, copying the leaves host
        code rebound since the last segment."""
        for path, buf in self._buffers.items():
            t = _get(roots, path)
            if t is buf:
                continue
            if t.shape != buf.shape or t.dtype != buf.dtype:
                raise RuntimeError(
                    f"state leaf {path[1:]} changed from {buf.dtype}"
                    f"{list(buf.shape)} to {t.dtype}{list(t.shape)}")
            buf.copy_(t)
            _set(roots, path, buf)

    def _capture(self, key, state, acc):
        """Warm up, then capture the segment `key` on the bound state;
        returns the (state, acc) the tick hands back, bound to the
        buffers, with the host frame where it was."""
        n = key[0]
        t0, before = state.tick, _counts()
        start = time.perf_counter()
        s, a = copy.deepcopy((state, acc))
        for _ in range(n):
            s, a = self.tick(s, a)
        del s, a
        warm = _counts()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            s, a = state, acc
            for _ in range(n):
                s, a = self.tick(s, a)
            roots = (s, a)
            outs = {p: _get(roots, p) for p in self._buffers}
            held = {b.untyped_storage().data_ptr()
                    for b in self._buffers.values()}
            # a result that is still another leaf's buffer (prev_pos after
            # a movement substep) is read before that buffer is overwritten
            for p, t in outs.items():
                if (t is not self._buffers[p]
                        and t.untyped_storage().data_ptr() in held):
                    outs[p] = t.clone()
            for p, t in outs.items():
                if t is not self._buffers[p]:
                    self._buffers[p].copy_(t)
        for p, buf in self._buffers.items():
            _set(roots, p, buf)
        s.tick = t0
        self.launches[key] = {f"{mod.__name__.rsplit('.', 1)[1]}.{name}": c - w
                              for (mod, name), c, w in zip(_COUNTERS, _counts(),
                                                           warm)}
        _set_counts(before)
        self._graphs[key] = graph
        self.stats["captures"] += 1
        self.stats["capture_ms"] += (time.perf_counter() - start) * 1e3
        return s, a
