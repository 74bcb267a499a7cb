"""Portal graph over chunk borders + A* (host side).

Port of ``permafrost_engine_tpu/nav/portals.py`` (ref:
src/navigation/nav.c:563-655, a_star.c:429). Portals are the open runs of
each chunk border; the intra-chunk portal-to-portal costs come from ONE
batched integration with every portal's span seeded (kernel K2 on a CUDA
device, ``ops/flowfield_cuda.integrate``). A* stays on the host: the
native C++ A* of ``native/pf_native.cpp`` (``utils/native.py``), with a
pure-Python fallback here.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from permafrost_engine_tpu_torch.core.config import (
    COST_IMPASSABLE,
    FIELD_RES,
    INF_COST,
)
from permafrost_engine_tpu_torch.ops.flowfield_cuda import integrate

SQRT2 = np.sqrt(2.0)


@dataclasses.dataclass
class Portal:
    pid: int
    chunk: tuple[int, int]        # (cr, cc)
    side: str                     # 'N' | 'S' | 'E' | 'W'
    lo: int                       # run start along the edge (local coord)
    hi: int                       # run end (inclusive)
    paired: int = -1              # pid of the mirror portal across the edge

    def span_tiles(self) -> np.ndarray:
        """Local (r, c) nav tiles of the span, [K, 2]."""
        ks = np.arange(self.lo, self.hi + 1)
        if self.side == "N":
            return np.stack([np.zeros_like(ks), ks], 1)
        if self.side == "S":
            return np.stack([np.full_like(ks, FIELD_RES - 1), ks], 1)
        if self.side == "W":
            return np.stack([ks, np.zeros_like(ks)], 1)
        return np.stack([ks, np.full_like(ks, FIELD_RES - 1)], 1)

    def center_global(self) -> tuple[float, float]:
        """Global nav-tile (r, c) of the span centre."""
        mid = (self.lo + self.hi) / 2.0
        cr, cc = self.chunk
        if self.side == "N":
            return cr * FIELD_RES, cc * FIELD_RES + mid
        if self.side == "S":
            return cr * FIELD_RES + FIELD_RES - 1, cc * FIELD_RES + mid
        if self.side == "W":
            return cr * FIELD_RES + mid, cc * FIELD_RES
        return cr * FIELD_RES + mid, cc * FIELD_RES + FIELD_RES - 1


@dataclasses.dataclass
class PortalGraph:
    portals: list[Portal]
    adj: dict[int, list[tuple[int, float]]]
    by_chunk: dict[tuple[int, int], list[int]]
    _csr: tuple | None = None

    def csr(self):
        """CSR adjacency + node coords for the native A* backend."""
        if self._csr is None:
            n = len(self.portals)
            off = np.zeros(n + 1, np.int64)
            dst, cost = [], []
            for pid in range(n):
                for q, w in self.adj[pid]:
                    dst.append(q)
                    cost.append(w)
                off[pid + 1] = len(dst)
            coords = np.array([p.center_global() for p in self.portals]
                              or np.zeros((0, 2)), np.float32)
            self._csr = (off, np.asarray(dst, np.int64),
                         np.asarray(cost, np.float32),
                         coords[:, 0].copy() if n else np.zeros(0, np.float32),
                         coords[:, 1].copy() if n else np.zeros(0, np.float32))
        return self._csr


def _edge_runs(passable_a: np.ndarray, passable_b: np.ndarray):
    """Contiguous runs where both sides of a chunk edge are passable."""
    open_both = passable_a & passable_b
    runs = []
    start = None
    for i, ok in enumerate(open_both):
        if ok and start is None:
            start = i
        elif not ok and start is not None:
            runs.append((start, i - 1))
            start = None
    if start is not None:
        runs.append((start, len(open_both) - 1))
    return runs


def find_portals(cost_layer: np.ndarray, chunks_r: int, chunks_c: int):
    """The portals of one nav layer's cost u8[H, W]: one mirrored pair per
    open run of each chunk border. Returns (portals, by_chunk)."""
    passable = cost_layer != COST_IMPASSABLE
    portals: list[Portal] = []
    by_chunk: dict[tuple[int, int], list[int]] = {}

    def add(chunk, side, lo, hi) -> Portal:
        p = Portal(len(portals), chunk, side, lo, hi)
        portals.append(p)
        by_chunk.setdefault(chunk, []).append(p.pid)
        return p

    for r in range(chunks_r - 1):
        for c in range(chunks_c):
            row_s = (r + 1) * FIELD_RES - 1
            cols = slice(c * FIELD_RES, (c + 1) * FIELD_RES)
            for lo, hi in _edge_runs(passable[row_s, cols], passable[row_s + 1, cols]):
                a = add((r, c), "S", lo, hi)
                b = add((r + 1, c), "N", lo, hi)
                a.paired, b.paired = b.pid, a.pid
    for r in range(chunks_r):
        for c in range(chunks_c - 1):
            col_e = (c + 1) * FIELD_RES - 1
            rows = slice(r * FIELD_RES, (r + 1) * FIELD_RES)
            for lo, hi in _edge_runs(passable[rows, col_e], passable[rows, col_e + 1]):
                a = add((r, c), "E", lo, hi)
                b = add((r, c + 1), "W", lo, hi)
                a.paired, b.paired = b.pid, a.pid
    return portals, by_chunk


def span_seed_batch(portals: list[Portal], cost_layer: np.ndarray):
    """The batched integration inputs of a portal-graph build: per portal,
    its chunk's cost and its span as the seed. (u8[K, 64, 64],
    bool[K, 64, 64])."""
    k = len(portals)
    costs = np.empty((k, FIELD_RES, FIELD_RES), np.uint8)
    seeds = np.zeros((k, FIELD_RES, FIELD_RES), bool)
    for p in portals:
        cr, cc = p.chunk
        costs[p.pid] = cost_layer[cr * FIELD_RES:(cr + 1) * FIELD_RES,
                                  cc * FIELD_RES:(cc + 1) * FIELD_RES]
        t = p.span_tiles()
        seeds[p.pid, t[:, 0], t[:, 1]] = True
    return costs, seeds


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def build_portal_graph(cost_layer: np.ndarray, chunks_r: int, chunks_c: int,
                       *, device, fetch=_host) -> PortalGraph:
    """Portals of one nav layer's effective cost u8[H, W], with cross-edge
    links (cost 1) and intra-chunk links (integration cost between spans,
    all portals in one batched integration on `device`, brought to the host
    by `fetch`: the engine's passes it through its profiler's waits)."""
    portals, by_chunk = find_portals(cost_layer, chunks_r, chunks_c)
    adj: dict[int, list[tuple[int, float]]] = {p.pid: [] for p in portals}
    for p in portals:
        if p.paired >= 0:
            adj[p.pid].append((p.paired, 1.0))
    if portals:
        costs, seeds = span_seed_batch(portals, cost_layer)
        integ = fetch(integrate(torch.from_numpy(costs).to(device),
                                torch.from_numpy(seeds).to(device)))
        for p in portals:
            for qid in by_chunk[p.chunk]:
                if qid == p.pid:
                    continue
                t = portals[qid].span_tiles()
                d = integ[p.pid, t[:, 0], t[:, 1]].min()
                if d < INF_COST / 2:
                    adj[p.pid].append((qid, float(d)))
    return PortalGraph(portals=portals, adj=adj, by_chunk=by_chunk)


def update_portal_graph(graph: PortalGraph, cost_layer: np.ndarray,
                        dirty_chunks: set[tuple[int, int]], chunks_r: int,
                        chunks_c: int, *, device,
                        fetch=_host) -> tuple[PortalGraph, int]:
    """Rebuild a portal graph after cost edits confined to `dirty_chunks`
    (ref: N_Update, src/navigation/nav.c:2119-2206): portals and links of
    untouched chunks are carried over (pids compact), border runs are
    recomputed only on borders touching a dirty chunk, and the dirty chunks
    and their orthogonal neighbours are relinked with one batched
    integration on `device` over the relinked portals' spans. Falls back to
    a full build when a third of the map or more is dirty. Returns (new
    graph, number of chunks relinked)."""
    if len(dirty_chunks) * 3 >= chunks_r * chunks_c:
        return (build_portal_graph(cost_layer, chunks_r, chunks_c,
                                   device=device, fetch=fetch),
                chunks_r * chunks_c)

    relink = set(dirty_chunks)
    for r, k in dirty_chunks:
        for n in ((r - 1, k), (r + 1, k), (r, k - 1), (r, k + 1)):
            if 0 <= n[0] < chunks_r and 0 <= n[1] < chunks_c:
                relink.add(n)

    def touches_dirty(p: Portal) -> bool:
        if p.chunk in dirty_chunks:
            return True
        return p.paired >= 0 and graph.portals[p.paired].chunk in dirty_chunks

    passable = cost_layer != COST_IMPASSABLE
    portals: list[Portal] = []
    by_chunk: dict[tuple[int, int], list[int]] = {}
    remap: dict[int, int] = {}

    def add(chunk, side, lo, hi) -> Portal:
        p = Portal(len(portals), chunk, side, lo, hi)
        portals.append(p)
        by_chunk.setdefault(chunk, []).append(p.pid)
        return p

    for p in graph.portals:
        if not touches_dirty(p):
            remap[p.pid] = add(p.chunk, p.side, p.lo, p.hi).pid
    for old_pid, new_pid in remap.items():
        portals[new_pid].paired = remap.get(graph.portals[old_pid].paired, -1)

    # border runs again, only where a border touches a dirty chunk
    for r in range(chunks_r - 1):
        for c in range(chunks_c):
            if (r, c) not in dirty_chunks and (r + 1, c) not in dirty_chunks:
                continue
            row_s = (r + 1) * FIELD_RES - 1
            cols = slice(c * FIELD_RES, (c + 1) * FIELD_RES)
            for lo, hi in _edge_runs(passable[row_s, cols], passable[row_s + 1, cols]):
                a = add((r, c), "S", lo, hi)
                b = add((r + 1, c), "N", lo, hi)
                a.paired, b.paired = b.pid, a.pid
    for r in range(chunks_r):
        for c in range(chunks_c - 1):
            if (r, c) not in dirty_chunks and (r, c + 1) not in dirty_chunks:
                continue
            col_e = (c + 1) * FIELD_RES - 1
            rows = slice(r * FIELD_RES, (r + 1) * FIELD_RES)
            for lo, hi in _edge_runs(passable[rows, col_e], passable[rows, col_e + 1]):
                a = add((r, c), "E", lo, hi)
                b = add((r, c + 1), "W", lo, hi)
                a.paired, b.paired = b.pid, a.pid

    adj: dict[int, list[tuple[int, float]]] = {p.pid: [] for p in portals}
    for p in portals:
        if p.paired >= 0:
            adj[p.pid].append((p.paired, 1.0))
    # carry over the intra-chunk links of chunks that are not relinked
    inv = {v: k for k, v in remap.items()}
    for p in portals:
        if p.chunk in relink:
            continue
        old_pid = inv[p.pid]
        old_pair = graph.portals[old_pid].paired
        for q, w in graph.adj[old_pid]:
            if q != old_pair and q in remap:
                adj[p.pid].append((remap[q], w))

    todo = [p for p in portals if p.chunk in relink]
    if todo:
        costs = np.empty((len(todo), FIELD_RES, FIELD_RES), np.uint8)
        seeds = np.zeros((len(todo), FIELD_RES, FIELD_RES), bool)
        for i, p in enumerate(todo):
            cr, cc = p.chunk
            costs[i] = cost_layer[cr * FIELD_RES:(cr + 1) * FIELD_RES,
                                  cc * FIELD_RES:(cc + 1) * FIELD_RES]
            t = p.span_tiles()
            seeds[i, t[:, 0], t[:, 1]] = True
        integ = fetch(integrate(torch.from_numpy(costs).to(device),
                                torch.from_numpy(seeds).to(device)))
        for i, p in enumerate(todo):
            for qid in by_chunk[p.chunk]:
                if qid == p.pid:
                    continue
                t = portals[qid].span_tiles()
                d = integ[i, t[:, 0], t[:, 1]].min()
                if d < INF_COST / 2:
                    adj[p.pid].append((qid, float(d)))

    return PortalGraph(portals=portals, adj=adj, by_chunk=by_chunk), len(relink)


def _octile(a, b) -> float:
    dr, dc = abs(a[0] - b[0]), abs(a[1] - b[1])
    return max(dr, dc) + (SQRT2 - 1.0) * min(dr, dc)


def astar_portals(graph: PortalGraph, start_costs: dict[int, float],
                  goal_costs: dict[int, float], goal_rc,
                  blocked: frozenset | None = None) -> list[int] | None:
    """A* from a virtual start node to a virtual goal node (ref:
    a_star.c:429): the portal pid sequence, or None if unreachable. The
    native backend runs unless a blocked-edge set is given (the per-hop
    local-island filtering of a_star.c:212-258), which the Python path
    handles."""
    if blocked:
        return _astar_portals_py(graph, start_costs, goal_costs, goal_rc,
                                 blocked)
    if start_costs and goal_costs:
        from permafrost_engine_tpu_torch.utils import native
        off, dst, cost, nr, nc = graph.csr()
        res = native.astar_csr(
            off, dst, cost, nr, nc,
            np.asarray(list(start_costs), np.int64),
            np.asarray(list(start_costs.values()), np.float32),
            np.asarray(list(goal_costs), np.int64),
            np.asarray(list(goal_costs.values()), np.float32),
            goal_rc)
        if res == "unreachable":
            return None
        if res is not None:
            return res
    return _astar_portals_py(graph, start_costs, goal_costs, goal_rc)


def _astar_portals_py(graph, start_costs, goal_costs, goal_rc, blocked=None):
    """Pure-Python A*."""
    if not start_costs:
        return None
    blocked = blocked or frozenset()
    best: dict[int, float] = {}
    came: dict[int, int | None] = {}
    pq: list[tuple[float, float, int]] = []
    for pid, c in start_costs.items():
        best[pid] = c
        came[pid] = None
        h = _octile(graph.portals[pid].center_global(), goal_rc)
        heapq.heappush(pq, (c + h, c, pid))
    goal_best = np.inf
    goal_from: int | None = None
    while pq:
        f, g, pid = heapq.heappop(pq)
        if f >= goal_best:
            break
        if g > best.get(pid, np.inf):
            continue
        if pid in goal_costs and g + goal_costs[pid] < goal_best:
            goal_best = g + goal_costs[pid]
            goal_from = pid
        for qid, w in graph.adj[pid]:
            if (pid, qid) in blocked:
                continue
            ng = g + w
            if ng < best.get(qid, np.inf):
                best[qid] = ng
                came[qid] = pid
                h = _octile(graph.portals[qid].center_global(), goal_rc)
                heapq.heappush(pq, (ng + h, ng, qid))
    if goal_from is None:
        return None
    path = [goal_from]
    while came[path[-1]] is not None:
        path.append(came[path[-1]])
    return list(reversed(path))
