"""Host navigation service: path requests, field cache, slab management.

Port of the move-order half of ``permafrost_engine_tpu/nav/service.py``
(ref: N_RequestPath + fieldcache, src/navigation/nav.c:1774-2047,
src/navigation/fieldcache.c):

  1. integrate the start and goal chunks (one batched K2 launch)
  2. A* over the portal graph (host)
  3. walk the path backwards into one seed set per chunk, and build every
     missing chunk field in ONE batched K2 launch + ``flow_dirs``
  4. write the fields into LRU slab slots, build the LOS maps of the goals
     (closed form, whole map) and cut them into the LOS slab, and point the
     flock's chunk->slot tables at both

Field keys are (layer, chunk, seed signature), so flocks sharing a goal or
portal reuse fields (ref: fieldcache.h:53-167).

Whole-map enemy-seek fields (the per-(faction, layer) chase fields combat
chasers follow, ref: field.c:1209-1678) are built in one batch per
refresh: ``build_enemy_seek_fields_batch``. Their 256x256 integration is
an XLA op in the JAX package (``ff.integrate`` with a cap of 4*max(H, W)
sweeps), the same Jacobi min-plus schedule as the Pallas kernel; here it
goes through K2 like every chunk, one thread-block cluster per field.

The JAX version pads every batch to a small fixed set of sizes and
pre-compiles them (``prewarm``, ``batch_buckets``, the seek batch's
sentinel spec): that exists to avoid remote XLA compiles. Eager PyTorch has
no compile per shape, so batches run at their own size. Not ported yet:
surround fields, formation cell fields, structure stamps and their
incremental portal-graph updates.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from permafrost_engine_tpu_torch.core.config import (
    COST_IMPASSABLE,
    DiplomacyState,
    EngineConfig,
    FIELD_RES,
    INF_COST,
    NAV_TILE_SIZE,
    NUM_FOOTPRINTS,
    NavDomain,
)
from permafrost_engine_tpu_torch.nav import portals as pt
from permafrost_engine_tpu_torch.ops import flowfield as ff
from permafrost_engine_tpu_torch.ops.flowfield_cuda import integrate
from permafrost_engine_tpu_torch.ops.islands import label_islands
from permafrost_engine_tpu_torch.state.schema import GameState


class LruSlab:
    """LRU key->slot assignment over a fixed number of slab slots."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        self.order: OrderedDict[tuple, int] = OrderedDict()
        self.free = list(range(num_slots - 1, -1, -1))

    def get(self, key) -> int | None:
        slot = self.order.get(key)
        if slot is not None:
            self.order.move_to_end(key)
        return slot

    def put(self, key) -> tuple[int, tuple | None]:
        """Assign a slot for key; returns (slot, evicted key or None)."""
        if key in self.order:
            self.order.move_to_end(key)
            return self.order[key], None
        evicted = None
        if self.free:
            slot = self.free.pop()
        else:
            evicted, slot = self.order.popitem(last=False)
        self.order[key] = slot
        return slot, evicted

    @property
    def stats(self):
        return {"entries": len(self.order), "free": len(self.free)}


def tile_of(xz) -> tuple[int, int]:
    """Global nav-tile (r, c) for a world position (x, z)."""
    return int(xz[1] // NAV_TILE_SIZE), int(xz[0] // NAV_TILE_SIZE)


class NavService:
    """Host-side navigation orchestrator bound to one engine instance.

    Slab slots and flock rows are int64 on the host (``slot_mirror``,
    ``los_mirror``) and int32 in the device tables, explicitly converted
    when pushed."""

    def __init__(self, cfg: EngineConfig, cost_base: np.ndarray, *, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.terrain_cost = cost_base.copy()
        self.cost_base = cost_base.copy()
        # structure refcounts at ground resolution (no ported entry point
        # stamps them yet; kept so the effective-cost rule is the JAX one)
        self.structure_ref = np.zeros((cfg.field_h, cfg.field_w), np.int32)
        self._graphs: dict[int, pt.PortalGraph] = {}
        self._islands: dict[int, np.ndarray] = {}
        self.flow_cache = LruSlab(cfg.field_slab_slots)
        self.los_cache = LruSlab(cfg.los_slab_slots)
        self.slot_mirror = np.full((cfg.max_flocks, cfg.num_chunks), -1, np.int64)
        self.los_mirror = np.full((cfg.max_flocks, cfg.num_chunks), -1, np.int64)
        self.flock_chunks: dict[int, set[int]] = {}
        self.flock_goal: dict[int, tuple[int, tuple[int, int]]] = {}
        self._extend_failed: set[tuple[int, int]] = set()
        self._goal_span_cache: dict[tuple[int, int, int], dict[int, float]] = {}
        self.flock_plan_detoured: dict[int, bool] = {}
        self._blocker_snap: np.ndarray | None = None
        self._blocker_epoch = 0
        self._edge_cache: dict[int, tuple[int, frozenset, frozenset]] = {}
        self.stats = {"hits": 0, "misses": 0, "requests": 0, "failed": 0,
                      "retargeted": 0, "blocked_edges": 0,
                      "blocker_replans": 0, "chunks_built": 0,
                      "seek_batches": 0, "seek_fields": 0}

    # -- portal graphs and islands -------------------------------------------

    def graph(self, layer: int) -> pt.PortalGraph:
        if layer not in self._graphs:
            self._graphs[layer] = pt.build_portal_graph(
                self.cost_base[layer], self.cfg.chunks_r, self.cfg.chunks_c,
                device=self.device)
        return self._graphs[layer]

    def islands(self, layer: int) -> np.ndarray:
        """Global island ids for a layer (host mirror, built on demand —
        ref: n_update_components, nav.c:655)."""
        if layer not in self._islands:
            cost = torch.from_numpy(self.cost_base[layer]).to(self.device)
            self._islands[layer] = label_islands(cost).cpu().numpy()
        return self._islands[layer]

    def invalidate_layer(self, layer: int) -> None:
        """Drop a layer's graph, islands, edge states and cached fields."""
        self._graphs.pop(layer, None)
        self._islands.pop(layer, None)
        self._edge_cache.pop(layer, None)
        self._goal_span_cache = {k: v for k, v in self._goal_span_cache.items()
                                 if k[0] != layer}
        for cache, mirror in ((self.flow_cache, self.slot_mirror),
                              (self.los_cache, self.los_mirror)):
            for k in [k for k in cache.order if k[0] == layer]:
                slot = cache.order.pop(k)
                cache.free.append(slot)
                mirror[mirror == slot] = -1

    def set_terrain(self, cost_base: np.ndarray) -> None:
        """Install new compiled terrain costs; every nav derivative rebuilds
        lazily and every cached field is dropped."""
        self.terrain_cost = cost_base.copy()
        self._recompute_effective()
        self._graphs.clear()
        self._islands.clear()
        self._edge_cache.clear()
        self._extend_failed.clear()
        for layer in range(self.cfg.num_layers):
            self.invalidate_layer(layer)

    @staticmethod
    def _grow3(x: np.ndarray) -> np.ndarray:
        h, w = x.shape
        p = np.pad(x, ((1, 1), (0, 0)))
        m = np.maximum(np.maximum(p[:h], p[1:h + 1]), p[2:h + 2])
        p = np.pad(m, ((0, 0), (1, 1)))
        return np.maximum(np.maximum(p[:, :w], p[:, 1:w + 1]), p[:, 2:w + 2])

    def _recompute_effective(self) -> None:
        """cost_base = terrain with structure cutouts stamped impassable,
        dilated per footprint layer; AIR layers ignore structures."""
        eff = self.terrain_cost.copy()
        if self.structure_ref.any():
            dil = self.structure_ref
            for fp in range(NUM_FOOTPRINTS):
                if fp > 0:
                    dil = self._grow3(dil)
                for dom in (NavDomain.GROUND, NavDomain.WATER):
                    layer = int(dom) * NUM_FOOTPRINTS + fp
                    if layer < self.cfg.num_layers:
                        eff[layer][dil > 0] = COST_IMPASSABLE
        self.cost_base = eff

    # -- live-unit blockers (ref: nav_data.h:142-158) -------------------------

    def update_blockers(self, blk: np.ndarray) -> set[int]:
        """Install a host snapshot of the blocker grids i32[L, H, W] and
        recompute blocked portal edges; returns the chunk indices whose
        edge state flipped."""
        blk = np.asarray(blk)
        if self._blocker_snap is not None and np.array_equal(blk, self._blocker_snap):
            return set()
        self._blocker_snap = blk
        self._blocker_epoch += 1
        changed: set[int] = set()
        for layer in list(self._graphs):
            prev = self._edge_cache.get(layer)
            prev_edges = prev[1] if prev else frozenset()
            edges, _buried = self._blocked_edges(layer)
            if edges != prev_edges:
                graph = self._graphs[layer]
                for pid, qid in edges ^ prev_edges:
                    if pid < len(graph.portals):
                        changed.add(self._chunk_idx(*graph.portals[pid].chunk))
                    if qid < len(graph.portals):
                        changed.add(self._chunk_idx(*graph.portals[qid].chunk))
        if changed:
            self.stats["blocker_replans"] += 1
        return changed

    def blockers_change_route(self, fid: int, occupied_chunk_idxs) -> bool:
        """Does the A* route from the flock's occupied chunks to its goal
        differ with the blocked-edge filtering vs without?"""
        info = self.flock_goal.get(fid)
        if info is None:
            return False
        layer, (gr, gc) = info
        graph = self.graph(layer)
        g_chunk = self._chunk_of_tile(gr, gc)
        blocked, buried = self._blocked_edges(layer)
        if not blocked and not buried:
            return False
        goal_costs = {p: 0.0 for p in graph.by_chunk.get(g_chunk, [])}
        start_costs: dict[int, float] = {}
        for ci in occupied_chunk_idxs:
            chunk = (int(ci) // self.cfg.chunks_c, int(ci) % self.cfg.chunks_c)
            if chunk == g_chunk:
                continue
            for p in graph.by_chunk.get(chunk, []):
                start_costs[p] = 0.0
        if not start_costs or not goal_costs:
            return False

        def geom(path):
            if path is None:
                return None
            return tuple((graph.portals[p].chunk, graph.portals[p].side,
                          graph.portals[p].lo, graph.portals[p].hi)
                         for p in path)

        # both runs use the pure-Python solver (a dummy blocked edge forces
        # it), so native/Python tie-breaks never read as a route change
        dummy = frozenset({(-1, -1)})
        filt = pt.astar_portals(
            graph, {p: c for p, c in start_costs.items() if p not in buried},
            {p: c for p, c in goal_costs.items() if p not in buried},
            (gr, gc), (blocked | dummy) if blocked else dummy)
        plain = pt.astar_portals(graph, start_costs, goal_costs, (gr, gc), dummy)
        return geom(filt) != geom(plain)

    def _blocked_edges(self, layer: int) -> tuple[frozenset, frozenset]:
        """(blocked portal edges, buried portal pids) for a layer under the
        current blocker snapshot, from host local-island labels (scipy;
        4-connectivity is exactly the no-corner-cutting pathing
        connectivity). Cached per (layer, snapshot epoch)."""
        cached = self._edge_cache.get(layer)
        if cached is not None and cached[0] == self._blocker_epoch:
            return cached[1], cached[2]
        blk = self._blocker_snap
        graph = self.graph(layer)
        empty = (frozenset(), frozenset())
        if blk is None or not blk[layer].any():
            self._edge_cache[layer] = (self._blocker_epoch, *empty)
            return empty
        cfg = self.cfg
        b = blk[layer]
        chunk_any = b.reshape(cfg.chunks_r, FIELD_RES, cfg.chunks_c,
                              FIELD_RES).any(axis=(1, 3))
        dirty = [(r, c) for r, c in zip(*np.nonzero(chunk_any))
                 if graph.by_chunk.get((int(r), int(c)))]
        if not dirty:
            self._edge_cache[layer] = (self._blocker_epoch, *empty)
            return empty
        from scipy import ndimage
        labels = np.empty((len(dirty), FIELD_RES, FIELD_RES), np.int32)
        for i, (cr, cc) in enumerate(dirty):
            sl = (slice(cr * FIELD_RES, (cr + 1) * FIELD_RES),
                  slice(cc * FIELD_RES, (cc + 1) * FIELD_RES))
            passable = (self.cost_base[layer][sl] != COST_IMPASSABLE) & (b[sl] == 0)
            lab, _n = ndimage.label(passable)
            labels[i] = lab - 1
        comp: dict[int, int] = {}
        for i, chunk in enumerate(dirty):
            for pid in graph.by_chunk.get((int(chunk[0]), int(chunk[1])), []):
                t = graph.portals[pid].span_tiles()
                lab = labels[i][t[:, 0], t[:, 1]]
                lab = lab[lab >= 0]
                comp[pid] = int(lab.min()) if lab.size else -1
        blocked: set[tuple[int, int]] = set()
        buried: set[int] = set()
        for pid, c in comp.items():
            p = graph.portals[pid]
            if c < 0:
                buried.add(pid)
                for qid, _w in graph.adj[pid]:
                    blocked.add((pid, qid))
                    blocked.add((qid, pid))
                continue
            for qid, _w in graph.adj[pid]:
                if qid == p.paired:
                    continue
                qc = comp.get(qid)
                if qc is not None and qc != c:
                    blocked.add((pid, qid))
        out = (frozenset(blocked), frozenset(buried))
        self._edge_cache[layer] = (self._blocker_epoch, *out)
        self.stats["blocked_edges"] = len(blocked)
        return out

    # -- helpers -----------------------------------------------------------------

    def _chunk_of_tile(self, r: int, c: int) -> tuple[int, int]:
        return r // FIELD_RES, c // FIELD_RES

    def _chunk_idx(self, cr: int, cc: int) -> int:
        return cr * self.cfg.chunks_c + cc

    def _chunk_cost(self, layer: int, cr: int, cc: int,
                    with_blockers: bool = True) -> np.ndarray:
        """Static chunk cost from the host mirror, optionally with live
        blockers stamped impassable."""
        sl = (layer, slice(cr * FIELD_RES, (cr + 1) * FIELD_RES),
              slice(cc * FIELD_RES, (cc + 1) * FIELD_RES))
        base = self.cost_base[sl]
        if not with_blockers:
            return base
        blk = self._chunk_blockers(layer, cr, cc)
        return np.where(blk > 0, np.uint8(COST_IMPASSABLE), base)

    def _chunk_blockers(self, layer: int, cr: int, cc: int) -> np.ndarray:
        """Live unit blockers for a chunk from the host snapshot."""
        if self._blocker_snap is None:
            return np.zeros((FIELD_RES, FIELD_RES), np.int32)
        return self._blocker_snap[layer, cr * FIELD_RES:(cr + 1) * FIELD_RES,
                                  cc * FIELD_RES:(cc + 1) * FIELD_RES]

    def _portal_span_costs(self, graph: pt.PortalGraph, integ: np.ndarray,
                           chunk: tuple[int, int]) -> dict[int, float]:
        """pid -> min integration cost over the portal span."""
        out = {}
        for pid in graph.by_chunk.get(chunk, []):
            t = graph.portals[pid].span_tiles()
            d = float(integ[t[:, 0], t[:, 1]].min())
            if d < INF_COST / 2:
                out[pid] = d
        return out

    def _integrate_host(self, costs: np.ndarray, seeds: np.ndarray,
                        svals: np.ndarray | None = None) -> torch.Tensor:
        """One batched per-chunk integration on the service's device."""
        dev = self.device
        return integrate(
            torch.from_numpy(np.ascontiguousarray(costs)).to(dev),
            torch.from_numpy(np.ascontiguousarray(seeds)).to(dev),
            None if svals is None
            else torch.from_numpy(np.ascontiguousarray(svals)).to(dev))

    # -- path requests ------------------------------------------------------------

    def _nearest_on_island(self, layer: int, island: int, near_rc):
        """Closest tile of `island` to `near_rc` (ref: nav.c:1860-1935)."""
        isl = self.islands(layer)
        ok = isl == island
        if island < 0 or not ok.any():
            return None
        rr, cc = np.nonzero(ok)
        dr = np.abs(rr - near_rc[0])
        dc = np.abs(cc - near_rc[1])
        i = int(np.argmin(np.maximum(dr, dc) + 0.5 * np.minimum(dr, dc)))
        return int(rr[i]), int(cc[i])

    def _start_island(self, layer: int, sr: int, sc: int):
        """Island of the start tile (or of the nearest passable tile), plus
        the possibly moved seed tile."""
        isl = self.islands(layer)
        if isl[sr, sc] >= 0:
            return int(isl[sr, sc]), sr, sc
        ok = isl >= 0
        if not ok.any():
            return -1, sr, sc
        rr, cc = np.nonzero(ok)
        i = int(np.argmin(np.maximum(np.abs(rr - sr), np.abs(cc - sc))))
        return int(isl[rr[i], cc[i]]), int(rr[i]), int(cc[i])

    def request_paths(self, state: GameState, reqs):
        """Plan many path requests with batched device work; `reqs` are
        (flock_id, start_xz, goal_xz, layer). Returns (state, [(reachable,
        effective_goal_xz)]): an unreachable goal retargets to the closest
        tile of the start's island (ref: nav.c:1860-1935)."""
        cfg = self.cfg
        results: list = [None] * len(reqs)
        live = []
        for ri, (fid, start_xz, goal_xz, layer) in enumerate(reqs):
            self.stats["requests"] += 1
            sr, sc = tile_of(start_xz)
            gr, gc = tile_of(goal_xz)
            sr = min(max(sr, 0), cfg.field_h - 1)
            sc = min(max(sc, 0), cfg.field_w - 1)
            gr = min(max(gr, 0), cfg.field_h - 1)
            gc = min(max(gc, 0), cfg.field_w - 1)
            isl = self.islands(layer)
            start_isl, sr, sc = self._start_island(layer, sr, sc)
            if start_isl < 0:
                self.stats["failed"] += 1
                state = self._clear_flock(state, fid)
                results[ri] = (False, goal_xz)
                continue
            if isl[gr, gc] != start_isl:
                rt = self._nearest_on_island(layer, start_isl, (gr, gc))
                if rt is None:
                    self.stats["failed"] += 1
                    state = self._clear_flock(state, fid)
                    results[ri] = (False, goal_xz)
                    continue
                gr, gc = rt
                goal_xz = ((gc + 0.5) * NAV_TILE_SIZE, (gr + 0.5) * NAV_TILE_SIZE)
                self.stats["retargeted"] += 1
            live.append((ri, fid, layer, (sr, sc), (gr, gc), goal_xz))

        if not live:
            return state, [r or (False, reqs[i][2]) for i, r in enumerate(results)]

        # one integration over every live request's start + goal chunks
        # (static cost: the requesters' own blockers must not bury seeds)
        k = 2 * len(live)
        costs = np.empty((k, FIELD_RES, FIELD_RES), np.uint8)
        seeds = np.zeros((k, FIELD_RES, FIELD_RES), bool)
        for i, (_ri, _fid, layer, (sr, sc), (gr, gc), _g) in enumerate(live):
            costs[2 * i] = self._chunk_cost(layer, *self._chunk_of_tile(sr, sc),
                                            with_blockers=False)
            costs[2 * i + 1] = self._chunk_cost(
                layer, *self._chunk_of_tile(gr, gc), with_blockers=False)
            seeds[2 * i, sr % FIELD_RES, sc % FIELD_RES] = True
            seeds[2 * i + 1, gr % FIELD_RES, gc % FIELD_RES] = True
        integ = self._integrate_host(costs, seeds).cpu().numpy()

        plans = []
        for i, (ri, fid, layer, (sr, sc), (gr, gc), goal_xz) in enumerate(live):
            graph = self.graph(layer)
            s_chunk = self._chunk_of_tile(sr, sc)
            g_chunk = self._chunk_of_tile(gr, gc)
            s_integ, g_integ = integ[2 * i], integ[2 * i + 1]
            if (s_chunk == g_chunk
                    and s_integ[gr % FIELD_RES, gc % FIELD_RES] < INF_COST / 2):
                chunk_seq = [(g_chunk, None, 0.0)]
            else:
                start_costs = self._portal_span_costs(graph, s_integ, s_chunk)
                goal_costs = self._portal_span_costs(graph, g_integ, g_chunk)
                self._goal_span_cache[(layer, gr, gc)] = goal_costs
                blocked, buried = self._blocked_edges(layer)
                sc_f = {p: c for p, c in start_costs.items() if p not in buried}
                gc_f = {p: c for p, c in goal_costs.items() if p not in buried}
                path = pt.astar_portals(graph, sc_f, gc_f, (gr, gc), blocked)
                if path is None and blocked:
                    path = pt.astar_portals(graph, start_costs, goal_costs,
                                            (gr, gc))
                if path is None:
                    self.stats["failed"] += 1
                    state = self._clear_flock(state, fid)
                    results[ri] = (False, goal_xz)
                    continue
                chunk_seq = self._chunk_seq_from_path(graph, path, goal_costs,
                                                      g_chunk)
            self.flock_chunks[fid] = (
                {self._chunk_idx(*c) for c, _, _ in chunk_seq}
                | {self._chunk_idx(*s_chunk), self._chunk_idx(*g_chunk)})
            self.flock_goal[fid] = (layer, (gr, gc))
            self._extend_failed = {k for k in self._extend_failed if k[0] != fid}
            self.flock_plan_detoured[fid] = self.blockers_change_route(
                fid, [self._chunk_idx(*s_chunk)])
            plans.append(dict(flock_id=fid, layer=layer, goal_rc=(gr, gc),
                              chunk_seq=chunk_seq, extend=False))
            results[ri] = (True, goal_xz)

        if plans:
            state = self._install_fields_batch(state, plans)
        return state, results

    @staticmethod
    def _chunk_seq_from_path(graph, path, goal_costs, g_chunk):
        """Walk an A* portal path backwards into (chunk, seed signature,
        cost to goal) entries: the goal chunk seeded at the goal, every
        other path chunk at its exit-portal span (ref: nav.c:1941-2042)."""
        ctg = {path[-1]: float(goal_costs.get(path[-1], 0.0))}
        for i in range(len(path) - 2, -1, -1):
            w = next(w for q, w in graph.adj[path[i]] if q == path[i + 1])
            ctg[path[i]] = ctg[path[i + 1]] + float(w)
        seq = [(g_chunk, None, 0.0)]
        for i in range(len(path) - 1):
            p = graph.portals[path[i]]
            if p.paired == path[i + 1]:
                seq.append((p.chunk, ("portal", path[i]), ctg[path[i]]))
        return seq

    def extend_fields(self, state: GameState, flock_id: int, chunk_idxs):
        return self.extend_fields_batch(state, {flock_id: chunk_idxs})

    def extend_fields_batch(self, state: GameState, wants: dict):
        """On-demand fields for chunks flocks occupy off their planned path,
        installed with one batched build."""
        plans = [p for p in (self._extend_plan(fid, ci)
                             for fid, ci in wants.items()) if p is not None]
        if not plans:
            return state
        return self._install_fields_batch(state, plans)

    def _extend_plan(self, flock_id: int, chunk_idxs) -> dict | None:
        """Plan (host A*) the field extension for occupied chunks the
        flock's plan never covered (ref: fieldcache.c:59-102)."""
        info = self.flock_goal.get(flock_id)
        if info is None:
            return None
        chunk_idxs = [int(ci) for ci in chunk_idxs
                      if self.slot_mirror[flock_id, int(ci)] < 0
                      and (flock_id, int(ci)) not in self._extend_failed]
        if not chunk_idxs:
            return None
        layer, (gr, gc) = info
        graph = self.graph(layer)
        g_chunk = self._chunk_of_tile(gr, gc)
        goal_costs_all = self._goal_span_cache.get((layer, gr, gc))
        if goal_costs_all is None:
            gcost = self._chunk_cost(layer, *g_chunk, with_blockers=False)[None]
            seeds = np.zeros((1, FIELD_RES, FIELD_RES), bool)
            seeds[0, gr % FIELD_RES, gc % FIELD_RES] = True
            ginteg = self._integrate_host(gcost, seeds).cpu().numpy()[0]
            goal_costs_all = self._portal_span_costs(graph, ginteg, g_chunk)
            self._goal_span_cache[(layer, gr, gc)] = goal_costs_all
        blocked, buried = self._blocked_edges(layer)
        goal_costs = {p: c for p, c in goal_costs_all.items() if p not in buried}
        new_seq = []
        covered: set[int] = set()
        for ci in chunk_idxs:
            if (self.slot_mirror[flock_id, ci] >= 0 or ci in covered
                    or (flock_id, ci) in self._extend_failed):
                continue
            chunk = (ci // self.cfg.chunks_c, ci % self.cfg.chunks_c)
            if chunk == g_chunk:
                new_seq.append((chunk, None, 0.0))
                covered.add(ci)
                continue
            pids = graph.by_chunk.get(chunk, [])
            start_costs = {p: 0.0 for p in pids if p not in buried}
            path = pt.astar_portals(graph, start_costs, goal_costs, (gr, gc),
                                    blocked)
            if path is None and blocked:
                path = pt.astar_portals(graph, {p: 0.0 for p in pids},
                                        goal_costs_all, (gr, gc))
            if path is None:
                self._extend_failed.add((flock_id, ci))
                continue
            for entry in self._chunk_seq_from_path(graph, path, goal_costs_all,
                                                   g_chunk):
                ei = self._chunk_idx(*entry[0])
                if self.slot_mirror[flock_id, ei] < 0 and ei not in covered:
                    new_seq.append(entry)
                    covered.add(ei)
        if not new_seq:
            return None
        self.flock_chunks.setdefault(flock_id, set()).update(covered)
        return dict(flock_id=flock_id, layer=layer, goal_rc=(gr, gc),
                    chunk_seq=new_seq, extend=True)

    # -- field building ----------------------------------------------------------

    def _install_fields_batch(self, state: GameState, plans: list) -> GameState:
        """Install flow + LOS fields for many plans: every missing flow
        field in ONE batched integration, every missing LOS map in one
        batched whole-map build, both flock tables pushed once. A chunk the
        path visits once gets a plain field (shareable key); a chunk visited
        twice gets a union field whose seeds carry their remaining cost.
        Extend plans add chunks without dropping the flock's rows."""
        cfg = self.cfg
        flow_jobs: list = []
        flow_pending: dict[int, int] = {}
        los_jobs: list = []
        los_pending: dict[int, int] = {}

        for plan in plans:
            flock_id = plan["flock_id"]
            layer = plan["layer"]
            gr, gc = plan["goal_rc"]
            graph = self.graph(layer)
            groups: dict = {}
            order_chunks = []
            for chunk, sig, cost in plan["chunk_seq"]:
                if chunk not in groups:
                    order_chunks.append(chunk)
                groups.setdefault(chunk, []).append((sig, cost))

            # keys use the portal's geometry, not its pid (pids renumber
            # when a graph rebuilds)
            def sig_key(sig, c=None, gr=gr, gc=gc, graph=graph):
                if sig is None:
                    return ("goal", gr, gc) if c is None else ("goal", 0.0)
                p = graph.portals[sig[1]]
                ident = ("portal", p.side, p.lo, p.hi)
                return ident if c is None else ident + (round(c, 1),)

            ordered = []
            for chunk in order_chunks:
                specs = groups[chunk]
                if len(specs) == 1:
                    key = (layer, chunk, sig_key(specs[0][0]))
                else:
                    key = (layer, chunk, ("multi", (gr, gc)) + tuple(
                        sorted(sig_key(s, c) for s, c in specs)))
                ordered.append((chunk, specs, key))

            if not plan["extend"]:
                self.slot_mirror[flock_id, :] = -1
                self.los_mirror[flock_id, :] = -1

            for chunk, specs, key in ordered:
                slot = self.flow_cache.get(key)
                if slot is None:
                    self.stats["misses"] += 1
                    slot, evicted = self.flow_cache.put(key)
                    if evicted is not None:
                        self.slot_mirror[self.slot_mirror == slot] = -1
                        stale = flow_pending.pop(slot, None)
                        if stale is not None:
                            flow_jobs[stale] = None
                    seeds = np.zeros((FIELD_RES, FIELD_RES), bool)
                    svals = np.zeros((FIELD_RES, FIELD_RES), np.float32)
                    multi = len(specs) > 1
                    for sig, c in specs:
                        if sig is None:
                            seeds[gr % FIELD_RES, gc % FIELD_RES] = True
                        else:
                            t = graph.portals[sig[1]].span_tiles()
                            seeds[t[:, 0], t[:, 1]] = True
                            svals[t[:, 0], t[:, 1]] = c if multi else 0.0
                    flow_pending[slot] = len(flow_jobs)
                    flow_jobs.append(dict(layer=layer, chunk=chunk, seeds=seeds,
                                          svals=svals, slot=slot))
                else:
                    self.stats["hits"] += 1
                self.slot_mirror[flock_id, self._chunk_idx(*chunk)] = slot

            # LOS for every chunk along the path: one whole-map LOS build
            # per goal, cut into the per-chunk slab (ref: field.c:435-537)
            for chunk, _specs, _key in ordered:
                los_key = (layer, chunk, ("los", gr, gc))
                slot = self.los_cache.get(los_key)
                if slot is None:
                    slot, evicted = self.los_cache.put(los_key)
                    if evicted is not None:
                        self.los_mirror[self.los_mirror == slot] = -1
                        stale = los_pending.pop(slot, None)
                        if stale is not None:
                            los_jobs[stale] = None
                    los_pending[slot] = len(los_jobs)
                    los_jobs.append(dict(layer=layer, gr=gr, gc=gc,
                                         chunk=chunk, slot=slot))
                self.los_mirror[flock_id, self._chunk_idx(*chunk)] = slot

        dev = self.device
        jobs = [j for j in flow_jobs if j is not None]
        if jobs:
            seeds_np = np.stack([j["seeds"] for j in jobs])
            blks = np.stack([self._chunk_blockers(j["layer"], *j["chunk"])
                             for j in jobs])
            # fields flow around parked units, but a blocker never buries a
            # seed tile (goal / portal span)
            costs_np = np.where(
                (blks > 0) & ~seeds_np, np.uint8(COST_IMPASSABLE),
                np.stack([self._chunk_cost(j["layer"], *j["chunk"],
                                           with_blockers=False) for j in jobs]))
            svals_np = np.stack([j["svals"] for j in jobs])
            integ = self._integrate_host(costs_np, seeds_np, svals_np)
            dirs = ff.flow_dirs(integ, torch.from_numpy(costs_np).to(dev))
            slots = torch.as_tensor([j["slot"] for j in jobs], dtype=torch.long,
                                    device=dev)
            state.fields.flow[slots] = dirs
            self.stats["chunks_built"] += len(jobs)

        ljobs = [j for j in los_jobs if j is not None]
        if ljobs:
            uniq: list[tuple[int, int, int]] = []
            uidx: dict[tuple[int, int, int], int] = {}
            for j in ljobs:
                key = (j["layer"], j["gr"], j["gc"])
                if key not in uidx:
                    uidx[key] = len(uniq)
                    uniq.append(key)
            cr, cc = cfg.chunks_r, cfg.chunks_c
            lay = torch.as_tensor([u[0] for u in uniq], dtype=torch.long,
                                  device=dev)
            passable = state.nav.cost_base[lay] != COST_IMPASSABLE
            maps = ff.los_field(passable, [u[1] for u in uniq],
                                [u[2] for u in uniq])
            tiles = (maps.reshape(len(uniq), cr, FIELD_RES, cc, FIELD_RES)
                     .permute(0, 1, 3, 2, 4)
                     .reshape(len(uniq) * cr * cc, FIELD_RES, FIELD_RES))
            flat = torch.as_tensor(
                [uidx[(j["layer"], j["gr"], j["gc"])] * cr * cc
                 + j["chunk"][0] * cc + j["chunk"][1] for j in ljobs],
                dtype=torch.long, device=dev)
            slots = torch.as_tensor([j["slot"] for j in ljobs], dtype=torch.long,
                                    device=dev)
            state.fields.los[slots] = tiles[flat]

        return self._push_tables(state)

    # -- whole-map fields (enemy-seek / chase) ------------------------------------

    def build_enemy_seek_fields_batch(self, state: GameState, specs: list
                                      ) -> GameState:
        """Rebuild many whole-map enemy-seek fields at once: `specs` are
        (faction, layer, global slot, flock id or None). Each field flows
        toward every living unit at war with `faction`, over `layer`'s
        static costs (enemies stand on blocked tiles, so blockers are
        ignored); one seed scatter, one batched integration, one slab
        write. A flock id points that flock's ``global_slot`` at the field;
        None writes the slab only (the per-faction chase fields)."""
        if not specs:
            return state
        cfg, dev = self.cfg, self.device
        h, w = cfg.field_h, cfg.field_w
        facs = torch.as_tensor([sp[0] for sp in specs], dtype=torch.long,
                               device=dev)
        ents = state.ents
        war = state.factions.diplomacy == DiplomacyState.WAR
        fac_c = torch.clamp(ents.faction, 0, war.shape[0] - 1).long()
        enemy = (ents.alive & (ents.hp > 0))[None, :] & war[facs][:, fac_c]
        c = torch.clamp((ents.pos[:, 0] / NAV_TILE_SIZE).to(torch.int32), 0, w - 1)
        r = torch.clamp((ents.pos[:, 1] / NAV_TILE_SIZE).to(torch.int32), 0, h - 1)
        tgt = torch.where(enemy, (r * w + c)[None, :], h * w).long()   # [K, N]
        seeds = torch.zeros((len(specs), h * w + 1), dtype=torch.bool,
                            device=dev)
        seeds.scatter_(1, tgt, True)
        return self._install_global(
            state, [sp[1] for sp in specs], [sp[2] for sp in specs],
            seeds[:, :-1].reshape(len(specs), h, w), [sp[3] for sp in specs])

    def build_enemy_seek_field(self, state: GameState, faction: int,
                               layer: int, slot: int,
                               flock_id: int | None = None) -> GameState:
        """One whole-map enemy-seek field (a batch of one)."""
        return self.build_enemy_seek_fields_batch(
            state, [(faction, layer, slot, flock_id)])

    def _install_global(self, state: GameState, layers, slots, seeds,
                        flock_ids) -> GameState:
        """Integrate whole-map seed masks bool[K, H, W] over their layers'
        costs, write the flow directions into the global slab `slots`, and
        point each non-None flock id's ``global_slot`` at its field."""
        cfg, dev = self.cfg, self.device
        lay = torch.as_tensor(layers, dtype=torch.long, device=dev)
        cost = state.nav.cost_base[lay]
        # the JAX package runs this on XLA (ff.integrate, the same sweeps);
        # K2 integrates whole maps too, one thread-block cluster per field
        integ = integrate(cost, seeds.contiguous(),
                          max_iters=4 * max(cfg.field_h, cfg.field_w))
        sl = torch.as_tensor(slots, dtype=torch.long, device=dev)
        state.fields.global_flow[sl] = ff.flow_dirs(integ, cost)
        owned = [(f, s) for f, s in zip(flock_ids, slots) if f is not None]
        if owned:
            state.flocks.global_slot[torch.as_tensor(
                [f for f, _ in owned], dtype=torch.long, device=dev)] = \
                torch.as_tensor([s for _, s in owned], dtype=torch.int32,
                                device=dev)
        self.stats["seek_batches"] += 1
        self.stats["seek_fields"] += len(slots)
        return state

    def _push_tables(self, state: GameState) -> GameState:
        """Copy both host slot tables into the device flock table."""
        dev = self.device
        state.flocks.field_slot = torch.from_numpy(
            self.slot_mirror.astype(np.int32)).to(dev)
        state.flocks.los_slot = torch.from_numpy(
            self.los_mirror.astype(np.int32)).to(dev)
        return state

    def _clear_flock(self, state: GameState, flock_id: int) -> GameState:
        self.flock_chunks.pop(flock_id, None)
        self.flock_goal.pop(flock_id, None)
        self.flock_plan_detoured.pop(flock_id, None)
        self._extend_failed = {k for k in self._extend_failed
                               if k[0] != flock_id}
        self.slot_mirror[flock_id, :] = -1
        self.los_mirror[flock_id, :] = -1
        state.flocks.field_slot[flock_id] = -1
        state.flocks.los_slot[flock_id] = -1
        return state
