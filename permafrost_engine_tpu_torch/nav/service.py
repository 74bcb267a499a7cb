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
     flock's chunk->slot tables at both (``install_fields``: the slots on
     the host, ``assign_fields``, then the device work, ``build_fields``,
     which an order batch runs once for many orders)

Field keys are (layer, chunk, seed signature), so flocks sharing a goal or
portal reuse fields (ref: fieldcache.h:53-167).

Whole-map fields (the per-(faction, layer) chase fields combat chasers
follow and the seek-enemies flocks' fields, ref: field.c:1209-1678, built
in one batch per refresh by ``build_enemy_seek_fields_batch``; surround
fields toward one entity, ``build_surround_field``) are integrated at
256x256. That integration is an XLA op in the JAX package
(``ff.integrate`` with a cap of 4*max(H, W) sweeps), the same Jacobi
min-plus schedule as the Pallas kernel; here it goes through K2 like every
chunk, one thread-block cluster per field.

Formation orders replace a flock's fields in the chunks holding its cells
with cell-seeded fields (``install_formation_field``). Structures are
stamped on the host (``stamp_structure``) and committed together
(``commit_structures``): the effective costs are pushed, the built portal
graphs are updated incrementally (``portals.update_portal_graph``, one K2
launch over the relinked chunks) and the fields at dirty chunks dropped.

The JAX version pads every batch to a small fixed set of sizes and
pre-compiles them (``prewarm``, ``batch_buckets``, the seek batch's
sentinel spec): that exists to avoid remote XLA compiles. Eager PyTorch has
no compile per shape, so batches run at their own size.
"""

from __future__ import annotations

from collections import OrderedDict
from collections.abc import KeysView

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
from permafrost_engine_tpu_torch.core.perf import Perf
from permafrost_engine_tpu_torch.nav import portals as pt
from permafrost_engine_tpu_torch.ops import flowfield as ff
from permafrost_engine_tpu_torch.ops.flowfield_cuda import integrate
from permafrost_engine_tpu_torch.ops.islands import label_islands_host
from permafrost_engine_tpu_torch.state.schema import GameState


class LruSlab:
    """LRU key->slot assignment over a fixed number of slab slots, and the
    host table of the slots each flock points at per chunk (``mirror``,
    int64[max_flocks, num_chunks], -1 for none): a slot that leaves the
    slab is scrubbed from every flock's row."""

    def __init__(self, num_slots: int, mirror: np.ndarray):
        self.num_slots = num_slots
        self.mirror = mirror
        self.order: OrderedDict[tuple, int] = OrderedDict()
        self.free = list(range(num_slots - 1, -1, -1))

    def get(self, key) -> int | None:
        slot = self.order.get(key)
        if slot is not None:
            self.order.move_to_end(key)
        return slot

    def put(self, key) -> tuple[int, tuple | None]:
        """Assign a slot for key, evicting the least recent key when full;
        returns (slot, evicted key or None)."""
        if key in self.order:
            self.order.move_to_end(key)
            return self.order[key], None
        evicted = None
        if not self.free:
            evicted = next(iter(self.order))
            self.drop(evicted)
        slot = self.free.pop()
        self.order[key] = slot
        return slot, evicted

    def drop(self, key) -> None:
        """Take key out: its slot is freed and no flock points at it."""
        slot = self.order.pop(key)
        self.free.append(slot)
        self.mirror[self.mirror == slot] = -1

    def clear(self) -> None:
        """Drop every key, as a fresh slab."""
        self.order.clear()
        self.free = list(range(self.num_slots - 1, -1, -1))
        self.mirror[:] = -1

    @property
    def stats(self):
        return {"entries": len(self.order), "free": len(self.free)}


class FieldJobs:
    """The fields slab slots were assigned for and wait to be built
    (``NavService.assign_fields`` fills it, ``build_fields`` empties it):
    ``flow`` {slot: (layer, chunk, seeds, seed costs)} and ``los`` {slot:
    (layer, goal row, goal col, chunk)}, in the order the slots were last
    taken: a slot taken again (its field evicted) holds only its last field;
    ``rows``: whether flock rows changed since the last build."""

    def __init__(self):
        self.flow: dict[int, tuple] = {}
        self.los: dict[int, tuple] = {}
        self.rows = False

    def take(self) -> tuple[dict, dict, bool]:
        """(flow, los, rows), leaving the jobs empty."""
        out = self.flow, self.los, self.rows
        self.__init__()
        return out


def tile_of(xz) -> tuple[int, int]:
    """Global nav-tile (r, c) for a world position (x, z)."""
    return int(xz[1] // NAV_TILE_SIZE), int(xz[0] // NAV_TILE_SIZE)


class NavService:
    """Host-side navigation orchestrator bound to one engine instance.

    It alone holds a flock's navigation state and writes the device copies
    of its host state (``state.nav.cost_base``, ``flocks.field_slot``,
    ``flocks.los_slot``), which equal the host mirrors after every public
    call. Slab slots and flock rows are int64 on the host (``slot_mirror``,
    ``los_mirror``) and int32 in the device tables, explicitly converted
    when pushed."""

    # attributes a session blob lists by name (as the JAX blob does), and
    # those that are no session state (the config, device and profiler)
    _SESSION_LISTED = {"structure_ref", "flow_cache", "los_cache",
                       "flock_chunks", "flock_goal", "_blocker_snap",
                       "terrain_cost", "cost_base", "cfg", "device", "perf"}

    def __init__(self, cfg: EngineConfig, cost_base: np.ndarray, *, device,
                 perf: Perf | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        # the owning engine's profiler: the service's device fetches are
        # its waits, named after the order or cadence they serve
        self.perf = perf or Perf()
        self.terrain_cost = cost_base.copy()
        self.cost_base = cost_base.copy()
        # structure refcounts at ground resolution; footprint layers see them
        # dilated (ref: N_CutoutStaticObject nav.c:3326)
        self.structure_ref = np.zeros((cfg.field_h, cfg.field_w), np.int32)
        # chunks dirtied by structure stamps, awaiting commit_structures
        self._pending_dirty: set[int] = set()
        self._graphs: dict[int, pt.PortalGraph] = {}
        self._islands: dict[int, np.ndarray] = {}
        # the row-banded whole-map integrator (parallel/fields.py), set by
        # parallel.step.sharded_engine on a row-sharded mesh: whole-map
        # seek and surround fields are then integrated over the rank bands
        self.sharded_integrate = None
        rows = (cfg.max_flocks, cfg.num_chunks)
        self.flow_cache = LruSlab(cfg.field_slab_slots,
                                  np.full(rows, -1, np.int64))
        self.los_cache = LruSlab(cfg.los_slab_slots, np.full(rows, -1, np.int64))
        self.flock_chunks: dict[int, set[int]] = {}
        self.flock_goal: dict[int, tuple[int, tuple[int, int]]] = {}
        self._extend_failed: set[tuple[int, int]] = set()
        self._goal_span_cache: dict[tuple[int, int, int], dict[int, float]] = {}
        self.flock_plan_detoured: dict[int, bool] = {}
        self._blocker_snap: np.ndarray | None = None
        self._blocker_epoch = 0
        self._edge_cache: dict[int, tuple[int, frozenset, frozenset]] = {}
        self.stats = {"hits": 0, "misses": 0, "requests": 0, "failed": 0,
                      "retargeted": 0, "invalidations": 0, "blocked_edges": 0,
                      "blocker_replans": 0, "chunks_rebuilt": 0,
                      "chunks_built": 0, "seek_batches": 0, "seek_fields": 0}

    @property
    def slot_mirror(self) -> np.ndarray:
        """Host copy of ``flocks.field_slot`` (the flow slab's table)."""
        return self.flow_cache.mirror

    @property
    def los_mirror(self) -> np.ndarray:
        """Host copy of ``flocks.los_slot`` (the LOS slab's table)."""
        return self.los_cache.mirror

    # -- portal graphs and islands -------------------------------------------

    def graph(self, layer: int) -> pt.PortalGraph:
        if layer not in self._graphs:
            self._graphs[layer] = pt.build_portal_graph(
                self.cost_base[layer], self.cfg.chunks_r, self.cfg.chunks_c,
                device=self.device, fetch=self.perf.fetch)
        return self._graphs[layer]

    def islands(self, layer: int) -> np.ndarray:
        """Global island ids for a layer, built on demand from the host
        costs (ref: n_update_components, nav.c:655); each labelling is the
        ``Perf`` scope ``nav.islands``."""
        if layer not in self._islands:
            with self.perf.scope("nav.islands"):
                self._islands[layer] = label_islands_host(self.cost_base[layer])
        return self._islands[layer]

    def invalidate_layer(self, layer: int) -> None:
        """Drop a layer's graph, islands, edge states and cached fields."""
        self._graphs.pop(layer, None)
        self._islands.pop(layer, None)
        self._edge_cache.pop(layer, None)
        self._goal_span_cache = {k: v for k, v in self._goal_span_cache.items()
                                 if k[0] != layer}
        for cache in (self.flow_cache, self.los_cache):
            for k in [k for k in cache.order if k[0] == layer]:
                cache.drop(k)

    def set_terrain(self, state: GameState, cost_base: np.ndarray) -> GameState:
        """Install new compiled terrain costs: the effective costs and both
        flock tables are pushed, every nav derivative rebuilds lazily and
        every cached field is dropped."""
        self.terrain_cost = cost_base.copy()
        self._recompute_effective()
        self._extend_failed.clear()
        for layer in range(self.cfg.num_layers):
            self.invalidate_layer(layer)
        state.nav.cost_base = torch.from_numpy(self.cost_base).to(self.device)
        return self._push_tables(state)

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

    # -- dynamic structures (ref: N_Update nav.c:2119-2206) --------------------

    def stamp_structure(self, tile_rect: tuple[int, int, int, int],
                        delta: int) -> None:
        """Stamp (+1) or unstamp (-1) a structure footprint given as an
        inclusive nav-tile rect (r0, r1, c0, c1). Host-only: the world
        update waits for ``commit_structures``, and the dirty chunks are the
        rect grown by the largest footprint dilation."""
        cfg = self.cfg
        r0, r1, c0, c1 = tile_rect
        r0, c0 = max(0, r0), max(0, c0)
        r1, c1 = min(cfg.field_h - 1, r1), min(cfg.field_w - 1, c1)
        if r1 < r0 or c1 < c0:
            return
        self.structure_ref[r0:r1 + 1, c0:c1 + 1] += delta
        np.clip(self.structure_ref, 0, None, out=self.structure_ref)
        m = NUM_FOOTPRINTS - 1
        for cr in range(max(0, r0 - m) // FIELD_RES,
                        min(cfg.field_h - 1, r1 + m) // FIELD_RES + 1):
            for cc in range(max(0, c0 - m) // FIELD_RES,
                            min(cfg.field_w - 1, c1 + m) // FIELD_RES + 1):
                self._pending_dirty.add(self._chunk_idx(cr, cc))

    def structures_pending(self) -> bool:
        """Whether structure stamps wait for ``commit_structures``."""
        return bool(self._pending_dirty)

    def commit_structures(self, state: GameState
                          ) -> tuple[GameState, set[int] | None]:
        """Apply the pending structure stamps: recompute the effective
        costs and push them to the device, update the built portal graphs
        of the ground and water layers incrementally, drop their islands and
        every cached field at a dirty chunk. Returns (state, dirty chunk
        indices), or (state, None) without touching the device when nothing
        is pending."""
        if not self._pending_dirty:
            return state, None
        dirty, self._pending_dirty = self._pending_dirty, set()
        self._extend_failed.clear()
        self._recompute_effective()
        state.nav.cost_base = torch.from_numpy(self.cost_base).to(self.device)
        cc_n = self.cfg.chunks_c
        dirty_rc = {(d // cc_n, d % cc_n) for d in dirty}
        air0 = int(NavDomain.AIR) * NUM_FOOTPRINTS
        for layer in list(self._graphs):
            if air0 <= layer < air0 + NUM_FOOTPRINTS:
                continue
            self._graphs[layer], n_relinked = pt.update_portal_graph(
                self._graphs[layer], self.cost_base[layer], dirty_rc,
                self.cfg.chunks_r, cc_n, device=self.device,
                fetch=self.perf.fetch)
            self.stats["chunks_rebuilt"] += n_relinked
        # a cutout can split an island anywhere: relabel lazily
        for layer in list(self._islands):
            if not air0 <= layer < air0 + NUM_FOOTPRINTS:
                del self._islands[layer]
        self._edge_cache.clear()      # pids renumbered
        self._goal_span_cache.clear()
        return self._invalidate_chunk_fields(state, dirty), dirty

    def _invalidate_chunk_fields(self, state: GameState,
                                 dirty: set[int]) -> GameState:
        """Drop cached flow fields at the dirty chunks and scrub every flock
        row that points at their slots. LOS slices are cuts of whole-map
        sightline fields, which a structure anywhere can block, so every
        LOS entry drops."""
        changed = False
        for k in [k for k in self.flow_cache.order
                  if self._chunk_idx(*k[1]) in dirty]:
            self.flow_cache.drop(k)
            changed = True
            self.stats["invalidations"] += 1
        if self.los_cache.order:
            self.stats["invalidations"] += len(self.los_cache.order)
            self.los_cache.clear()
            changed = True
        return self._push_tables(state) if changed else state

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

    def detour_flipped(self, fid: int, occupied_chunk_idxs) -> bool:
        """Does the current blocker snapshot change whether the flock's
        route needs a detour, against what its plan found?"""
        return (self.blockers_change_route(fid, occupied_chunk_idxs)
                != self.flock_plan_detoured.get(fid, False))

    def has_blocker_snapshot(self) -> bool:
        return self._blocker_snap is not None

    # -- the flocks' planned paths ------------------------------------------------

    def path_flocks(self) -> KeysView[int]:
        """The flocks holding a planned path, in the order their first
        plans were made (a live view: read it before the next plan)."""
        return self.flock_chunks.keys()

    def flocks_crossing(self, chunks: set[int]) -> dict[int, set[int]]:
        """{flock id: the chunks of `chunks` its planned path crosses} for
        every path flock that crosses one, in ``path_flocks``' order."""
        crossed = {fid: path & chunks for fid, path in self.flock_chunks.items()}
        return {fid: c for fid, c in crossed.items() if c}

    def goal_chunk(self, fid: int) -> int | None:
        """The chunk index of the flock's planned goal (None: unplanned)."""
        info = self.flock_goal.get(fid)
        return None if info is None else self._chunk_idx(
            *self._chunk_of_tile(*info[1]))

    def chunks_under(self, pos: np.ndarray) -> list[int]:
        """The chunk indices under world positions (x, z), each once, in
        the iteration order of their set."""
        cfg = self.cfg
        return list({self._chunk_idx(
            int(np.clip(p[1] // NAV_TILE_SIZE, 0, cfg.field_h - 1)) // FIELD_RES,
            int(np.clip(p[0] // NAV_TILE_SIZE, 0, cfg.field_w - 1)) // FIELD_RES)
            for p in pos})

    def release_flocks(self, state: GameState, fids: list[int]) -> GameState:
        """Drop the flocks' navigation state (planned chunks, goal, detour
        flag, failed extensions) and their slot-table rows, host and device."""
        for fid in fids:
            self.flock_chunks.pop(fid, None)
            self.flock_goal.pop(fid, None)
            self.flock_plan_detoured.pop(fid, None)
        self._extend_failed = {k for k in self._extend_failed
                               if k[0] not in fids}
        self.slot_mirror[fids, :] = -1
        self.los_mirror[fids, :] = -1
        rows = torch.as_tensor(fids, dtype=torch.long, device=self.device)
        state.flocks.field_slot[rows] = -1
        state.flocks.los_slot[rows] = -1
        return state

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

    def _chunk_cost(self, layer: int, cr: int, cc: int) -> np.ndarray:
        """Static chunk cost from the host mirror (live blockers are
        stamped by ``_build_chunk_fields``)."""
        return self.cost_base[layer, cr * FIELD_RES:(cr + 1) * FIELD_RES,
                              cc * FIELD_RES:(cc + 1) * FIELD_RES]

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

    def request_path(self, state: GameState, flock_id: int, start_xz,
                     goal_xz, layer: int):
        """Plan one path and install its chunk fields for a flock: a batch
        of one ``request_paths``. Returns (state, reachable, effective
        goal xz); an unreachable goal retargets to the closest tile of the
        start's island, and a failed request clears the flock's tables."""
        state, results = self.request_paths(
            state, [(flock_id, start_xz, goal_xz, layer)])
        ok, eff = results[0]
        return state, ok, eff

    def request_paths(self, state: GameState, reqs):
        """Plan many path requests with batched device work; `reqs` are
        (flock_id, start_xz, goal_xz, layer). Returns (state, [(reachable,
        effective_goal_xz)]): an unreachable goal retargets to the closest
        tile of the start's island (ref: nav.c:1860-1935)."""
        state, results, plans = self.plan_paths(state, reqs)
        if plans:
            state = self.install_fields(state, plans)
        return state, results

    def plan_paths(self, state: GameState, reqs):
        """``request_paths`` up to the field install: islands, the start
        and goal integration, portal A*. Returns (state, results, plans),
        the plans for ``install_fields``."""
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
            if start_isl < 0 or isl[gr, gc] != start_isl:
                # a start on no island has no nearest tile: the request fails
                rt = self._nearest_on_island(layer, start_isl, (gr, gc))
                if rt is None:
                    self.stats["failed"] += 1
                    state = self.release_flocks(state, [fid])
                    results[ri] = (False, goal_xz)
                    continue
                gr, gc = rt
                goal_xz = ((gc + 0.5) * NAV_TILE_SIZE, (gr + 0.5) * NAV_TILE_SIZE)
                self.stats["retargeted"] += 1
            live.append((ri, fid, layer, (sr, sc), (gr, gc), goal_xz))

        if not live:
            return state, [r or (False, reqs[i][2])
                           for i, r in enumerate(results)], []

        # one integration over every live request's start + goal chunks
        # (static cost: the requesters' own blockers must not bury seeds)
        k = 2 * len(live)
        costs = np.empty((k, FIELD_RES, FIELD_RES), np.uint8)
        seeds = np.zeros((k, FIELD_RES, FIELD_RES), bool)
        for i, (_ri, _fid, layer, (sr, sc), (gr, gc), _g) in enumerate(live):
            costs[2 * i] = self._chunk_cost(layer, *self._chunk_of_tile(sr, sc))
            costs[2 * i + 1] = self._chunk_cost(layer,
                                                *self._chunk_of_tile(gr, gc))
            seeds[2 * i, sr % FIELD_RES, sc % FIELD_RES] = True
            seeds[2 * i + 1, gr % FIELD_RES, gc % FIELD_RES] = True
        integ = self.perf.fetch(self._integrate_host(costs, seeds))

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
                    state = self.release_flocks(state, [fid])
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
        return state, results, plans

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

    def extend_fields_batch(self, state: GameState, wants: dict):
        """On-demand fields for chunks flocks occupy off their planned path,
        installed with one batched build."""
        plans = self.extension_plans(wants)
        if not plans:
            return state
        return self.install_fields(state, plans)

    def extension_plans(self, wants: dict) -> list:
        """``extend_fields_batch`` up to the install: the plans (host A*)
        for the chunks `wants` ({flock id: chunk indices}) names that its
        flocks have no field at and no failed extension."""
        return [p for p in (self._extend_plan(fid, ci)
                            for fid, ci in wants.items()) if p is not None]

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
            gcost = self._chunk_cost(layer, *g_chunk)[None]
            seeds = np.zeros((1, FIELD_RES, FIELD_RES), bool)
            seeds[0, gr % FIELD_RES, gc % FIELD_RES] = True
            ginteg = self.perf.fetch(self._integrate_host(gcost, seeds))[0]
            goal_costs_all = self._portal_span_costs(graph, ginteg, g_chunk)
            self._goal_span_cache[(layer, gr, gc)] = goal_costs_all
        blocked, buried = self._blocked_edges(layer)
        goal_costs = {p: c for p, c in goal_costs_all.items() if p not in buried}
        new_seq = []
        covered: set[int] = set()
        for ci in chunk_idxs:      # each without a field and not failed
            if ci in covered:
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

    def install_fields(self, state: GameState, plans: list) -> GameState:
        """Install flow + LOS fields for many plans: ``assign_fields`` then
        ``build_fields``."""
        jobs = FieldJobs()
        self.assign_fields(plans, jobs)
        return self.build_fields(state, jobs)

    def assign_fields(self, plans: list, jobs: FieldJobs) -> None:
        """The host half of ``install_fields``: give every chunk of the
        plans its flow and LOS slab slots and point the flocks' rows of the
        host tables at them, adding each missing field to `jobs`. A chunk
        the path visits once gets a plain field (shareable key); a chunk
        visited twice gets a union field whose seeds carry their remaining
        cost. Extend plans add chunks without dropping the flock's rows.
        Calls in turn leave the host state one ``install_fields`` of each
        would; a slot taken from a field still waiting in `jobs` drops that
        job."""
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
                    slot = self.flow_cache.put(key)[0]
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
                    jobs.flow.pop(slot, None)      # evicted while waiting
                    jobs.flow[slot] = (layer, chunk, seeds, svals)
                else:
                    self.stats["hits"] += 1
                self.slot_mirror[flock_id, self._chunk_idx(*chunk)] = slot

            # LOS for every chunk along the path: one whole-map LOS build
            # per goal, cut into the per-chunk slab (ref: field.c:435-537)
            for chunk, _specs, _key in ordered:
                los_key = (layer, chunk, ("los", gr, gc))
                slot = self.los_cache.get(los_key)
                if slot is None:
                    slot = self.los_cache.put(los_key)[0]
                    jobs.los.pop(slot, None)       # evicted while waiting
                    jobs.los[slot] = (layer, gr, gc, chunk)
                self.los_mirror[flock_id, self._chunk_idx(*chunk)] = slot
            jobs.rows = True

    def build_fields(self, state: GameState, jobs: FieldJobs) -> GameState:
        """The device half of ``install_fields``: every missing flow field
        of `jobs` in ONE batched integration, every missing LOS map in one
        batched whole-map build over the unique goals, both flock tables
        pushed once (only when rows were assigned since the last build).
        Empties `jobs`."""
        flow, los, rows = jobs.take()
        if flow:
            items = list(flow.items())
            state = self._build_chunk_fields(
                state, [(j[0], j[1], slot) for slot, j in items],
                np.stack([j[2] for _s, j in items]),
                np.stack([j[3] for _s, j in items]))
        if los:
            cfg, dev = self.cfg, self.device
            uniq = list(dict.fromkeys(j[:3] for j in los.values()))
            uidx = {u: i for i, u in enumerate(uniq)}
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
                [uidx[j[:3]] * cr * cc + j[3][0] * cc + j[3][1]
                 for j in los.values()], dtype=torch.long, device=dev)
            slots = torch.as_tensor(list(los), dtype=torch.long, device=dev)
            state.fields.los[slots] = tiles[flat]
        return self._push_tables(state) if rows else state

    def install_formation_field(self, state: GameState, flock_id: int,
                                layer: int, cells_xy: np.ndarray) -> GameState:
        """Replace the flock's fields in the chunks holding its formation
        cells with cell-seeded fields: every cell tile seeds at cost 0, so
        the final approach flows toward the formation's footprint and
        around obstacles near it (ref: src/game/formation.c:354). Keys are
        (layer, chunk, ("cells",) + sorted local tiles); the chunks to build
        are built by ``_build_chunk_fields``. Only the flock's row of the
        slot table is pushed, unless a slab slot was evicted (then both
        tables are)."""
        cfg = self.cfg
        tiles = np.unique(np.stack([
            np.clip(cells_xy[:, 1] // NAV_TILE_SIZE, 0,
                    cfg.field_h - 1).astype(np.int64),
            np.clip(cells_xy[:, 0] // NAV_TILE_SIZE, 0,
                    cfg.field_w - 1).astype(np.int64)], 1), axis=0)
        groups: dict[tuple[int, int], list[tuple[int, int]]] = {}
        for r, c in tiles:
            groups.setdefault(self._chunk_of_tile(int(r), int(c)),
                              []).append((int(r), int(c)))

        to_build, assignments = [], []
        evicted_any = False
        for chunk, ctiles in groups.items():
            local = tuple(sorted((r % FIELD_RES) * FIELD_RES + (c % FIELD_RES)
                                 for r, c in ctiles))
            key = (layer, chunk, ("cells",) + local)
            slot = self.flow_cache.get(key)
            if slot is None:
                self.stats["misses"] += 1
                slot, evicted = self.flow_cache.put(key)
                evicted_any |= evicted is not None
                to_build.append((chunk, ctiles, slot))
            else:
                self.stats["hits"] += 1
            assignments.append((chunk, slot))

        if to_build:
            seeds = np.zeros((len(to_build), FIELD_RES, FIELD_RES), bool)
            for i, (_chunk, ctiles, _slot) in enumerate(to_build):
                for r, c in ctiles:
                    seeds[i, r % FIELD_RES, c % FIELD_RES] = True
            state = self._build_chunk_fields(
                state, [(layer, ch, s) for ch, _t, s in to_build], seeds, None)

        for chunk, slot in assignments:
            idx = self._chunk_idx(*chunk)
            self.slot_mirror[flock_id, idx] = slot
            # through-chunk tracking: structure or blocker changes in the
            # formation's chunks replan it
            self.flock_chunks.setdefault(flock_id, set()).add(idx)
        if evicted_any:
            return self._push_tables(state)
        state.flocks.field_slot[flock_id] = torch.from_numpy(
            self.slot_mirror[flock_id].astype(np.int32)).to(self.device)
        return state

    def _build_chunk_fields(self, state: GameState, jobs: list,
                            seeds: np.ndarray, svals: np.ndarray | None
                            ) -> GameState:
        """Build chunk flow fields into their slab slots with ONE batched
        K2 launch and one ``flow_dirs``: `jobs` are (layer, chunk, slot),
        with their seed masks bool[K, R, R] and seed costs f32[K, R, R]
        (None: every seed at 0). Fields flow around parked units, but a
        blocker never buries a seed tile (goal, portal span or cell)."""
        blks = np.stack([self._chunk_blockers(layer, *chunk)
                         for layer, chunk, _slot in jobs])
        costs = np.where(
            (blks > 0) & ~seeds, np.uint8(COST_IMPASSABLE),
            np.stack([self._chunk_cost(layer, *chunk)
                      for layer, chunk, _slot in jobs]))
        integ = self._integrate_host(costs, seeds, svals)
        dirs = ff.flow_dirs(integ, torch.from_numpy(costs).to(self.device))
        slots = torch.as_tensor([slot for _layer, _chunk, slot in jobs],
                                dtype=torch.long, device=self.device)
        state.fields.flow[slots] = dirs
        self.stats["chunks_built"] += len(jobs)
        return state

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
        if self.sharded_integrate is not None and len(specs) > 1:
            # a sharded engine builds one field at a time through the
            # banded integrator, as the JAX service does
            for sp in specs:
                state = self.build_enemy_seek_fields_batch(state, [sp])
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

    def build_surround_field(self, state: GameState, flock_id: int,
                             target_slotidx: int, layer: int,
                             slot: int) -> GameState:
        """Whole-map field toward one entity (TARGET_ENTITY, field.h:79):
        one seed tile at the target's position, read on the device."""
        h, w = self.cfg.field_h, self.cfg.field_w
        p = state.ents.pos[target_slotidx]
        r = torch.clamp((p[1] / NAV_TILE_SIZE).to(torch.int32), 0, h - 1)
        c = torch.clamp((p[0] / NAV_TILE_SIZE).to(torch.int32), 0, w - 1)
        rows = torch.arange(h, device=self.device)[:, None]
        cols = torch.arange(w, device=self.device)[None, :]
        seeds = ((rows == r) & (cols == c))[None]
        return self._install_global(state, [layer], [slot], seeds, [flock_id])

    def _install_global(self, state: GameState, layers, slots, seeds,
                        flock_ids) -> GameState:
        """Integrate whole-map seed masks bool[K, H, W] over their layers'
        costs, write the flow directions into the global slab `slots`, and
        point each non-None flock id's ``global_slot`` at its field."""
        cfg, dev = self.cfg, self.device
        lay = torch.as_tensor(layers, dtype=torch.long, device=dev)
        cost = state.nav.cost_base[lay]
        if self.sharded_integrate is not None:
            # over the rank bands with a halo exchange, one layer at a time
            integ = torch.stack([self.sharded_integrate(c, s)
                                 for c, s in zip(cost, seeds)])
        else:
            # the JAX package runs this on XLA (ff.integrate, the same
            # sweeps); K2 integrates whole maps too, one thread-block
            # cluster per field
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

    # -- sessions -------------------------------------------------------------------

    def host_state(self) -> dict:
        """The host state a session blob keeps: the ``nav_*`` keys and, as
        ``nav_derived``, every other attribute (graphs, islands, stats).
        The blocker snapshot feeds field builds: restored exactly, a
        loaded session replans bit-identically."""
        return {
            "nav_structure_ref": self.structure_ref,
            "nav_slot_mirror": self.slot_mirror,
            "nav_los_mirror": self.los_mirror,
            "nav_cache_order": list(self.flow_cache.order.items()),
            "nav_cache_free": list(self.flow_cache.free),
            "nav_los_order": list(self.los_cache.order.items()),
            "nav_los_free": list(self.los_cache.free),
            "nav_flock_chunks": dict(self.flock_chunks),
            "nav_flock_goal": dict(self.flock_goal),
            "nav_blocker_snap": self._blocker_snap,
            "nav_derived": {k: v for k, v in vars(self).items()
                            if k not in self._SESSION_LISTED},
        }

    def load_host_state(self, d: dict) -> None:
        """Restore ``host_state``'s dict (the terrain is the constructor's;
        the device state, flock tables included, comes with the blob)."""
        self.structure_ref = np.asarray(d["nav_structure_ref"])
        self._recompute_effective()
        self.flow_cache = LruSlab(self.cfg.field_slab_slots,
                                  np.asarray(d["nav_slot_mirror"]))
        self.flow_cache.order.update(d["nav_cache_order"])
        self.flow_cache.free = list(d["nav_cache_free"])
        self.los_cache = LruSlab(self.cfg.los_slab_slots,
                                 np.asarray(d["nav_los_mirror"]))
        self.los_cache.order.update(d["nav_los_order"])
        self.los_cache.free = list(d["nav_los_free"])
        self.flock_chunks = dict(d["nav_flock_chunks"])
        self.flock_goal = dict(d["nav_flock_goal"])
        snap = d["nav_blocker_snap"]
        self._blocker_snap = None if snap is None else np.asarray(snap)
        vars(self).update(d["nav_derived"])
