"""Host engine facade: entity registry, orders, diplomacy, tick driving.

Port of ``permafrost_engine_tpu/game/engine.py``: scripts spawn units,
order moves and set diplomacy; the engine patches the state between ticks
(the command-queue discipline, ref: src/game/movement.c:371-395), steps the
60 Hz tick (movement, combat, projectiles, corpses, fog), drains its events
every ``drain_period`` frames, and runs the nav cadence every
``seek_refresh_period`` frames.

Ported: ``__init__``, ``set_cost_base``, ``load_map_data`` (heights and the
fog's ``tile_height``), ``add_faction``, ``set_diplomacy``, ``set_stance``,
``spawn_batch``, ``despawn``, ``move`` (with stray-chunk field extension
and ring-slot arrival destinations), ``stop``, ``step``, ``flush_deltas``,
``pos_of``, ``movestate_of``, and the war half of ``_host_systems_tick``:
per-(faction, layer) chase fields, stray-chunk extensions, blocker
snapshots and rate-limited, detour-checked blocker replans, each fed by the
snapshot taken one cadence earlier, as in the JAX engine. Events go to
``events`` and the ``EventBus`` (``bus``), as in the JAX engine; the
cadence's host times go to ``counters``.

Not ported yet, and absent (no method returns quietly in their place):
``seek_enemies``, ``surround`` and ``refresh_seek_fields`` (so the
cadence has no seek-flock branch); formations (``move_in_formation``, unit
types); structures; the scheduler's tasks; the host subsystems (economy,
regions, selection, audio, animation); micro-batched stepping
(``step_scan``); ``core/perf.py`` profiling.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from permafrost_engine_tpu_torch.assets.pfmap import compile_nav_costs
from permafrost_engine_tpu_torch.core.config import (
    ARRIVAL_THRESHOLD,
    DiplomacyState,
    EngineConfig,
    EntityFlags,
    FIELD_RES,
    MoveState,
    NAV_TILE_SIZE,
    NavDomain,
    footprint_for_radius,
    nav_layer,
)
from permafrost_engine_tpu_torch.core.events import EventBus, EventType
from permafrost_engine_tpu_torch.game.arrival import assign_ring_slots
from permafrost_engine_tpu_torch.game.step import make_tick
from permafrost_engine_tpu_torch.nav.service import NavService
from permafrost_engine_tpu_torch.state.schema import (
    GameState,
    empty_deltas,
    init_state,
)


# the cadence's host-time counters (ms), as the JAX engine's perf counters
_COUNTERS = ("blk_snapshot_ms", "blk_sig_fetch_ms", "chase_refresh_ms",
             "field_batch_ms", "blk_occ_fetch_ms", "blk_extend_ms",
             "blk_update_ms", "blk_route_ms", "blk_replan_ms")


def _chunk_cells(pos: torch.Tensor, cr: int, cc: int):
    """Clamped (chunk row, chunk col) of each position."""
    tile = (pos / NAV_TILE_SIZE).to(torch.int32)
    return (torch.clamp(tile[:, 1] // FIELD_RES, 0, cr - 1),
            torch.clamp(tile[:, 0] // FIELD_RES, 0, cc - 1), tile)


def _chunk_sig_kernel(pos, alive, faction, *, f_n: int, cr: int, cc: int):
    """Per-(faction, chunk) presence signature i32[f_n, cr, cc]: folds the
    unit count and quantized tile positions, so it changes whenever a unit
    moves a tile, dies or spawns there (the per-faction blocker-count
    analogue, ref: nav_data.h:118-158). Summed in int64 and wrapped to
    int32, which equals the JAX int32 sums modulo 2^32."""
    crd, ccd, tile = _chunk_cells(pos, cr, cc)
    f = torch.clamp(faction, 0, f_n - 1)
    idx = torch.where(alive, f * (cr * cc) + crd * cc + ccd,
                      f_n * cr * cc).long()
    counts = torch.zeros(f_n * cr * cc + 1, dtype=torch.int64,
                         device=pos.device)
    counts.index_add_(0, idx, torch.ones_like(idx))
    psum = torch.zeros_like(counts)
    psum.index_add_(0, idx, (tile[:, 0] + 8191 * tile[:, 1]).long())
    sig = counts[:-1] * 1_000_003 + psum[:-1]
    return sig.to(torch.int32).reshape(f_n, cr, cc)


def _flock_chunk_occupancy(pos, alive, flock, *, f_n: int, cr: int, cc: int):
    """bool[max_flocks, num_chunks]: the chunks each flock's living members
    occupy (drives on-demand field extension for strays, ref:
    fieldcache.c:59-102)."""
    crd, ccd, _ = _chunk_cells(pos, cr, cc)
    ok = alive & (flock >= 0)
    idx = torch.where(ok, torch.clamp(flock, 0, f_n - 1) * (cr * cc)
                      + crd * cc + ccd, f_n * cr * cc).long()
    occ = torch.zeros(f_n * cr * cc + 1, dtype=torch.bool, device=pos.device)
    occ[idx] = True
    return occ[:-1].reshape(f_n, cr * cc)


def _faction_layer_counts(alive, hp, faction, layer, *, f_n: int, l_n: int):
    """Living-unit counts per (faction, nav layer) i32[f_n, l_n]: which
    layers get chase fields (corpses do not chase, so hold none)."""
    f = torch.clamp(faction, 0, f_n - 1)
    lay = torch.clamp(layer, 0, l_n - 1)
    idx = torch.where(alive & (hp > 0), f * l_n + lay, f_n * l_n).long()
    out = torch.zeros(f_n * l_n + 1, dtype=torch.int32, device=alive.device)
    out.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    return out[:-1].reshape(f_n, l_n)


class Engine:
    """The port's engine on one explicit device (``"cpu"`` or ``"cuda"``);
    see the module docstring for what is and is not ported."""

    def __init__(self, cfg: EngineConfig, *, device, seed: int = 0,
                 cost_base: np.ndarray | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.state: GameState = init_state(cfg, seed=seed, device=self.device)
        if cost_base is None:
            cost_base = np.ones((cfg.num_layers, cfg.field_h, cfg.field_w),
                                np.uint8)
        self.nav = NavService(cfg, cost_base, device=self.device)
        self.state.nav.cost_base = torch.from_numpy(
            np.ascontiguousarray(self.nav.cost_base)).to(self.device)
        self.heights = np.zeros((cfg.field_h, cfg.field_w), np.float32)
        self._tile_height = None
        self._tick_fn = make_tick(cfg)
        self._next_uid = 1
        self._free_slots = list(range(cfg.max_ents - 1, -1, -1))
        self.uid_to_slot: dict[int, int] = {}
        self._slot_uid = np.zeros(cfg.max_ents, np.int64)
        self._free_flocks = list(range(cfg.max_flocks - 1, -1, -1))
        self.events: list[tuple[str, dict]] = []
        self.bus = EventBus()
        self._frame = 0
        self.drain_period = 6
        self._acc = empty_deltas(cfg, device=self.device)
        self.counters = dict.fromkeys(_COUNTERS, 0.0)
        # the nav cadence (see _host_systems_tick)
        self.seek_refresh_period = 30
        self._sigs_inflight = None      # (frame, snapshot) of the last cadence
        self._field_sigs: dict = {}     # field key -> (versions, sigs) built
        self._blocker_replan_frame: dict[int, int] = {}
        self._diplo_version = 0         # a new war rebuilds even if nobody moved
        # global-field slot -> owner (a flock id, or -(faction * L + layer
        # + 1) for a chase field), insertion-ordered: eviction is FIFO/LRU
        self._gslot_owner: dict[int, int] = {}
        self._host_factions: set[int] = set()
        self._host_diplomacy = np.zeros((cfg.max_factions, cfg.max_factions),
                                        np.int32)
        self._chase_gslot: dict[tuple[int, int], int] = {}

    # -- map -------------------------------------------------------------------

    def set_cost_base(self, cost_base: np.ndarray) -> None:
        """Install static per-layer nav costs u8[L, H, W]. Every nav
        derivative (portal graphs, islands, cached fields) is dropped and
        live flocks replan against the new world."""
        if cost_base.shape != (self.cfg.num_layers, self.cfg.field_h,
                               self.cfg.field_w):
            raise ValueError(f"cost_base shape {cost_base.shape} does not "
                             "match the config")
        self.nav.set_terrain(cost_base)
        self.state.nav.cost_base = torch.from_numpy(
            np.ascontiguousarray(self.nav.cost_base)).to(self.device)
        self.state = self.nav._push_tables(self.state)
        self._replan_flocks(None)

    def _replan_flocks(self, dirty: set[int] | None,
                       only_fids: set[int] | None = None) -> set[int]:
        """Re-request paths, in one batched request, for the flocks whose
        installed path crosses `dirty` chunks (None = every path flock);
        the through-chunk half of the reference's cache invalidation (ref:
        fieldcache.h:53-167). A flock whose effective goal is unchanged
        keeps its members' ring slots; one that became unreachable is
        dropped (members direct-seek). Returns the flock ids replanned."""
        st = self.state
        active = st.flocks.active.cpu().numpy()
        if not active.any():
            return set()
        flock = st.ents.flock.cpu().numpy()
        alive = st.ents.alive.cpu().numpy()
        pos = st.ents.pos.cpu().numpy()
        layers = st.flocks.layer.cpu().numpy()
        dests = st.flocks.dest.cpu().numpy()
        reqs, members_of = [], {}
        for fid in np.nonzero(active)[0]:
            fid = int(fid)
            chunks = self.nav.flock_chunks.get(fid)
            if chunks is None:
                continue
            if dirty is not None and not (chunks & dirty):
                continue
            if only_fids is not None and fid not in only_fids:
                continue
            members = np.nonzero(alive & (flock == fid))[0]
            if members.size == 0:
                continue
            members_of[fid] = members
            reqs.append((fid, tuple(pos[members].mean(axis=0)),
                         tuple(dests[fid]), int(layers[fid])))
        if not reqs:
            return set()
        self.state, results = self.nav.request_paths(self.state, reqs)
        e, fl, dev = self.state.ents, self.state.flocks, self.device
        for (fid, _start, goal, layer), (ok, eff) in zip(reqs, results):
            sl = torch.from_numpy(members_of[fid]).to(dev)
            if not ok:
                e.flock[sl] = -1
                continue
            if np.linalg.norm(np.asarray(eff) - np.asarray(goal)) < 1.0:
                continue
            g = np.asarray(eff, np.float32)
            if sl.numel() > 1:
                ring = torch.from_numpy(
                    self._ring_dests(members_of[fid], eff, layer)).to(dev)
                e.dest[sl] = ring
                e.formation_cell[sl] = ring
                e.has_formation_cell[sl] = True
            else:
                e.dest[sl] = torch.from_numpy(g).to(dev)
            fl.dest[fid] = torch.from_numpy(g).to(dev)
        return set(members_of)

    def _goal_chunk_hood(self, fid: int) -> set[int]:
        """The flock's goal chunk, where its own crowd parks."""
        info = self.nav.flock_goal.get(fid)
        if info is None:
            return set()
        _layer, (gr, gc) = info
        return {self.nav._chunk_idx(gr // FIELD_RES, gc // FIELD_RES)}

    def load_map_data(self, map_data) -> None:
        """Install a parsed PFMAP's compiled nav costs and heights (ref:
        AL_MapFromPFMapStream + N_NewCtxForMapData). On uneven terrain (a
        height range above 0.5) the tick is rebuilt with the fog's
        ``tile_height`` (every other nav tile), which selects the
        height-aware shadowcaster; a flat map rebuilds it without."""
        if (map_data.chunks_r, map_data.chunks_c) != (self.cfg.chunks_r,
                                                      self.cfg.chunks_c):
            raise ValueError(
                f"map is {map_data.chunks_r}x{map_data.chunks_c} chunks; "
                f"engine config is {self.cfg.chunks_r}x{self.cfg.chunks_c}")
        cost, heights = compile_nav_costs(map_data)
        self.heights = heights
        self.set_cost_base(cost[:self.cfg.num_layers])
        if np.ptp(heights) > 0.5:
            self._tile_height = torch.from_numpy(np.ascontiguousarray(
                heights[::2, ::2], np.float32)).to(self.device)
        else:
            self._tile_height = None
        self._tick_fn = make_tick(self.cfg, self._tile_height)

    # -- factions / diplomacy ------------------------------------------------------

    def add_faction(self, fac_id: int, controllable: bool = True) -> None:
        self._host_factions.add(fac_id)
        self.state.factions.active[fac_id] = True
        self.state.factions.controllable[fac_id] = controllable

    def set_diplomacy(self, f1: int, f2: int, dstate: int) -> None:
        """Set the (symmetric) diplomatic state of two factions."""
        if self._host_diplomacy[f1, f2] != dstate:
            self._diplo_version += 1
        self._host_diplomacy[f1, f2] = self._host_diplomacy[f2, f1] = dstate
        self.state.factions.diplomacy[f1, f2] = int(dstate)
        self.state.factions.diplomacy[f2, f1] = int(dstate)

    def set_stance(self, uids: list[int], stance: int) -> None:
        self.state.ents.stance[self._slots_of(uids)] = int(stance)

    def _slots_of(self, uids) -> torch.Tensor:
        return torch.as_tensor([self.uid_to_slot[u] for u in uids],
                               dtype=torch.long, device=self.device)

    # -- spawning ---------------------------------------------------------------

    def spawn_batch(self, pos: np.ndarray, faction=0, *, radius=1.0,
                    sel_radius=None, max_speed=10.0, hp=100.0,
                    flags: int = (EntityFlags.COLLISION | EntityFlags.MOVABLE
                                  | EntityFlags.SELECTABLE
                                  | EntityFlags.COMBATABLE),
                    domain: NavDomain = NavDomain.GROUND, vision_range=60.0,
                    attack_range=10.0, base_dmg=10.0, armour_pc=0.0,
                    attack_period=10, is_ranged=False, stance=0) -> list[int]:
        """Spawn M entities in one batch of indexed writes; returns UIDs."""
        m = pos.shape[0]
        if len(self._free_slots) < m:
            raise RuntimeError("entity arena full")
        slots = np.array([self._free_slots.pop() for _ in range(m)], np.int64)
        uids = np.arange(self._next_uid, self._next_uid + m, dtype=np.int64)
        self._next_uid += m
        for u, s in zip(uids, slots):
            self.uid_to_slot[int(u)] = int(s)
        self._slot_uid[slots] = uids

        dev = self.device

        def col(v, dtype=np.float32):
            a = np.array(np.broadcast_to(np.asarray(v, dtype), (m,)))
            return torch.from_numpy(a).to(dev)

        radius_np = np.broadcast_to(np.asarray(radius, np.float32), (m,))
        layers = np.array([nav_layer(domain, footprint_for_radius(float(r)))
                           for r in radius_np], np.int32)
        sl = torch.from_numpy(slots).to(dev)
        e = self.state.ents
        pos_t = torch.from_numpy(np.ascontiguousarray(pos, np.float32)).to(dev)
        hp_t = col(hp)
        e.alive[sl] = True
        e.uid[sl] = torch.from_numpy(uids.astype(np.int32)).to(dev)
        e.flags[sl] = col(int(flags), np.int32)
        e.faction[sl] = col(faction, np.int32)
        e.layer[sl] = torch.from_numpy(layers).to(dev)
        e.pos[sl] = pos_t
        e.prev_pos[sl] = pos_t
        e.radius[sl] = col(radius)
        e.sel_radius[sl] = col(sel_radius if sel_radius is not None else radius)
        e.max_speed[sl] = col(max_speed)
        e.hp[sl] = hp_t
        e.max_hp[sl] = hp_t
        e.movestate[sl] = int(MoveState.ARRIVED)
        e.flock[sl] = -1
        e.vision_range[sl] = col(vision_range)
        e.attack_range[sl] = col(attack_range)
        e.base_dmg[sl] = col(base_dmg)
        e.armour_pc[sl] = col(armour_pc)
        e.attack_period[sl] = col(attack_period, np.int32)
        e.is_ranged[sl] = col(is_ranged, bool)
        e.stance[sl] = col(stance, np.int32)
        e.combatstate[sl] = 0
        e.target[sl] = -1
        return [int(u) for u in uids]

    def despawn(self, uid: int) -> None:
        slot = self.uid_to_slot.pop(uid)
        self.state.ents.alive[slot] = False
        self._free_slots.append(slot)

    # -- commands -----------------------------------------------------------------

    def stop(self, uids: list[int]) -> None:
        sl = self._slots_of(uids)
        e = self.state.ents
        e.movestate[sl] = int(MoveState.ARRIVED)
        e.vel[sl] = 0.0
        e.flock[sl] = -1

    def move(self, uids: list[int], goal_xz) -> bool:
        """Order units to a destination: one flock per nav layer of the
        selection (ref: split_into_layers, movement.c:771-787), every
        layer's path planned in ONE batched request, fields installed
        (ref: G_Move_SetDest -> N_RequestPath, movement.c:4717, 930)."""
        if not uids:
            return False
        if self.nav._blocker_snap is None or not self.nav.flock_chunks:
            self.nav.update_blockers(self.state.nav.blockers.cpu().numpy())
        slots = np.array([self.uid_to_slot[u] for u in uids], np.int64)
        layers = self.state.ents.layer.cpu().numpy()[slots]
        all_pos = self.state.ents.pos.cpu().numpy()

        groups, reqs = [], []
        for layer in np.unique(layers):
            group = slots[layers == layer]
            guids = [u for u, l in zip(uids, layers) if l == layer]
            if not self._free_flocks:
                self._reclaim_flocks()
            if not self._free_flocks:
                raise RuntimeError("flock table full")
            fid = self._free_flocks.pop()
            start = tuple(all_pos[group].mean(axis=0))
            groups.append((guids, group, int(layer), fid))
            reqs.append((fid, start, goal_xz, int(layer)))

        self.state, results = self.nav.request_paths(self.state, reqs)
        ok_any = False
        for (guids, group, layer, fid), (ok, eff_goal) in zip(groups, results):
            self._apply_move_result(guids, group, goal_xz, layer, fid, ok,
                                    eff_goal)
            if ok:
                self._extend_stray_chunks(fid, all_pos[group])
            ok_any |= ok
        return ok_any

    def _reclaim_flocks(self) -> None:
        """Free active flocks no living entity references (the reference
        deletes empty flocks, movement.c make_flocks)."""
        e, fl = self.state.ents, self.state.flocks
        members = torch.where(e.alive, e.flock, -1)
        counts = torch.bincount(members[members >= 0].long(),
                                minlength=self.cfg.max_flocks).cpu().numpy()
        active = fl.active.cpu().numpy()
        freed = [f for f in range(self.cfg.max_flocks)
                 if active[f] and counts[f] == 0]
        if not freed:
            return
        idx = torch.as_tensor(freed, dtype=torch.long, device=self.device)
        fl.active[idx] = False
        fl.global_slot[idx] = -1
        for f in freed:
            self.nav.slot_mirror[f, :] = -1
            self.nav.los_mirror[f, :] = -1
            self.nav.flock_chunks.pop(f, None)
            self.nav.flock_goal.pop(f, None)
            self._field_sigs.pop(f, None)
            self._free_flocks.append(f)
        for gs, owner in list(self._gslot_owner.items()):
            if owner in freed:
                del self._gslot_owner[gs]
        self.state = self.nav._push_tables(self.state)

    def _extend_stray_chunks(self, fid: int, gpos: np.ndarray) -> None:
        """Members in chunks off the planned path (it starts at the
        centroid's chunk) get on-demand fields now."""
        occ = {self.nav._chunk_idx(
            int(np.clip(p[1] // NAV_TILE_SIZE, 0, self.cfg.field_h - 1)) // FIELD_RES,
            int(np.clip(p[0] // NAV_TILE_SIZE, 0, self.cfg.field_w - 1)) // FIELD_RES)
            for p in gpos}
        missing = [c for c in occ if self.nav.slot_mirror[fid, c] < 0]
        if missing:
            self.state = self.nav.extend_fields(self.state, fid, missing)

    def _ring_dests(self, slots: np.ndarray, goal_xz, layer: int) -> np.ndarray:
        """Per-unit packed ring-slot destinations around the goal (ref:
        arrival.h ring fill)."""
        pos = self.state.ents.pos.cpu().numpy()[slots]
        radius = self.state.ents.radius.cpu().numpy()[slots]
        spacing = max(float(radius.max()) * 3.0, ARRIVAL_THRESHOLD + 1.0)
        return np.asarray(assign_ring_slots(
            pos, np.asarray(goal_xz, np.float32), spacing,
            self.nav.cost_base[layer]), np.float32)

    def _apply_move_result(self, uids, slots, goal_xz, layer, fid, ok,
                           eff_goal) -> bool:
        """Flock setup and motion-start events after a path request."""
        goal = np.asarray(eff_goal if ok else goal_xz, np.float32)
        if ok and len(uids) > 1:
            dests, cells_on = self._ring_dests(slots, eff_goal, layer), True
        else:
            dests, cells_on = np.broadcast_to(goal, (len(slots), 2)), False
        dev = self.device
        sl = torch.from_numpy(np.asarray(slots, np.int64)).to(dev)
        d = torch.from_numpy(np.ascontiguousarray(dests, np.float32)).to(dev)
        e, fl = self.state.ents, self.state.flocks
        e.dest[sl] = d
        e.formation_cell[sl] = d
        e.flock[sl] = fid if ok else -1
        e.movestate[sl] = int(MoveState.MOVING)
        e.has_formation_cell[sl] = bool(cells_on)
        fl.active[fid] = True
        fl.dest[fid] = torch.from_numpy(goal).to(dev)
        fl.layer[fid] = layer
        fl.formation[fid] = 0
        for u in uids:
            payload = {"uid": int(u)}
            self.events.append(("motion_start", payload))
            self.bus.notify(EventType.MOTION_START, payload)
            self.bus.notify(EventType.MOTION_START, payload, uid=int(u))
        return ok

    # -- whole-map field slots and chase fields ---------------------------------------

    def _touch_gslot(self, gslot: int) -> None:
        """Mark a global-field slot recently used (LRU order = dict order)."""
        if gslot in self._gslot_owner:
            self._gslot_owner[gslot] = self._gslot_owner.pop(gslot)

    def _alloc_gslot(self, owner: int) -> int:
        """A global-field slot for `owner`, evicting the least recently
        refreshed owner when the slab is full (counted in
        ``nav.stats["gslot_evictions"]``); an evicted chase field frees its
        (faction, layer) entry, an evicted flock loses its global slot."""
        free = set(range(self.cfg.global_field_slots)) - set(self._gslot_owner)
        if free:
            gslot = min(free)
        else:
            gslot, old = next(iter(self._gslot_owner.items()))
            del self._gslot_owner[gslot]
            self.nav.stats["gslot_evictions"] = (
                self.nav.stats.get("gslot_evictions", 0) + 1)
            if old < 0:
                fac, lay = divmod(-old - 1, self.cfg.num_layers)
                self._chase_gslot.pop((fac, lay), None)
                self._field_sigs.pop(("chase", fac, lay), None)
                self.state.factions.chase_slot[fac, lay] = -1
            else:
                self._field_sigs.pop(old, None)
                self.state.flocks.global_slot[old] = -1
        self._gslot_owner[gslot] = owner
        return gslot

    def _faction_chunk_sigs(self) -> np.ndarray:
        """Per-(faction, chunk) presence signatures (host copy)."""
        e = self.state.ents
        return _chunk_sig_kernel(
            e.pos, e.alive, e.faction, f_n=self.cfg.max_factions,
            cr=self.cfg.chunks_r, cc=self.cfg.chunks_c).cpu().numpy()

    def _enemies_changed(self, key, faction: int, sigs: np.ndarray) -> bool:
        """Did any faction at war with `faction` change its chunk
        signature since `key`'s field was last built?"""
        enemies = [g for g in self._host_factions
                   if self._host_diplomacy[faction, g] == DiplomacyState.WAR]
        if not enemies:
            return False
        prev = self._field_sigs.get(key)
        # (the JAX key also holds a nav version that structure commits
        # bump; structures are not ported, so only diplomacy versions here)
        ver = self._diplo_version
        if (prev is None or prev[0] != ver or any(
                not np.array_equal(prev[1][g], sigs[g]) for g in enemies)):
            self._field_sigs[key] = (ver, sigs.copy())
            return True
        return False

    def _refresh_chase_fields(self, sigs: np.ndarray | None = None,
                              fl_counts: np.ndarray | None = None,
                              specs_out: list | None = None) -> None:
        """Rebuild each warring faction's chase fields: one whole-map
        enemy-seek field per (faction, occupied nav layer), so big and water
        chasers follow fields integrated on their own layer's costs (ref:
        field.c:1209-1678). Rebuilds are driven by the enemies' chunk
        signatures; layers that emptied out free their slot. With
        `specs_out` the specs are collected for one batched build."""
        if sigs is None:
            sigs = self._faction_chunk_sigs()
        if fl_counts is None:
            e = self.state.ents
            fl_counts = _faction_layer_counts(
                e.alive, e.hp, e.faction, e.layer, f_n=self.cfg.max_factions,
                l_n=self.cfg.num_layers).cpu().numpy()
        for (f, lay), slot in list(self._chase_gslot.items()):
            if fl_counts[f, lay] == 0:
                del self._chase_gslot[(f, lay)]
                self._field_sigs.pop(("chase", f, lay), None)
                self._gslot_owner.pop(slot, None)
                self.state.factions.chase_slot[f, lay] = -1
        specs = [] if specs_out is None else specs_out
        for f in sorted(self._host_factions):
            at_war = any(self._host_diplomacy[f, g] == DiplomacyState.WAR
                         for g in self._host_factions if g != f)
            if not at_war:
                continue
            for lay in np.nonzero(fl_counts[f])[0]:
                lay = int(lay)
                slot = self._chase_gslot.get((f, lay))
                fresh = slot is None
                if fresh:
                    slot = self._alloc_gslot(-(f * self.cfg.num_layers + lay + 1))
                    self._chase_gslot[(f, lay)] = slot
                    self.state.factions.chase_slot[f, lay] = slot
                if (not self._enemies_changed(("chase", f, lay), f, sigs)
                        and not fresh):
                    continue
                self._touch_gslot(slot)
                specs.append((f, lay, slot, None))
        if specs_out is None and specs:
            self.state = self.nav.build_enemy_seek_fields_batch(self.state,
                                                                specs)

    # -- stepping -----------------------------------------------------------------

    def step(self, n_frames: int = 1) -> None:
        """Advance n 60 Hz frames: each frame runs the tick, drains events
        every `drain_period` frames and runs the nav cadence; events are
        drained once more at the end of the call."""
        for _ in range(n_frames):
            self._frame += 1
            self.state, self._acc = self._tick_fn(self.state, self._acc)
            if self._frame % self.drain_period == 0:
                self.flush_deltas()
            self._host_systems_tick()
        self.flush_deltas()
        self.bus.service_queue()

    def _timed(self, name: str, t0: float) -> float:
        """Add the host time since t0 to counter `name`; returns now."""
        now = time.perf_counter()
        self.counters[name] += (now - t0) * 1e3
        return now

    def _host_systems_tick(self) -> None:
        """The nav cadence, every ``seek_refresh_period`` frames while a
        faction is at war or a path flock lives (the JAX engine's
        ``_host_systems_tick`` without its seek flocks and host subsystems).

        Each cadence takes a snapshot on the device (chunk signatures, the
        per-(faction, layer) counts at war, and every other period the
        blockers and the flocks' chunk occupancy) and acts on the snapshot
        taken ONE cadence earlier: the JAX engine fetches it asynchronously
        and consumes it a period late, and parity depends on the lag. From
        that snapshot: chase fields whose enemies moved are rebuilt in one
        batch; flock members in chunks off their path get fields (K2); the
        blocker grid is installed, and a flock whose corridor flipped
        replans at most every 4 periods, only when the flip is outside its
        goal chunk and changes whether its route needs a detour."""
        period = self.seek_refresh_period
        if self._frame % period:
            return
        cfg, cnt = self.cfg, self.counters
        t0 = time.perf_counter()
        any_war = bool(np.any(self._host_diplomacy == DiplomacyState.WAR))
        want_blockers = (bool(self.nav.flock_chunks)
                         and self._frame % (2 * period) == 0)
        if not (any_war or want_blockers):
            return
        e = self.state.ents
        snap = (
            _chunk_sig_kernel(e.pos, e.alive, e.faction, f_n=cfg.max_factions,
                              cr=cfg.chunks_r, cc=cfg.chunks_c),
            self.state.nav.blockers.clone() if want_blockers else None,
            _faction_layer_counts(e.alive, e.hp, e.faction, e.layer,
                                  f_n=cfg.max_factions, l_n=cfg.num_layers)
            if any_war else None,
            _flock_chunk_occupancy(e.pos, e.alive, e.flock,
                                   f_n=cfg.max_flocks, cr=cfg.chunks_r,
                                   cc=cfg.chunks_c) if want_blockers else None)
        prev, self._sigs_inflight = self._sigs_inflight, (self._frame, snap)
        t0 = self._timed("blk_snapshot_ms", t0)
        if prev is None:
            return
        _snap_frame, (dsig, dblk, dflc, docc) = prev
        sigs = dsig.cpu().numpy()
        t0 = self._timed("blk_sig_fetch_ms", t0)
        field_specs: list = []
        if any_war:
            self._refresh_chase_fields(
                sigs, dflc.cpu().numpy() if dflc is not None else None,
                specs_out=field_specs)
            t0 = self._timed("chase_refresh_ms", t0)
        if field_specs:
            self.state = self.nav.build_enemy_seek_fields_batch(self.state,
                                                                field_specs)
            t0 = self._timed("field_batch_ms", t0)
        occ = None
        if docc is not None:
            occ = docc.cpu().numpy()
            t0 = self._timed("blk_occ_fetch_ms", t0)
            wants = {}
            for fid in list(self.nav.flock_chunks):
                missing = np.nonzero(occ[fid]
                                     & (self.nav.slot_mirror[fid] < 0))[0]
                if missing.size:
                    wants[fid] = missing
            if wants:
                self.state = self.nav.extend_fields_batch(self.state, wants)
            t0 = self._timed("blk_extend_ms", t0)
        if dblk is None:
            return
        changed = self.nav.update_blockers(dblk.cpu().numpy())
        t0 = self._timed("blk_update_ms", t0)
        if not changed:
            return
        lim = 4 * period
        ok_fids = set()
        for fid in self.nav.flock_chunks:
            if self._frame - self._blocker_replan_frame.get(fid, -lim) < lim:
                continue
            eff = (changed & self.nav.flock_chunks[fid]) - \
                self._goal_chunk_hood(fid)
            if not eff:
                continue
            occ_chunks = (np.nonzero(occ[fid])[0] if occ is not None
                          else list(self.nav.flock_chunks[fid]))
            if (self.nav.blockers_change_route(fid, occ_chunks)
                    != self.nav.flock_plan_detoured.get(fid, False)):
                ok_fids.add(fid)
        t0 = self._timed("blk_route_ms", t0)
        if ok_fids:
            for fid in self._replan_flocks(changed, ok_fids):
                self._blocker_replan_frame[fid] = self._frame
            self._timed("blk_replan_ms", t0)

    def flush_deltas(self) -> None:
        """Fetch the accumulated deltas, emit their events, and start a
        fresh accumulator."""
        acc, self._acc = self._acc, empty_deltas(self.cfg, device=self.device)
        self._drain(acc)

    def _drain(self, d) -> None:
        """Emit one window's events, in the JAX engine's order: arrivals,
        motion starts, projectile hits (target, shooter, cookie), deaths,
        attack starts, expired corpses (whose slots are reclaimed)."""
        h = {k: v.cpu().numpy() for k, v in vars(d).items()}
        uid_arr = self._slot_uid

        def emit(kind, etype, u):
            self.events.append((kind, {"uid": int(u)}))
            self.bus.notify(etype, {"uid": int(u)})
            self.bus.notify(etype, {"uid": int(u)}, uid=int(u))

        for u in uid_arr[h["arrived"]]:
            emit("motion_end", EventType.MOTION_END, u)
        for u in uid_arr[h["motion_start"]]:
            emit("motion_start", EventType.MOTION_START, u)
        for p in np.nonzero(h["proj_hit"] >= 0)[0]:
            shooter = int(h["proj_hit_shooter"][p])
            payload = {
                "uid": int(uid_arr[int(h["proj_hit"][p])]),
                "shooter": int(uid_arr[shooter]) if shooter >= 0 else -1,
                "cookie": float(h["proj_hit_cookie"][p]),
            }
            self.events.append(("projectile_hit", payload))
            self.bus.notify(EventType.PROJECTILE_HIT, payload)
            self.bus.notify(EventType.PROJECTILE_HIT, payload,
                            uid=payload["uid"])
        for u in uid_arr[h["died"]]:
            emit("entity_death", EventType.ENTITY_DEATH, u)
        for u in uid_arr[h["attack_started"]]:
            emit("attack_start", EventType.ATTACK_START, u)
        for u in uid_arr[h["corpse_expired"]]:
            u = int(u)
            slot = self.uid_to_slot.pop(u, None)
            if slot is not None:
                self._free_slots.append(slot)
            self.events.append(("entity_removed", {"uid": u}))
            self.bus.notify(EventType.ENTITY_REMOVED, {"uid": u})
            self.bus.unsubscribe_entity(u)

    # -- entity helpers -------------------------------------------------------------

    def pos_of(self, uid: int) -> np.ndarray:
        return self.state.ents.pos[self.uid_to_slot[uid]].cpu().numpy()

    def movestate_of(self, uid: int) -> MoveState:
        return MoveState(int(self.state.ents.movestate[self.uid_to_slot[uid]]))
