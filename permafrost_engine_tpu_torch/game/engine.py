"""Host engine facade: entity registry, move orders, tick driving.

Port of the move-order path of ``permafrost_engine_tpu/game/engine.py``:
scripts spawn units and order moves; the engine patches the state between
ticks (the command-queue discipline, ref: src/game/movement.c:371-395) and
steps the 60 Hz tick, draining arrival / motion-start events every
``drain_period`` frames.

Ported: ``__init__``, ``set_cost_base``, ``load_map_data``, ``add_faction``,
``spawn_batch``, ``move`` (with stray-chunk field extension and ring-slot
arrival destinations), ``step``, ``flush_deltas``, ``pos_of``,
``movestate_of``. Events go to ``events`` and the ``EventBus``
(``bus``), as in the JAX engine.

Not ported yet, and absent (no method returns quietly in their place): the
60-frame blocker / field-extension / replan cadence of the JAX
``_host_systems_tick``; combat orders and diplomacy (``set_diplomacy``,
``seek_enemies``, ``surround``, chase fields); formations
(``move_in_formation``, unit types); structures; heights; the scheduler's
tasks; the host subsystems (economy, regions, selection, audio,
animation); micro-batched stepping (``step_scan``); profiling.
"""

from __future__ import annotations

import numpy as np
import torch

from permafrost_engine_tpu.core.config import (
    ARRIVAL_THRESHOLD,
    EngineConfig,
    EntityFlags,
    FIELD_RES,
    MoveState,
    NAV_TILE_SIZE,
    NavDomain,
    footprint_for_radius,
    nav_layer,
)
from permafrost_engine_tpu.core.events import EventBus, EventType
from permafrost_engine_tpu.game.arrival import assign_ring_slots
from permafrost_engine_tpu_torch.game.step import make_tick
from permafrost_engine_tpu_torch.nav.service import NavService
from permafrost_engine_tpu_torch.state.schema import (
    GameState,
    empty_deltas,
    init_state,
)


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

    def load_map_data(self, map_data) -> None:
        """Install a parsed PFMAP's compiled nav costs (ref:
        AL_MapFromPFMapStream + N_NewCtxForMapData); heights are not used by
        the ported path."""
        from permafrost_engine_tpu.assets.pfmap import compile_nav_costs

        if (map_data.chunks_r, map_data.chunks_c) != (self.cfg.chunks_r,
                                                      self.cfg.chunks_c):
            raise ValueError(
                f"map is {map_data.chunks_r}x{map_data.chunks_c} chunks; "
                f"engine config is {self.cfg.chunks_r}x{self.cfg.chunks_c}")
        cost, _heights = compile_nav_costs(map_data)
        self.set_cost_base(cost[:self.cfg.num_layers])

    def add_faction(self, fac_id: int, controllable: bool = True) -> None:
        self.state.factions.active[fac_id] = True
        self.state.factions.controllable[fac_id] = controllable

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

    # -- commands -----------------------------------------------------------------

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
            self._free_flocks.append(f)
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

    # -- stepping -----------------------------------------------------------------

    def step(self, n_frames: int = 1) -> None:
        """Advance n 60 Hz frames, draining events every `drain_period`
        frames and once at the end of the call."""
        for _ in range(n_frames):
            self._frame += 1
            self.state, self._acc = self._tick_fn(self.state, self._acc)
            if self._frame % self.drain_period == 0:
                self.flush_deltas()
        self.flush_deltas()
        self.bus.service_queue()

    def flush_deltas(self) -> None:
        """Fetch the accumulated deltas, emit their events, and start a
        fresh accumulator."""
        acc, self._acc = self._acc, empty_deltas(self.cfg, device=self.device)
        self._drain(acc)

    def _drain(self, d) -> None:
        arrived = d.arrived.cpu().numpy()
        started = d.motion_start.cpu().numpy()

        def emit(kind, etype, u):
            self.events.append((kind, {"uid": int(u)}))
            self.bus.notify(etype, {"uid": int(u)})
            self.bus.notify(etype, {"uid": int(u)}, uid=int(u))

        for u in self._slot_uid[arrived]:
            emit("motion_end", EventType.MOTION_END, u)
        for u in self._slot_uid[started]:
            emit("motion_start", EventType.MOTION_START, u)

    # -- entity helpers -------------------------------------------------------------

    def pos_of(self, uid: int) -> np.ndarray:
        return self.state.ents.pos[self.uid_to_slot[uid]].cpu().numpy()

    def movestate_of(self, uid: int) -> MoveState:
        return MoveState(int(self.state.ents.movestate[self.uid_to_slot[uid]]))
