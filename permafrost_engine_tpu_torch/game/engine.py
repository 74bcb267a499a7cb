"""Host engine facade: entity registry, orders, diplomacy, tick driving.

Port of ``permafrost_engine_tpu/game/engine.py``: scripts spawn units,
order moves and set diplomacy; the engine patches the state between ticks
(the command-queue discipline, ref: src/game/movement.c:371-395), steps the
60 Hz tick (movement, combat, projectiles, corpses, fog), drains its events
every ``drain_period`` frames, and runs the nav cadence every
``seek_refresh_period`` frames.

Ported: ``__init__``, ``set_cost_base``, ``load_map_data`` (heights and the
fog's ``tile_height``), ``add_faction``, ``set_diplomacy``, ``set_stance``,
``spawn_batch`` (with the ``unit_type`` registry), ``despawn``, ``move``
(with stray-chunk field extension and ring-slot arrival destinations),
``move_in_formation`` (per-(layer, unit type) subformation blocks, cells
assigned by the auction, cell-seeded arrival fields), ``seek_enemies``,
``surround``, ``refresh_seek_fields``, ``set_structure_blocking`` (stamps
committed by ``_commit_nav`` before each frame and order), ``stop``,
``set_skin_bank``, ``step`` (micro-batched: see below), ``step_scan``,
``flush_deltas``, ``pos_of``, ``movestate_of``, and the nav cadence of
``_host_systems_tick``: seek-flock and per-(faction, layer) chase fields in
one batch, stray-chunk extensions, blocker snapshots and rate-limited,
detour-checked blocker replans, each fed by the snapshot taken one cadence
earlier, as in the JAX engine. Events go to ``events`` and the
``EventBus`` (``bus``), as in the JAX engine; the cadence's host times go
to ``counters``.

Events reach the host one drain window late, as in the JAX engine: at each
``drain_period`` boundary the window that closes is copied to host buffers
(asynchronously on the card) and the window copied one boundary earlier is
drained; ``flush_deltas`` (the end of every ``step``) drains both. Queued
bus events are serviced at the end of every host-systems tick (every
segment) and of every ``step``/``step_scan`` call, as in the JAX engine.

The host layer, as in the JAX engine: the scheduler (``sched``: live tasks
force frame-by-frame stepping, and ``step_scan`` to ``step``), the pause
state (``sim_state``: paused, ``step`` advances the frame and runs the host
systems but no tick, ``step_scan`` returns at once), the economy with its
garrisons and transports (``economy``), ``regions``, ``selection``,
``audio`` and the animation system (``anim``), run at ``economy_period``
from ``_host_systems_tick``; ``settings``, ``perf`` (scopes, counters,
``profile_tick``, ``tick_cost_analysis``), ``set_flags``, ``teleport``,
and session save/load (``core/session.py``).

Micro-batching (``micro_batching``, on by default as in JAX): ``step`` runs
the frames up to the next host-cadence boundary as one segment, and
``step_scan`` whole windows. On the card a segment is one CUDA graph
replay (``game/graphs.py``), on the CPU its ticks run in turn; both are
bit-identical to per-frame stepping. ``micro_batching = False`` steps
frame by frame.

The parts of the engine the ``pf`` script layer calls (``script/pf.py``):
``Engine(cfg=None)`` takes ``EngineConfig()``; ``height_at`` (the terrain
height under a point), ``render_alpha`` (the render lerp fraction within a
movement tick) and ``prewarm_nav`` (on the card it builds both CUDA
libraries, so the first field build of a battle pays no ``nvcc``; on the
CPU, where no kernel is built, it does nothing), as in the JAX engine.

Not ported yet, and absent (no method returns quietly in their place):
rendering and ``parallel/``.
"""

from __future__ import annotations

import copy
import math
import time
from collections import deque

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
    FRAME_HZ,
    NavDomain,
    SimState,
    footprint_for_radius,
    nav_layer,
)
from permafrost_engine_tpu_torch.core.audio import AudioSystem
from permafrost_engine_tpu_torch.core.events import EventBus, EventType
from permafrost_engine_tpu_torch.core.perf import H100_F32_OPS_S, OpCounter, Perf
from permafrost_engine_tpu_torch.core.sched import Scheduler
from permafrost_engine_tpu_torch.core.settings import Settings
from permafrost_engine_tpu_torch.game import graphs
from permafrost_engine_tpu_torch.game.arrival import assign_ring_slots
from permafrost_engine_tpu_torch.game.economy import Economy
from permafrost_engine_tpu_torch.game.formation import (
    FormationType,
    assign_cells,
    block_depth,
    layout_cells,
)
from permafrost_engine_tpu_torch.game.region import RegionSystem
from permafrost_engine_tpu_torch.game.selection import SelectionSystem
from permafrost_engine_tpu_torch.game.step import make_tick_scan
from permafrost_engine_tpu_torch.nav.service import NavService
from permafrost_engine_tpu_torch.ops.skin import make_procedural_bank
from permafrost_engine_tpu_torch.render.anim_system import AnimSystem
from permafrost_engine_tpu_torch.state.schema import (
    GameState,
    empty_deltas,
    init_state,
    reset_deltas,
    state_mem_accounting,
)


# host-time counters (ms) in perf.counters: the nav cadence's, as the JAX
# engine's, then the port's timers of the scheduler, economy and region ticks
_COUNTERS = ("blk_snapshot_ms", "blk_sig_fetch_ms", "seek_refresh_ms",
             "chase_refresh_ms", "field_batch_ms", "blk_occ_fetch_ms",
             "blk_extend_ms", "blk_update_ms", "blk_route_ms", "blk_replan_ms",
             "sched_tick_ms", "economy_tick_ms", "region_update_ms")


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
    """The port's engine on one device, the card unless the caller asks for
    ``"cpu"``; see the module docstring for what is and is not ported."""

    def __init__(self, cfg: EngineConfig | None = None, *, device="cuda",
                 seed: int = 0, cost_base: np.ndarray | None = None):
        cfg = cfg or EngineConfig()
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
        # device skinning (cfg.skin_joints > 0) starts on the procedural
        # rig; set_skin_bank() swaps in another
        self._skin_bank = (make_procedural_bank(cfg.skin_joints,
                                                device=self.device)
                           if cfg.skin_joints > 0 else None)
        self.map_data = None
        self._build_steppers()
        self.micro_batching = True
        self._next_uid = 1
        self._free_slots = list(range(cfg.max_ents - 1, -1, -1))
        self.uid_to_slot: dict[int, int] = {}
        # uid -> (formation_priority, unit type): subformation grouping
        # (ref: Entity_TypeID + S_FormationPriority, py_script.c:4746-4784)
        self.unit_type: dict[int, tuple[int, int]] = {}
        self._slot_uid = np.zeros(cfg.max_ents, np.int64)
        self._free_flocks = list(range(cfg.max_flocks - 1, -1, -1))
        self.events: list[tuple[str, dict]] = []
        self.bus = EventBus()
        # pf.debug.trace_python / log_python: record script handler
        # dispatches into bus.trace_log while either setting is on
        self.bus.trace_pred = (lambda: self._debug_flag("trace_python")
                               or self._debug_flag("log_python"))
        # pf.debug.log_call_graphs / log_mem_stats ring buffers
        self.call_graph_log: deque = deque(maxlen=16)
        self.mem_stats_log: deque = deque(maxlen=8)
        self.sched = Scheduler(self.bus)
        self.perf = Perf()
        self.settings = Settings()
        self.economy = Economy(self)
        self.regions = RegionSystem(self.bus)
        self.selection = SelectionSystem(self.bus)
        self.audio = AudioSystem()
        self.anim = AnimSystem(self)
        self.sim_state = SimState.RUNNING
        self._frame = 0
        self.drain_period = 6
        self.economy_period = 12   # frames between economy ticks (5 Hz)
        self._acc = empty_deltas(cfg, device=self.device)
        # the window copied at the last drain boundary, not yet drained,
        # and the two host buffers windows are copied into in turn
        self._inflight = None
        pin = self.device.type == "cuda"
        self._host_windows = [
            {k: v.pin_memory() if pin else v
             for k, v in vars(empty_deltas(cfg, device="cpu")).items()}
            for _ in range(2)]
        self._window_flip = 0
        self.perf.counters.update(dict.fromkeys(_COUNTERS, 0.0))
        self.counters = self.perf.counters
        # the nav cadence (see _host_systems_tick)
        self.seek_refresh_period = 30
        self._sigs_inflight = None      # (frame, snapshot) of the last cadence
        self._field_sigs: dict = {}     # field key -> (versions, sigs) built
        self._blocker_replan_frame: dict[int, int] = {}
        self._nav_version = 0           # structure commits rebuild fields
        self._diplo_version = 0         # a new war rebuilds even if nobody moved
        # seek flocks: fid -> (faction, layer, global slot), and the frame
        # each was registered (a lagged snapshot must not read it as dead)
        self._seek_flocks: dict[int, tuple[int, int, int]] = {}
        self._seek_created: dict[int, int] = {}
        # structure uid -> stamped inclusive nav-tile rect (r0, r1, c0, c1)
        self._structures: dict[int, tuple[int, int, int, int]] = {}
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

    # -- dynamic structures (ref: N_CutoutStaticObject nav.c:3326,
    #    N_Update nav.c:2119-2206) ------------------------------------------------

    def set_structure_blocking(self, uid: int, blocking: bool = True) -> None:
        """Cut a building's footprint into (or out of) the static nav cost.
        Stamps are host-only and accumulate; the world update (cost push,
        portal-graph and island update, field invalidation, replans of the
        flocks whose path crosses a dirty chunk) commits at the next frame
        or order (``_commit_nav``)."""
        cur = self._structures.get(uid)
        if blocking and cur is None:
            slot = self.uid_to_slot[uid]
            pos = self.state.ents.pos[slot].cpu().numpy()
            rad = float(self.state.ents.radius[slot])
            rect = (int((pos[1] - rad) // NAV_TILE_SIZE),
                    int((pos[1] + rad) // NAV_TILE_SIZE),
                    int((pos[0] - rad) // NAV_TILE_SIZE),
                    int((pos[0] + rad) // NAV_TILE_SIZE))
            self._structures[uid] = rect
            self.nav.stamp_structure(rect, +1)
        elif not blocking and cur is not None:
            del self._structures[uid]
            self.nav.stamp_structure(cur, -1)

    def _commit_nav(self) -> None:
        """Apply pending structure stamps and replan the flocks whose path
        crosses a dirty chunk; with nothing pending, a host-only no-op."""
        state, dirty = self.nav.commit_structures(self.state)
        if dirty is not None:
            self.state = state
            self._nav_version += 1        # cost edits invalidate seek fields
            self._replan_flocks(dirty)

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
        self.map_data = map_data
        self.heights = heights
        self.set_cost_base(cost[:self.cfg.num_layers])
        if np.ptp(heights) > 0.5:
            self._tile_height = torch.from_numpy(np.ascontiguousarray(
                heights[::2, ::2], np.float32)).to(self.device)
        else:
            self._tile_height = None
        self._build_steppers()

    def height_at(self, xz) -> float:
        """Terrain height (world units) of the nav tile under (x, z)."""
        r = int(np.clip(xz[1] // NAV_TILE_SIZE, 0, self.cfg.field_h - 1))
        c = int(np.clip(xz[0] // NAV_TILE_SIZE, 0, self.cfg.field_w - 1))
        return float(self.heights[r, c])

    def set_skin_bank(self, bank) -> None:
        """Swap the device-skinning rig (an ``ops/skin.SkinBank``, e.g. from
        ``state.convert.bank_from_numpy``) and rebuild the steppers around
        it. Requires ``cfg.skin_joints`` matching the rig."""
        if self.cfg.skin_joints <= 0:
            raise ValueError("cfg.skin_joints is 0: device skinning is off")
        j = len(bank.parents)
        if j != self.cfg.skin_joints:
            raise ValueError(
                f"bank has {j} joints; cfg.skin_joints={self.cfg.skin_joints}")
        self._skin_bank = bank
        self._build_steppers()

    def _build_steppers(self) -> None:
        """The tick and the segment stepper around the current fog heights
        and skin bank; dropping the old stepper drops its CUDA graphs."""
        self._scan_fn = make_tick_scan(self.cfg, self._tile_height,
                                       skin_bank=self._skin_bank)
        self._tick_fn = self._scan_fn.tick

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
                    attack_period=10, is_ranged=False, stance=0, unit_type=0,
                    formation_priority=0) -> list[int]:
        """Spawn M entities in one batch of indexed writes; returns UIDs.
        ``unit_type`` and ``formation_priority`` (scalars or per entity)
        group ``move_in_formation``'s subformations."""
        m = pos.shape[0]
        if len(self._free_slots) < m:
            raise RuntimeError("entity arena full")
        slots = np.array([self._free_slots.pop() for _ in range(m)], np.int64)
        uids = np.arange(self._next_uid, self._next_uid + m, dtype=np.int64)
        self._next_uid += m
        for u, s in zip(uids, slots):
            self.uid_to_slot[int(u)] = int(s)
        self._slot_uid[slots] = uids
        types = np.broadcast_to(np.asarray(unit_type), (m,))
        prios = np.broadcast_to(np.asarray(formation_priority), (m,))
        for u, t, p in zip(uids, types, prios):
            self.unit_type[int(u)] = (int(p), int(t))

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
        if uid in self._structures:
            self.set_structure_blocking(uid, False)
        self.unit_type.pop(uid, None)
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
        self._commit_nav()   # orders see pending structure stamps
        if self.nav._blocker_snap is None or not self.nav.flock_chunks:
            self.nav.update_blockers(self.state.nav.blockers.cpu().numpy())
        slots = np.array([self.uid_to_slot[u] for u in uids], np.int64)
        layers = self.state.ents.layer.cpu().numpy()[slots]
        all_pos = self.state.ents.pos.cpu().numpy()

        groups, reqs = [], []
        for layer in np.unique(layers):
            group = slots[layers == layer]
            guids = [u for u, l in zip(uids, layers) if l == layer]
            fid = self._new_flock()
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

    def move_in_formation(self, uids: list[int], goal_xz,
                          ftype: FormationType | None = None) -> bool:
        """Move order with formation cells (ref: G_Formation_Arrange,
        formation.c:354, 450-980): the move is issued first (one flock per
        nav layer), then one subformation block per (layer, unit type),
        sorted by (formation_priority, type) and stacked back from the
        flock's effective goal, is laid out against terrain, occupancy
        (blockers minus the ordered units' own tiles) and the goal's island;
        the auction assigns units to cells. Later blocks see earlier blocks'
        cells as occupied. Each layer's chunks then get cell-seeded fields.
        Returns whether any block got cells."""
        if ftype is None:
            ftype = FormationType.RANK
        if not uids:
            return False
        self._commit_nav()
        cfg, dev = self.cfg, self.device
        slots = np.array([self.uid_to_slot[u] for u in uids], np.int64)
        all_pos = self.state.ents.pos.cpu().numpy()
        all_rad = self.state.ents.radius.cpu().numpy()
        layers = self.state.ents.layer.cpu().numpy()[slots]
        goal = np.asarray(goal_xz, np.float32)
        direction = goal - all_pos[slots].mean(axis=0)
        if np.linalg.norm(direction) < 1e-3:
            direction = np.array([1.0, 0.0], np.float32)
        d_unit = direction / np.linalg.norm(direction)

        if not self.move(uids, tuple(goal)):
            return False
        # each layer forms at its flock's effective destination (a
        # cross-island goal retargets to the reachable side)
        flock_of = self.state.ents.flock.cpu().numpy()
        flock_dest = self.state.flocks.dest.cpu().numpy()
        own_r = np.clip((all_pos[slots, 1] / NAV_TILE_SIZE).astype(int), 0,
                        cfg.field_h - 1)
        own_c = np.clip((all_pos[slots, 0] / NAV_TILE_SIZE).astype(int), 0,
                        cfg.field_w - 1)
        blockers_all = self.state.nav.blockers.cpu().numpy()
        depth_off = 0.0
        any_cells = False
        slot_uid = {s: u for u, s in zip(uids, slots.tolist())}
        for layer in sorted(set(int(x) for x in layers)):
            lgroup = slots[layers == layer]
            fid = int(flock_of[lgroup[0]])
            eff_goal = flock_dest[fid].astype(np.float32) if fid >= 0 else goal
            occupancy = blockers_all[layer].copy()
            occupancy[own_r, own_c] = 0
            isl_map = self.nav.islands(layer)
            gr = int(np.clip(eff_goal[1] // NAV_TILE_SIZE, 0, cfg.field_h - 1))
            gc = int(np.clip(eff_goal[0] // NAV_TILE_SIZE, 0, cfg.field_w - 1))
            island = int(isl_map[gr, gc])
            tkey = {int(s): self.unit_type.get(slot_uid.get(int(s)), (0, 0))
                    for s in lgroup}
            fid_cells: list[np.ndarray] = []
            for tk in sorted(set(tkey.values())):
                group = np.asarray([s for s in lgroup if tkey[int(s)] == tk],
                                   np.int64)
                spacing = max(float(all_rad[group].max()) * 3.0,
                              ARRIVAL_THRESHOLD + 1.0)
                cells = layout_cells(
                    len(group), eff_goal - d_unit * depth_off, direction,
                    ftype, spacing=spacing, cost_layer=self.nav.cost_base[layer],
                    occupancy=occupancy, islands=isl_map,
                    island=island if island >= 0 else None)
                if len(cells) == 0:
                    continue   # this block keeps its ring-slot dests
                any_cells = True
                assign = assign_cells(all_pos[group], cells, device=dev)
                my_cells = cells[np.clip(assign, 0, len(cells) - 1)]
                sl = torch.from_numpy(group).to(dev)
                cj = torch.from_numpy(my_cells).to(dev)
                e = self.state.ents
                e.dest[sl] = cj
                e.formation_cell[sl] = cj
                e.has_formation_cell[sl] = True
                # gates the formation keep and drag forces in the tick
                self.state.flocks.formation[fid] = int(ftype)
                # later blocks must not lay cells on top of this one
                cr = np.clip((my_cells[:, 1] / NAV_TILE_SIZE).astype(int), 0,
                             cfg.field_h - 1)
                cc = np.clip((my_cells[:, 0] / NAV_TILE_SIZE).astype(int), 0,
                             cfg.field_w - 1)
                occupancy[cr, cc] = 1
                fid_cells.append(my_cells)
                depth_off += block_depth(cells, direction) + 2.0 * spacing
            if fid_cells:
                self.state = self.nav.install_formation_field(
                    self.state, fid, layer, np.concatenate(fid_cells))
        return any_cells

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
            self._seek_flocks.pop(f, None)
            self._seek_created.pop(f, None)
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
        d = torch.from_numpy(np.array(dests, np.float32)).to(dev)
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
            self.sched.post_event(EventType.MOTION_START, payload)
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
                self._seek_flocks.pop(old, None)
                self._field_sigs.pop(old, None)
                self.state.flocks.global_slot[old] = -1
        self._gslot_owner[gslot] = owner
        return gslot

    def _new_flock(self) -> int:
        """A free flock id; flocks no living entity references are
        reclaimed when the table is full."""
        if not self._free_flocks:
            self._reclaim_flocks()
        if not self._free_flocks:
            raise RuntimeError("flock table full")
        return self._free_flocks.pop()

    # -- seek and surround orders ---------------------------------------------------

    def seek_enemies(self, uids: list[int]) -> bool:
        """Order units to hunt the nearest enemies through whole-map
        enemy-seek fields (ref: G_Move_SetSeekEnemies, TARGET_ENEMIES): one
        flock per nav layer, each with a field on its layer's costs,
        rebuilt by the cadence while the flock lives."""
        if not uids:
            return False
        slots = np.array([self.uid_to_slot[u] for u in uids], np.int64)
        layers = self.state.ents.layer.cpu().numpy()[slots]
        ok = False
        for layer in np.unique(layers):
            ok |= self._seek_enemies_layer(slots[layers == layer], int(layer))
        return ok

    def _seek_enemies_layer(self, slots: np.ndarray, layer: int) -> bool:
        self._commit_nav()
        fid = self._new_flock()
        faction = int(self.state.ents.faction[int(slots[0])])
        gslot = self._alloc_gslot(fid)
        self.state = self.nav.build_enemy_seek_field(
            self.state, faction, layer, gslot, flock_id=fid)
        self._seek_flocks[fid] = (faction, layer, gslot)
        self._seek_created[fid] = self._frame
        self._start_field_flock(slots, fid, layer, MoveState.SEEK_ENEMIES,
                                # never "arrives": combat stops them
                                torch.tensor([self.cfg.world_w * 2.0,
                                              self.cfg.world_h * 2.0],
                                             device=self.device))
        return True

    def surround(self, uids: list[int], target_uid: int) -> bool:
        """Converge on one entity through whole-map surround fields (ref:
        G_Move_SetSurroundEntity, TARGET_ENTITY): one flock per nav layer,
        each with a field on its layer's costs."""
        if not uids or target_uid not in self.uid_to_slot:
            return False
        slots = np.array([self.uid_to_slot[u] for u in uids], np.int64)
        layers = self.state.ents.layer.cpu().numpy()[slots]
        ok = False
        for layer in np.unique(layers):
            ok |= self._surround_layer(slots[layers == layer], target_uid,
                                       int(layer))
        return ok

    def _surround_layer(self, slots: np.ndarray, target_uid: int,
                        layer: int) -> bool:
        self._commit_nav()
        fid = self._new_flock()
        gslot = self._alloc_gslot(fid)
        tslot = self.uid_to_slot[target_uid]
        self.state = self.nav.build_surround_field(self.state, fid, tslot,
                                                   layer, gslot)
        self.state.flocks.target_ent[fid] = tslot
        self._start_field_flock(slots, fid, layer, MoveState.SURROUND_ENTITY,
                                self.state.ents.pos[tslot])
        return True

    def _start_field_flock(self, slots: np.ndarray, fid: int, layer: int,
                           movestate: MoveState, dest: torch.Tensor) -> None:
        """The entity and flock-table writes of a seek or surround order."""
        sl = torch.from_numpy(slots).to(self.device)
        e, fl = self.state.ents, self.state.flocks
        e.flock[sl] = fid
        e.movestate[sl] = int(movestate)
        e.dest[sl] = dest.clone()
        e.has_formation_cell[sl] = False
        fl.active[fid] = True
        fl.layer[fid] = layer
        fl.formation[fid] = 0

    def refresh_seek_fields(self, sigs: np.ndarray | None = None,
                            active: np.ndarray | None = None,
                            snap_frame: int | None = None,
                            specs_out: list | None = None) -> None:
        """Rebuild the live seek flocks' fields whose enemy factions changed
        their chunk signature since the last build (ref: nav.c per-faction
        blocker counts + N_FC enemy-seek invalidation). `active` and
        `snap_frame` may come from the cadence's lagged snapshot: a flock
        registered after it is not treated as dead. With `specs_out` the
        specs are collected for one batched build."""
        if active is None:
            active = self.state.flocks.active.cpu().numpy()
        if snap_frame is None:
            snap_frame = self._frame
        if sigs is None:
            sigs = self._faction_chunk_sigs()
        specs = [] if specs_out is None else specs_out
        for fid, (faction, layer, gslot) in list(self._seek_flocks.items()):
            if (not active[fid]
                    and self._seek_created.get(fid, -1) < snap_frame):
                del self._seek_flocks[fid]
                self._field_sigs.pop(fid, None)
                continue
            if not self._enemies_changed(fid, faction, sigs):
                continue
            self._touch_gslot(gslot)
            specs.append((faction, layer, gslot, fid))
        if specs_out is None and specs:
            self.state = self.nav.build_enemy_seek_fields_batch(self.state,
                                                                specs)

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
        ver = (self._nav_version, self._diplo_version)
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

    def _micro_step_fn(self, k: int):
        """k-frame stepper threading the same (state, acc) pair as k single
        ticks: one segment of the scan stepper (a CUDA graph replay on the
        card). The tick folds its own events into the accumulator, so k
        fused frames are bit-identical to k per-frame ticks."""
        return lambda state, acc: self._scan_fn(state, k, acc)

    def _fusible_frames(self) -> int:
        """Frames until the next host-cadence boundary: the largest segment
        that is provably identical to per-frame stepping. Every host effect
        of step() fires only when `_frame % period == 0` for one of these
        periods (drains, the economy period, the nav cadence), so no frame
        inside a segment can observe or produce host work."""
        f = self._frame
        k = self.drain_period - f % self.drain_period
        for p in (self.economy_period, self.seek_refresh_period):
            k = min(k, p - f % p)
        return max(k, 1)

    def _debug_flag(self, name: str) -> bool:
        """A pf.debug.* bool, False when unregistered (an engine driven
        without the script layer)."""
        try:
            return bool(self.settings.get(f"pf.debug.{name}"))
        except Exception:
            return False

    def _sync(self) -> None:
        """Wait for the device (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, n_frames: int = 1) -> None:
        """Advance n 60 Hz frames; collect host events from the deltas and
        run the host systems (tasks, economy, regions, the nav cadence) at
        their rates — the analogue of the reference's frame loop (ref:
        src/main.c:816). Each segment commits pending structure stamps,
        runs its ticks, rotates the drain window at a `drain_period`
        boundary and runs the host-systems tick, which ends by servicing
        the event queue; events are drained once more at the end of the
        call, and the queue serviced.

        With ``micro_batching`` the frames up to the next host-cadence
        boundary (``_fusible_frames``) form one segment, a CUDA graph
        replay on the card; only full cadence segments fuse, and a
        remainder that `n_frames` cuts short runs frame by frame. Live
        tasks or a pause force frame-by-frame stepping (the reference's
        frame-granular semantics, main.c:86-98), re-read every segment so a
        task that pauses mid-call takes effect at the next frame. While
        paused the frame and the nav commit advance and the host systems
        run, but no tick."""
        left = n_frames
        while left > 0:
            paused = self.sim_state == SimState.PAUSED_FULL
            k = 1
            if self.micro_batching and not paused and not self.sched.tasks:
                fusible = self._fusible_frames()
                if left >= fusible:
                    k = fusible
            self.perf.begin_tick()
            self._frame += k
            self._commit_nav()
            if not paused:
                with self.perf.scope("device_tick"):
                    if k == 1:
                        self.state, self._acc = self._tick_fn(self.state,
                                                              self._acc)
                    else:
                        self.state, self._acc = self._micro_step_fn(k)(
                            self.state, self._acc)
                if self._debug_flag("trace_gpu"):
                    # the reference's GPU timestamp queries made explicit
                    # (perf.h:155-163): time this segment's device
                    # completion synchronously — a measurement cost
                    t0 = time.perf_counter()
                    self._sync()
                    self.perf.counters["trace_gpu_device_ms"] += (
                        time.perf_counter() - t0) * 1e3
                with self.perf.scope("drain_deltas"):
                    t0 = time.perf_counter()
                    if self._frame % self.drain_period == 0:
                        self._rotate_window()
                if self._debug_flag("trace_gpu_stalls"):
                    # a drain wait longer than the segment's frame budget
                    # means the host out-ran the device (ref: GPU stall
                    # tracing, R_GL_PerfStallFrameReport render.c:640)
                    dms = (time.perf_counter() - t0) * 1e3
                    if dms > k * (1000.0 / FRAME_HZ):
                        self.perf.counters["gpu_stall_events"] += 1
                        self.perf.counters["gpu_stall_ms"] += dms
            with self.perf.scope("host_systems"):
                self._host_systems_tick()
            if self._debug_flag("log_call_graphs"):
                frame = (self.perf._frames[-1] if self.perf._frames
                         else self.perf._current)
                self.call_graph_log.append(
                    [(e.name, round(e.ms, 3), e.parent) for e in frame])
            left -= k
        self.flush_deltas()
        self.bus.service_queue(self.sim_state)

    def _live_periods(self) -> list[int]:
        """The host periods ``step_scan`` must keep: the economy period
        while harvesters, builders, resources, regions or animation states
        live, the nav cadence while a seek flock lives or a faction is at
        war, and every frame while a task lives."""
        eco = self.economy
        periods = []
        if (eco.harvesters or eco.builders or eco.resources
                or self.regions.regions or self.anim.states):
            periods.append(self.economy_period)
        if self._seek_flocks or np.any(self._host_diplomacy
                                       == DiplomacyState.WAR):
            periods.append(self.seek_refresh_period)
        if self.sched.tasks:
            periods.append(1)
        return periods

    def step_scan(self, n_frames: int) -> None:
        """Advance n frames in batched segments; events are merged per
        window. Returns at once while paused. With no live host system the
        window is ONE segment (one CUDA graph replay on the card). With
        live host systems (``_live_periods``) the window splits into
        segments of the periods' gcd, each drained one segment late, so
        every host system still runs at its exact frames; frames before
        the first boundary and after the last go through ``step``, and a
        gcd of 1 (a live task) steps the whole window."""
        if self.sim_state == SimState.PAUSED_FULL:
            return
        self._commit_nav()
        self.flush_deltas()   # per-frame deltas must not arrive out of order
        periods = self._live_periods()

        if not periods:
            self.state, self._acc = self._scan_fn(self.state, n_frames,
                                                  self._acc)
            self.flush_deltas()
            self._frame += n_frames
            self.bus.service_queue(self.sim_state)
            return

        seg = math.gcd(*periods)
        if seg == 1:
            self.step(n_frames)
            return
        # align to a segment boundary with per-frame steps, then scan in
        # fixed-size segments, draining one segment late
        align = (-self._frame) % seg
        if align and align <= n_frames:
            self.step(align)
            n_frames -= align
        while n_frames >= seg:
            self._commit_nav()
            self.state, self._acc = self._scan_fn(self.state, seg, self._acc)
            self._rotate_window()
            self._frame += seg
            n_frames -= seg
            self._host_systems_tick()
        self.flush_deltas()
        if n_frames:
            self.step(n_frames)
        self.bus.service_queue(self.sim_state)

    def _timed(self, name: str, t0: float) -> float:
        """Add the host time since t0 to counter `name`; returns now."""
        now = time.perf_counter()
        self.counters[name] += (now - t0) * 1e3
        return now

    def ents_host(self, *names: str) -> dict[str, np.ndarray]:
        """Host copies of entity columns (``state.ents`` field names), taken
        together: on the card the copies are queued and the device synced
        once. On the CPU they are copies too (not views), so orders issued
        while a caller holds them do not show through, as on the card."""
        return self.host_copies(self.state.ents, *names)

    def host_copies(self, table, *names: str) -> dict[str, np.ndarray]:
        """``ents_host`` for any table of the state (``state.factions``,
        ...): host copies of its fields `names`, one sync on the card."""
        if self.device.type != "cuda":
            return {n: getattr(table, n).numpy().copy() for n in names}
        out = {n: getattr(table, n).to("cpu", non_blocking=True)
               for n in names}
        torch.cuda.current_stream(self.device).synchronize()
        return {n: t.numpy() for n, t in out.items()}

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _host_systems_tick(self, force: bool = False) -> None:
        """The host systems after a segment, in the JAX engine's order: the
        scheduler's tick while tasks live; at the economy period (or with
        `force`) the animation clocks, the audio clock and the
        ``log_mem_stats`` sample; the nav cadence (``_nav_cadence``); the
        economy tick and the region update at the economy period while the
        economy or a region is live; then the event queue is serviced."""
        if self.sched.tasks:
            t0 = time.perf_counter()
            self.sched.tick()
            self._timed("sched_tick_ms", t0)
        eco = self.economy
        eco_live = (eco.harvesters or eco.builders or eco.resources
                    or self.regions.regions)
        eco_frame = force or self._frame % self.economy_period == 0
        if eco_frame:
            if self.anim.states:
                self.anim.tick(self.economy_period / FRAME_HZ)
            self.audio.tick(self.economy_period)
            if self._debug_flag("log_mem_stats"):
                self.mem_stats_log.append(
                    (self._frame, state_mem_accounting(self.state)))
        if self._frame % self.seek_refresh_period == 0:
            self._nav_cadence()
        if eco_live and eco_frame:
            t0 = time.perf_counter()
            self.economy.tick()
            t0 = self._timed("economy_tick_ms", t0)
            if self.regions.regions:
                h = self.ents_host("uid", "pos", "alive")
                self.regions.update(h["uid"], h["pos"], h["alive"])
                self._timed("region_update_ms", t0)
        self.bus.service_queue(self.sim_state)

    def _nav_cadence(self) -> None:
        """The nav cadence, every ``seek_refresh_period`` frames while a
        seek flock lives, a faction is at war or a path flock lives.

        Each cadence takes a snapshot on the device (chunk signatures, the
        flocks' active flags, the per-(faction, layer) counts at war, and
        every other period the blockers and the flocks' chunk occupancy)
        and acts on the snapshot taken ONE cadence earlier: the JAX engine
        fetches it asynchronously and consumes it a period late, and parity
        depends on the lag. From that snapshot: seek-flock fields and chase
        fields whose enemies moved are rebuilt in one batch (seek specs
        first); flock members in chunks off their path get fields (K2); the
        blocker grid is installed, and a flock whose corridor flipped
        replans at most every 4 periods, only when the flip is outside its
        goal chunk and changes whether its route needs a detour."""
        period = self.seek_refresh_period
        cfg = self.cfg
        t0 = time.perf_counter()
        any_war = bool(np.any(self._host_diplomacy == DiplomacyState.WAR))
        want_blockers = (bool(self.nav.flock_chunks)
                         and self._frame % (2 * period) == 0)
        if not (self._seek_flocks or any_war or want_blockers):
            return
        e = self.state.ents
        snap = (
            _chunk_sig_kernel(e.pos, e.alive, e.faction, f_n=cfg.max_factions,
                              cr=cfg.chunks_r, cc=cfg.chunks_c),
            self.state.flocks.active.clone(),
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
        snap_frame, (dsig, dact, dblk, dflc, docc) = prev
        sigs = dsig.cpu().numpy()
        t0 = self._timed("blk_sig_fetch_ms", t0)
        field_specs: list = []
        if self._seek_flocks:
            self.refresh_seek_fields(sigs, dact.cpu().numpy(), snap_frame,
                                     specs_out=field_specs)
            t0 = self._timed("seek_refresh_ms", t0)
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

    def _copy_window(self):
        """Start copying the accumulated window into the next host buffer
        (asynchronously on the card; a plain copy on the CPU), then empty
        the accumulator in place, after the copy in stream order. Returns
        the window as (host buffers, CUDA event or None)."""
        bufs = self._host_windows[self._window_flip]
        self._window_flip ^= 1
        for name, buf in bufs.items():
            buf.copy_(getattr(self._acc, name), non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        reset_deltas(self._acc)
        return bufs, event

    def _rotate_window(self) -> None:
        """At a drain boundary: start the copy of the window that closes
        here, then drain the one copied a boundary earlier (the JAX
        engine's one-window lag)."""
        ready, self._inflight = self._inflight, self._copy_window()
        if ready is not None:
            self._drain_window(ready)

    def _drain_window(self, window) -> None:
        bufs, event = window
        if event is not None:
            event.synchronize()
        self._drain({k: v.numpy() for k, v in bufs.items()})

    def flush_deltas(self) -> None:
        """Synchronously drain the in-flight window, then the current one,
        and empty the accumulator (the end of a step() call, tests)."""
        if self._inflight is not None:
            ready, self._inflight = self._inflight, None
            self._drain_window(ready)
        self._drain({k: v.cpu().numpy() for k, v in vars(self._acc).items()})
        reset_deltas(self._acc)

    def _drain(self, h: dict) -> None:
        """Emit one window's events (host arrays by ``TickDeltas`` field),
        in the JAX engine's order: arrivals, motion starts, projectile hits
        (target, shooter, cookie), deaths, attack starts, expired corpses
        (whose slots are reclaimed)."""
        uid_arr = self._slot_uid

        def emit(kind, etype, u):
            self.events.append((kind, {"uid": int(u)}))
            self.bus.notify(etype, {"uid": int(u)})
            self.bus.notify(etype, {"uid": int(u)}, uid=int(u))
            self.sched.post_event(etype, {"uid": int(u)})

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
            self.sched.post_event(EventType.PROJECTILE_HIT, payload)
        for u in uid_arr[h["died"]]:
            emit("entity_death", EventType.ENTITY_DEATH, u)
        for u in uid_arr[h["attack_started"]]:
            emit("attack_start", EventType.ATTACK_START, u)
        expired = uid_arr[h["corpse_expired"]]
        for u in expired:
            u = int(u)
            if u in self._structures:   # a destroyed building unblocks nav
                self.set_structure_blocking(u, False)
            slot = self.uid_to_slot.pop(u, None)
            if slot is not None:
                self._free_slots.append(slot)
            self.events.append(("entity_removed", {"uid": u}))
            self.bus.notify(EventType.ENTITY_REMOVED, {"uid": u})
            self.bus.unsubscribe_entity(u)
        if expired.size:
            self.selection.prune_dead(set(self.uid_to_slot))

    # -- entity helpers -------------------------------------------------------------

    def set_flags(self, uids: list[int], set_mask: int = 0,
                  clear_mask: int = 0) -> None:
        """Set and clear ``EntityFlags`` bits of the units (garrisons hide
        their passengers with them)."""
        sl = self._slots_of(uids)
        e = self.state.ents
        e.flags[sl] = (e.flags[sl] | int(set_mask)) & ~int(clear_mask)

    def teleport(self, uid: int, pos_xz: tuple[float, float]) -> None:
        """Place a unit at a position, with no motion in between."""
        slot = self.uid_to_slot[uid]
        p = self._to_device(np.asarray(pos_xz, np.float32))
        self.state.ents.pos[slot] = p
        self.state.ents.prev_pos[slot] = p

    @property
    def render_alpha(self) -> float:
        """Interpolation fraction within the current movement tick, for
        render-rate position lerp (ref: interpolate_tick, movement.c:4085)."""
        period = FRAME_HZ // self.cfg.move_hz
        return ((self._frame % period) + 1) / period

    def prewarm_nav(self) -> None:
        """Build both CUDA libraries (K1 and K2) before the battle, so no
        field build or tick inside it waits on ``nvcc`` (the JAX engine
        compiles its nav kernels here). On the CPU nothing is built."""
        if self.device.type == "cuda":
            from permafrost_engine_tpu_torch.ops import cuda_build
            for name in ("integrate", "hrvo"):
                cuda_build.load(name)

    # -- profiling -------------------------------------------------------------------

    def profile_tick(self, n_frames: int = 60) -> dict:
        """Per-cadence-class tick timing: run n frames SYNCHRONOUSLY (each
        eager tick waited on) and report per-tick ms statistics PER CADENCE
        CLASS, as the JAX engine does: frames are labelled by the gates
        that fire (``move``, ``combat``, ``fog``, joined by ``+``, or
        ``base``), each class gets its p50 and the p50s of the first and
        second half, and ``repeat_spread_pct`` is the worst half-to-half
        disagreement among classes with 6 or more frames. One untimed
        warm-up tick runs first. Events of the probe frames are drained at
        the end; ``tick_cost_analysis`` of the mean is merged in. A
        measurement probe that breaks the graph pipeline, not a driving
        mode (the reference's N-frame-delayed GPU timestamp queries,
        perf.h:155-163)."""
        mp = FRAME_HZ // self.cfg.move_hz
        cp = FRAME_HZ // self.cfg.combat_hz
        fp = max(FRAME_HZ // self.cfg.fog_hz, 1)

        self._sync()
        # untimed warm-up tick: the interactive path usually replays graphs,
        # so eager per-device constants may not be built yet
        self.state, self._acc = self._tick_fn(self.state, self._acc)
        self._frame += 1
        self._sync()
        t_base = self.state.tick
        recs: list[tuple[str, float]] = []
        for i in range(n_frames):
            t = t_base + 1 + i              # the gate fires on tick+1
            label = [n for n, p in (("move", mp), ("combat", cp),
                                    ("fog", fp)) if t % p == 0]
            key = "+".join(label) or "base"
            t0 = time.perf_counter()
            self.state, self._acc = self._tick_fn(self.state, self._acc)
            self._sync()
            recs.append((key, (time.perf_counter() - t0) * 1e3))
        self._frame += n_frames
        self.flush_deltas()

        arr = np.asarray([ms for _, ms in recs])
        classes: dict[str, dict] = {}
        half = len(recs) // 2
        for key in sorted({k for k, _ in recs}):
            all_ms = np.asarray([ms for k, ms in recs if k == key])
            h1 = np.asarray([ms for k, ms in recs[:half] if k == key])
            h2 = np.asarray([ms for k, ms in recs[half:] if k == key])
            classes[key] = {
                "ms_p50": round(float(np.median(all_ms)), 3),
                "n": int(all_ms.size),
                "ms_p50_h1": round(float(np.median(h1)), 3) if h1.size else None,
                "ms_p50_h2": round(float(np.median(h2)), 3) if h2.size else None,
            }
        agree = [abs(c["ms_p50_h1"] - c["ms_p50_h2"])
                 / max((c["ms_p50_h1"] + c["ms_p50_h2"]) / 2, 1e-9) * 100
                 for c in classes.values()
                 if c["n"] >= 6 and c["ms_p50_h1"] and c["ms_p50_h2"]]
        stats = {"ms_p50": float(np.median(arr)),
                 "ms_max": float(arr.max()),
                 "ms_mean": float(arr.mean()),    # amortized per-frame cost
                 "frames": n_frames,
                 "classes": classes,
                 "repeat_spread_pct": round(max(agree), 1) if agree else None}
        # utilisation from the AMORTIZED per-frame cost: the operation
        # count covers every gated substep, so only the mixed-cadence mean
        # is a meaningful denominator
        stats.update(self.tick_cost_analysis(stats["ms_mean"]))
        self.perf.counters["device_tick_exact_ms_p50"] = stats["ms_p50"]
        return stats

    def tick_cost_analysis(self, tick_ms: float | None = None) -> dict:
        """Operations and bytes of one tick, counted op by op (``core/perf.
        OpCounter``, the counterpart of XLA's cost analysis of the compiled
        tick), and, given a measured tick time, the utilisation of the
        card's f32 rate (``H100_F32_OPS_S``).

        The tick runs once, eagerly, on copies of the state and the
        accumulator, at a frame where every substep gate fires, so every
        substep counts (as XLA's count sums every branch). Both counts are
        upper bounds: every op's operands and outputs count as moved, and
        nothing is credited to caching. Kernels launched through ctypes
        (K1 on the card) are not torch ops and are not counted. Nothing of
        the engine changes: not its state, its frame, its accumulator or
        the kernels' launch counters."""
        state, acc = copy.deepcopy((self.state, self._acc))
        period = self._scan_fn.period
        state.tick = (state.tick // period + 1) * period - 1
        if state.anim is not None:
            state.anim.tick.fill_(state.tick)
        launches = graphs._counts()
        counter = OpCounter()
        try:
            with counter:
                self._tick_fn(state, acc)
        finally:
            graphs._set_counts(launches)
        out = {"tick_flops_upper": float(counter.ops),
               "tick_hbm_bytes_upper": float(counter.bytes)}
        if tick_ms:
            out["mfu_upper_pct"] = round(
                100.0 * counter.ops / (tick_ms / 1e3) / H100_F32_OPS_S, 3)
        return out

    def pos_of(self, uid: int) -> np.ndarray:
        return self.state.ents.pos[self.uid_to_slot[uid]].cpu().numpy()

    def movestate_of(self, uid: int) -> MoveState:
        return MoveState(int(self.state.ents.movestate[self.uid_to_slot[uid]]))
