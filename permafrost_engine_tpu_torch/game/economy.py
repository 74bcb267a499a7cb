"""Economy: resources, harvesters, storage sites, buildings, builders,
garrison, population, and idle-worker automation.

Mirrors the reference's systems (ref: src/game/harvester.c, storage_site.c,
resource.c, building.c, builder.c, garrison.c, population.c,
automation.c:163-301). These run at low decimated rates in the reference
(20 Hz garrison, 1-10 Hz economy FSMs) over at most a few hundred workers,
so they live host-side as plain component tables keyed by uid, issuing
move orders through the Engine and reacting to its arrival events. The
device arena stays the source of truth for position/flags/liveness.

The port's own copy of ``permafrost_engine_tpu/game/economy.py``. Where the
JAX code reads a device array with ``np.asarray`` (which fails on a CUDA
tensor, and would sync the device once per read), it reads host columns
from ``Engine.ents_host``: ``tick()`` takes one copy of ``pos``,
``sel_radius``, ``faction``, ``alive`` and ``layer`` at its start, and a
call from outside the tick fetches the columns it needs once. The
``_transport_assigned`` leak on re-targeting (``transport_resources``) is
kept, as in the JAX code.
"""

from __future__ import annotations

import dataclasses
from enum import IntEnum

import numpy as np

from permafrost_engine_tpu_torch.core.config import EntityFlags
from permafrost_engine_tpu_torch.core.events import EventType


class HarvesterState(IntEnum):
    IDLE = 0
    TO_RESOURCE = 1
    HARVESTING = 2
    TO_STORAGE = 3
    TRANSPORT_GETTING = 4    # en route to / taking from a SOURCE storage


class GatherStrategy(IntEnum):
    """Transport strategies (ref: public/game.h:444-457 tstrategy).

    NEAREST: take from the closest eligible storage site regardless of
    its desired stockpile. EXCESS: only take from sites holding MORE than
    their desired stockpile (falling back to NEAREST when no site has
    excess, harvester.c:560-565). GATHERING: keep the target saturated,
    gathering from raw resources first (harvester.c:2097-2100)."""
    NEAREST = 0
    EXCESS = 1
    GATHERING = 2


class BuildingState(IntEnum):
    """Lifecycle: mark -> found -> supply -> complete (ref: building.c)."""
    MARKED = 0
    FOUNDED = 1
    SUPPLIED = 2
    COMPLETED = 3


@dataclasses.dataclass
class ResourceComp:
    name: str
    amount: int
    initial: int
    replenishable: bool = False
    replenish_amount: int = 0


@dataclasses.dataclass
class HarvesterComp:
    state: HarvesterState = HarvesterState.IDLE
    gather_speeds: dict = dataclasses.field(default_factory=dict)   # name -> per-tick
    max_carry: dict = dataclasses.field(default_factory=dict)       # name -> cap
    carried: dict = dataclasses.field(default_factory=dict)         # name -> amt
    target_resource: int = -1
    target_storage: int = -1
    strategy: GatherStrategy = GatherStrategy.NEAREST
    drop_off_only: bool = False
    automated: bool = True
    # -- transport missions (ref: harvester.c STATE_TRANSPORT_*) ----------
    priority: list = dataclasses.field(default_factory=list)  # rname order
    do_not_transport: set = dataclasses.field(default_factory=set)
    transport_dest: int = -1     # target storage being saturated
    transport_src: int = -1      # current source storage
    res_name: str | None = None  # resource being transported
    transport_automated: bool = False  # idle-automation may assign jobs


@dataclasses.dataclass
class StorageComp:
    capacity: dict = dataclasses.field(default_factory=dict)  # name -> cap
    stored: dict = dataclasses.field(default_factory=dict)    # name -> amt
    desired: dict = dataclasses.field(default_factory=dict)   # name -> stockpile
    do_not_take: set = dataclasses.field(default_factory=set)  # per-resource
    # the reference gates taking by the HARVESTER's domain
    # (ref: py_entity.c do_not_take_land/do_not_take_water,
    # harvester.c G_StorageSite_GetDoNotTake)
    do_not_take_land: bool = False
    do_not_take_water: bool = False


@dataclasses.dataclass
class BuildingComp:
    state: BuildingState = BuildingState.MARKED
    required: dict = dataclasses.field(default_factory=dict)  # name -> amt
    supplied: dict = dataclasses.field(default_factory=dict)
    progress: float = 0.0        # 0..1 build completion
    rally_point: tuple | None = None
    vision_when_done: float = 60.0


@dataclasses.dataclass
class BuilderComp:
    build_speed: float = 0.05    # progress per economy tick
    target_building: int = -1
    building: bool = False


@dataclasses.dataclass
class GarrisonComp:
    capacity: int = 0
    held: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class PopulationComp:
    cost: int = 1                # population consumed by this entity
    provides: int = 0            # population cap provided (houses)


_NEAR = 6.0  # interaction proximity in world units
# the entity columns the economy tick reads, copied to the host once a tick
_TICK_COLUMNS = ("pos", "sel_radius", "faction", "alive", "layer")


class Economy:
    """One instance per Engine; `tick()` is called at the economy rate."""

    def __init__(self, engine):
        self.engine = engine
        self.resources: dict[int, ResourceComp] = {}
        self.harvesters: dict[int, HarvesterComp] = {}
        self.storages: dict[int, StorageComp] = {}
        self.buildings: dict[int, BuildingComp] = {}
        self.builders: dict[int, BuilderComp] = {}
        self.garrisons: dict[int, GarrisonComp] = {}
        self.population: dict[int, PopulationComp] = {}
        self.resource_icons: dict[str, str] = {}
        # fairness accounting for cost-ranked transport automation
        # (ref: automation.c s_transport_count)
        self._transport_assigned: dict[int, int] = {}

    # -- queries (back the pf.* economy surface) -------------------------------

    def resource_names(self) -> list[str]:
        return sorted({r.name for r in self.resources.values()})

    def stored_of(self, faction: int, name: str) -> int:
        e = self.engine
        fac = self._ents("faction")["faction"]
        total = 0
        for uid, s in self.storages.items():
            slot = e.uid_to_slot.get(uid)
            if slot is not None and fac[slot] == faction:
                total += s.stored.get(name, 0)
        return total

    def capacity_of(self, faction: int, name: str) -> int:
        e = self.engine
        fac = self._ents("faction")["faction"]
        total = 0
        for uid, s in self.storages.items():
            slot = e.uid_to_slot.get(uid)
            if slot is not None and fac[slot] == faction:
                total += s.capacity.get(name, 0)
        return total

    def population_of(self, faction: int) -> int:
        e = self.engine
        h = self._ents("faction", "alive")
        fac, alive = h["faction"], h["alive"]
        return sum(
            p.cost for uid, p in self.population.items()
            if (s := e.uid_to_slot.get(uid)) is not None
            and alive[s] and fac[s] == faction)

    def population_limit_of(self, faction: int) -> int:
        e = self.engine
        h = self._ents("faction", "alive")
        fac, alive = h["faction"], h["alive"]
        return sum(
            p.provides for uid, p in self.population.items()
            if (s := e.uid_to_slot.get(uid)) is not None
            and alive[s] and fac[s] == faction)

    # -- commands -------------------------------------------------------------

    def gather(self, uid: int, resource_uid: int) -> None:
        h = self.harvesters[uid]
        h.state = HarvesterState.TO_RESOURCE
        h.target_resource = resource_uid
        self._move_to(uid, resource_uid)

    def drop_off(self, uid: int, storage_uid: int) -> None:
        h = self.harvesters[uid]
        h.state = HarvesterState.TO_STORAGE
        h.target_storage = storage_uid
        self._move_to(uid, storage_uid)

    def transport_resources(self, uid: int, storage_uid: int) -> bool:
        """Saturate `storage_uid` toward its desired stockpiles
        (ref: G_Harvester_Transport, harvester.c:2085-2115): pick the
        highest-priority resource the target still desires, then — per
        strategy — gather it from raw resources (GATHERING) or fetch it
        from a source storage site (NEAREST/EXCESS rules)."""
        h = self.harvesters[uid]
        rname = self._transport_resource_for(h, storage_uid)
        if rname is None:
            return False

        if h.strategy == GatherStrategy.GATHERING:
            ruid = self._nearest_resource_named(uid, rname)
            can_gather = (h.gather_speeds.get(rname, 0) > 0
                          or h.max_carry.get(rname, 0) > 0)
            if ruid >= 0 and can_gather:
                h.transport_dest = storage_uid
                h.res_name = rname
                self._transport_assigned[storage_uid] = \
                    self._transport_assigned.get(storage_uid, 0) + 1
                self.gather(uid, ruid)
                return True
            # fall through to storage-to-storage (NEAREST rules)

        src = self._transport_source(uid, storage_uid, rname, h.strategy)
        if src < 0:
            return False
        h.state = HarvesterState.TRANSPORT_GETTING
        h.transport_dest = storage_uid
        h.transport_src = src
        h.res_name = rname
        self._transport_assigned[storage_uid] = \
            self._transport_assigned.get(storage_uid, 0) + 1
        self._move_to(uid, src)
        self.engine.bus.notify(EventType.TRANSPORT_TARGET_ACQUIRED,
                               {"uid": uid, "storage": storage_uid})
        return True

    # -- the orders the economy gives -------------------------------------------

    def _move(self, uids: list[int], goal_xz=None, *,
              to: int | None = None) -> None:
        """``Engine.move`` as the ``Perf`` scope ``economy.order``, counted
        in ``counters["economy.moves"]``; with `to`, the goal is where that
        entity stands, read inside the scope: inside the tick from its host
        copy (no order writes ``pos``), else from the device."""
        e = self.engine
        with e.perf.scope("economy.order"):
            e.counters["economy.moves"] += 1
            if to is not None:
                inside = getattr(self, "_host", None) is not None
                goal_xz = tuple(self._pos_of(to) if inside else e.pos_of(to))
            e.move(uids, goal_xz)

    def _move_to(self, uid: int, target_uid: int) -> None:
        """Send `uid` to where `target_uid` stands: one ``Engine.move`` of
        one unit, so one flock a trip (upstream's G_Move_SetDest)."""
        self._move([uid], to=target_uid)

    def _stop(self, uid: int) -> None:
        """``Engine.stop`` of one unit as the scope ``economy.order``,
        counted in ``counters["economy.stops"]``."""
        e = self.engine
        with e.perf.scope("economy.order"):
            e.counters["economy.stops"] += 1
            e.stop([uid])

    def set_strategy(self, uid: int, strat: GatherStrategy) -> None:
        self.harvesters[uid].strategy = GatherStrategy(strat)

    def get_strategy(self, uid: int) -> GatherStrategy:
        return self.harvesters[uid].strategy

    def _clear_transport(self, h: HarvesterComp) -> None:
        if h.transport_dest >= 0:
            n = self._transport_assigned
            n[h.transport_dest] = max(0, n.get(h.transport_dest, 0) - 1)
        h.transport_dest = -1
        h.transport_src = -1
        h.res_name = None

    def _transport_resource_for(self, h: HarvesterComp,
                                storage_uid: int) -> str | None:
        """Highest-priority resource the target still desires, skipping
        do_not_transport (ref: transport_resource, harvester.c:1384)."""
        s = self.storages.get(storage_uid)
        if s is None:
            return None
        names = h.priority or sorted(s.desired)
        for rname in names:
            if rname in h.do_not_transport:
                continue
            if s.desired.get(rname, 0) > s.stored.get(rname, 0):
                return rname
        return None

    def _transport_source(self, uid: int, dest_uid: int, rname: str,
                          strat: GatherStrategy) -> int:
        """Nearest eligible SOURCE storage (ref: valid_storage_site_source
        + nearest_storage_site_source, harvester.c:490-565): same faction,
        not the target, not do_not_take, actually holding `rname`;
        unsupplied build sites are excluded so builders don't steal
        supplies back and forth. EXCESS only takes from sites above their
        desired stockpile, falling back to the NEAREST rule when no site
        has excess."""
        e = self.engine
        my_slot = e.uid_to_slot.get(uid)
        if my_slot is None:
            return -1
        h = self._ents("faction", "layer")
        fac = h["faction"]
        my_fac = fac[my_slot]

        from permafrost_engine_tpu_torch.core.config import (NUM_FOOTPRINTS,
                                                             NavDomain)
        layer = int(h["layer"][my_slot])
        my_domain = NavDomain(layer // NUM_FOOTPRINTS)

        def candidates(require_excess: bool):
            for suid, s in self.storages.items():
                slot = e.uid_to_slot.get(suid)
                if slot is None or suid == dest_uid or fac[slot] != my_fac:
                    continue
                if rname in s.do_not_take:
                    continue
                if s.do_not_take_land and my_domain == NavDomain.GROUND:
                    continue
                if s.do_not_take_water and my_domain == NavDomain.WATER:
                    continue
                b = self.buildings.get(suid)
                if b is not None and b.state in (BuildingState.MARKED,
                                                 BuildingState.FOUNDED):
                    continue
                stored = s.stored.get(rname, 0)
                if stored <= 0 or s.capacity.get(rname, 0) <= 0:
                    continue
                if require_excess and stored <= s.desired.get(rname, 0):
                    continue
                yield suid

        # distance measured from the DEST site, as the reference does
        # (nearest_storage_site_source searches around `storage`)
        anchor = dest_uid if dest_uid in e.uid_to_slot else uid
        for require_excess in ((True, False) if strat == GatherStrategy.EXCESS
                               else (False,)):
            best, best_d = -1, np.inf
            for suid in candidates(require_excess):
                d = float(np.linalg.norm(self._pos_of(anchor)
                                         - self._pos_of(suid)))
                if d < best_d:
                    best, best_d = suid, d
            if best >= 0:
                return best
        return -1

    def _nearest_resource_named(self, uid: int, rname: str) -> int:
        best, best_d = -1, np.inf
        for ruid, res in self.resources.items():
            if res.name != rname or res.amount <= 0:
                continue
            if ruid not in self.engine.uid_to_slot:
                continue
            d = float(np.linalg.norm(self._pos_of(uid) - self._pos_of(ruid)))
            if d < best_d:
                best, best_d = ruid, d
        return best

    def build(self, uid: int, building_uid: int) -> None:
        b = self.builders[uid]
        b.target_building = building_uid
        b.building = False
        self._move_to(uid, building_uid)

    def found_building(self, building_uid: int) -> None:
        b = self.buildings[building_uid]
        if b.state == BuildingState.MARKED:
            b.state = BuildingState.FOUNDED
            # founded buildings cut their footprint out of the nav grid
            # (ref: G_Building_Found -> pathable toggle -> N_CutoutStaticObject)
            self.engine.set_structure_blocking(building_uid, True)
            self.engine.events.append(("building_founded", {"uid": building_uid}))
            self.engine.bus.notify(EventType.BUILDING_FOUNDED, building_uid)

    def supply_building(self, building_uid: int, name: str, amount: int) -> int:
        """Deliver resources toward construction; returns amount accepted."""
        b = self.buildings[building_uid]
        need = b.required.get(name, 0) - b.supplied.get(name, 0)
        take = max(0, min(need, amount))
        b.supplied[name] = b.supplied.get(name, 0) + take
        if all(b.supplied.get(k, 0) >= v for k, v in b.required.items()):
            if b.state == BuildingState.FOUNDED:
                b.state = BuildingState.SUPPLIED
        return take

    def garrison(self, uid: int, holder_uid: int) -> bool:
        g = self.garrisons[holder_uid]
        if len(g.held) >= g.capacity:
            return False
        d = np.linalg.norm(self.engine.pos_of(uid) - self.engine.pos_of(holder_uid))
        if d > _NEAR * 2:
            self._move_to(uid, holder_uid)
            return False
        g.held.append(uid)
        self.engine.set_flags([uid], set_mask=int(EntityFlags.GARRISONED)
                              | int(EntityFlags.INVISIBLE))
        self.engine.bus.notify(EventType.GARRISON_ENTERED,
                               {"uid": uid, "holder": holder_uid})
        return True

    def evict(self, holder_uid: int, uid: int | None = None) -> list[int]:
        g = self.garrisons[holder_uid]
        out = [uid] if uid is not None else list(g.held)
        freed = []
        hp = self.engine.pos_of(holder_uid)
        for i, u in enumerate(out):
            if u not in g.held:
                continue
            g.held.remove(u)
            self.engine.set_flags([u], clear_mask=int(EntityFlags.GARRISONED)
                                  | int(EntityFlags.INVISIBLE))
            self.engine.teleport(u, (float(hp[0]) + 3.0 + 2.0 * i, float(hp[1]) + 3.0))
            self.engine.bus.notify(EventType.GARRISON_EXITED,
                                   {"uid": u, "holder": holder_uid})
            freed.append(u)
        return freed

    def transport(self, transporter_uid: int, unit_uids: list[int],
                  dest_xz: tuple[float, float]) -> None:
        """Transport mission (ref: garrison.c transport): load the units,
        carry them to the destination, evict there. Runs as a cooperative
        task on the engine scheduler."""
        eng = self.engine
        state = {"phase": "loading", "pending": list(unit_uids)}

        def mission(task):
            from permafrost_engine_tpu_torch.core.sched import Sleep
            while state["pending"]:
                for u in list(state["pending"]):
                    if u not in eng.uid_to_slot:
                        state["pending"].remove(u)
                    elif self.garrison(u, transporter_uid):
                        state["pending"].remove(u)
                yield Sleep(10)
            self._move([transporter_uid], dest_xz)
            while True:
                d = np.linalg.norm(eng.pos_of(transporter_uid)
                                   - np.asarray(dest_xz))
                if d < 12.0:
                    break
                yield Sleep(10)
            self.evict(transporter_uid)

        eng.sched.create(mission, name=f"transport_{transporter_uid}")

    # -- the economy tick --------------------------------------------------------

    def tick(self) -> None:
        """One economy tick: the ``Perf`` scope ``economy``, with the parts
        ``economy.harvest``, ``economy.build`` and ``economy.automation``;
        its orders are ``economy.order`` scopes inside them. The orders
        form one ``Engine.order_batch``, given at the end of the tick (and
        before a despawn inside it), each flush an ``economy.order``
        scope."""
        e = self.engine
        with e.perf.scope("economy", owner=True):
            # ONE host copy of the entity columns the tick reads, taken at
            # its start (one device sync on the card); per-pair reads would
            # each sync the device and go quadratic at scale. The orders the
            # tick issues change none of the columns it reads.
            self._host = e.ents_host(*_TICK_COLUMNS)
            try:
                with e.order_batch("economy.order"):
                    with e.perf.scope("economy.harvest"):
                        self._tick_harvesters()
                    with e.perf.scope("economy.build"):
                        self._tick_builders()
                    with e.perf.scope("economy.automation"):
                        self._tick_automation()
                self._tick_replenish()
            finally:
                self._host = None

    def _ents(self, *names: str) -> dict:
        """Host arrays of entity columns: the tick's copy inside
        ``tick()``, else one fresh copy of `names` for this call."""
        if getattr(self, "_host", None) is not None:
            return self._host
        return self.engine.ents_host(*names)

    def _pos_of(self, uid: int) -> np.ndarray:
        slot = self.engine.uid_to_slot[uid]
        return self._ents("pos")["pos"][slot]

    def _near(self, uid_a: int, uid_b: int) -> bool:
        e = self.engine
        try:
            sa, sb = e.uid_to_slot[uid_a], e.uid_to_slot[uid_b]
        except KeyError:
            return False
        h = self._ents("pos", "sel_radius")
        pos, rad = h["pos"], h["sel_radius"]
        return float(np.linalg.norm(pos[sa] - pos[sb])) <= \
            float(rad[sa]) + float(rad[sb]) + _NEAR

    def _nearest_storage(self, uid: int, name: str) -> int:
        """Nearest same-faction storage with room for `name`."""
        e = self.engine
        fac = self._ents("faction")["faction"]
        my_fac = fac[e.uid_to_slot[uid]]
        best, best_d = -1, np.inf
        for suid, s in self.storages.items():
            slot = e.uid_to_slot.get(suid)
            if slot is None or fac[slot] != my_fac:
                continue
            if s.stored.get(name, 0) >= s.capacity.get(name, 0):
                continue
            d = float(np.linalg.norm(self._pos_of(uid) - self._pos_of(suid)))
            if d < best_d:
                best, best_d = suid, d
        return best

    def _tick_harvesters(self) -> None:
        e = self.engine
        for uid, h in self.harvesters.items():
            if uid not in e.uid_to_slot:
                continue
            if h.state == HarvesterState.TO_RESOURCE:
                res = self.resources.get(h.target_resource)
                if res is None or res.amount <= 0:
                    h.state = HarvesterState.IDLE
                    continue
                if self._near(uid, h.target_resource):
                    self._stop(uid)
                    h.state = HarvesterState.HARVESTING
            elif h.state == HarvesterState.HARVESTING:
                res = self.resources.get(h.target_resource)
                if res is None or res.amount <= 0:
                    self._head_to_storage_or_idle(uid, h)
                    continue
                name = res.name
                speed = h.gather_speeds.get(name, 1)
                cap = h.max_carry.get(name, 10)
                take = int(min(speed, res.amount, cap - h.carried.get(name, 0)))
                res.amount -= take
                h.carried[name] = h.carried.get(name, 0) + take
                if res.amount <= 0:
                    e.bus.notify(EventType.RESOURCE_EXHAUSTED, h.target_resource)
                    if not res.replenishable:
                        # exhausted non-replenishable resources leave the
                        # world (the reference removes the entity)
                        self.resources.pop(h.target_resource, None)
                        if h.target_resource in e.uid_to_slot:
                            e.despawn(h.target_resource)
                if h.carried.get(name, 0) >= cap:
                    self._head_to_storage_or_idle(uid, h)
            elif h.state == HarvesterState.TO_STORAGE:
                s = self.storages.get(h.target_storage)
                if s is None:
                    h.state = HarvesterState.IDLE
                    self._clear_transport(h)
                    continue
                if self._near(uid, h.target_storage):
                    self._stop(uid)
                    for name, amt in list(h.carried.items()):
                        room = s.capacity.get(name, 0) - s.stored.get(name, 0)
                        put = max(0, min(room, amt))
                        s.stored[name] = s.stored.get(name, 0) + put
                        h.carried[name] = amt - put
                    h.carried = {k: v for k, v in h.carried.items() if v > 0}
                    if h.transport_dest >= 0:
                        # transport mission deposit: keep saturating the
                        # target while it desires more and a source/
                        # resource exists (ref: harvester.c transport loop)
                        dest = h.transport_dest
                        self._clear_transport(h)
                        h.state = HarvesterState.IDLE
                        if self._transport_resource_for(
                                h, dest) is not None:
                            self.transport_resources(uid, dest)
                    # back to the resource if it still exists
                    elif h.target_resource in self.resources:
                        self.gather(uid, h.target_resource)
                    else:
                        h.state = HarvesterState.IDLE
            elif h.state == HarvesterState.TRANSPORT_GETTING:
                self._tick_transport_getting(uid, h)

    def _tick_transport_getting(self, uid: int, h: HarvesterComp) -> None:
        """Arrived-at-source handling (ref: on_arrive_at_transport_source,
        harvester.c:990-1080): take per the strategy's rules, chain to
        further sources while under max carry, then deliver."""
        e = self.engine
        src = self.storages.get(h.transport_src)
        rname = h.res_name
        if src is None or rname is None or h.transport_dest not in self.storages:
            self._clear_transport(h)
            h.state = HarvesterState.IDLE
            return
        if not self._near(uid, h.transport_src):
            return
        self._stop(uid)
        stored = src.stored.get(rname, 0)
        desired = src.desired.get(rname, 0)
        cap_left = h.max_carry.get(rname, 10) - h.carried.get(rname, 0)
        if h.strategy == GatherStrategy.EXCESS:
            # when NO site has excess the fallback pass picked this one
            # and the desired limit may be overstepped (harvester.c:1009)
            fresh = self._transport_source(uid, h.transport_dest, rname,
                                           GatherStrategy.EXCESS)
            if fresh == h.transport_src and stored <= desired:
                take = min(cap_left, stored)
            else:
                take = max(min(cap_left, stored - desired), 0)
        else:
            take = min(cap_left, stored)
        src.stored[rname] = stored - take
        h.carried[rname] = h.carried.get(rname, 0) + take
        if take > 0:
            e.bus.notify(EventType.RESOURCE_PICKED_UP,
                         {"uid": uid, "name": rname, "amount": take})
        carried = h.carried.get(rname, 0)
        if carried < h.max_carry.get(rname, 10):
            # top up from another eligible source before delivering
            nxt = self._transport_source(uid, h.transport_dest, rname,
                                         h.strategy)
            if nxt >= 0 and nxt != h.transport_src:
                h.transport_src = nxt
                self._move_to(uid, nxt)
                return
        if carried == 0:
            self._clear_transport(h)
            h.state = HarvesterState.IDLE
            return
        h.state = HarvesterState.TO_STORAGE
        h.target_storage = h.transport_dest
        self._move_to(uid, h.transport_dest)

    def _head_to_storage_or_idle(self, uid: int, h: HarvesterComp) -> None:
        carried_names = [k for k, v in h.carried.items() if v > 0]
        if h.transport_dest >= 0 and h.transport_dest in self.storages \
                and carried_names:
            # GATHERING missions deliver to the site being saturated
            self.drop_off(uid, h.transport_dest)
            return
        if carried_names:
            suid = self._nearest_storage(uid, carried_names[0])
            if suid >= 0:
                self.drop_off(uid, suid)
                return
        h.state = HarvesterState.IDLE
        self._clear_transport(h)

    def _tick_builders(self) -> None:
        e = self.engine
        for uid, b in self.builders.items():
            if b.target_building < 0 or uid not in e.uid_to_slot:
                continue
            bc = self.buildings.get(b.target_building)
            if bc is None or bc.state == BuildingState.COMPLETED:
                b.target_building = -1
                b.building = False
                continue
            if not b.building:
                if self._near(uid, b.target_building):
                    self._stop(uid)
                    b.building = True
            if b.building and bc.state == BuildingState.SUPPLIED:
                bc.progress = min(1.0, bc.progress + b.build_speed)
                # hp grows with progress (ref: building.c)
                slot = e.uid_to_slot[b.target_building]
                ents = e.state.ents
                mh = float(ents.max_hp[slot])
                ents.hp[slot] = mh * bc.progress
                if bc.progress >= 1.0:
                    bc.state = BuildingState.COMPLETED
                    e.bus.notify(EventType.BUILDING_COMPLETED, b.target_building)
                    b.target_building = -1
                    b.building = False

    # cost units: distance per unit of job cost (ref: automation.c:71)
    TRANSPORT_UNIT_COST_DISTANCE = 150.0

    def _tick_automation(self) -> None:
        """Idle-worker automation (ref: automation.c:163-400):
        transport-automated harvesters get COST-RANKED site assignments —
        cost = distance/150u + number of workers already servicing the
        site, ties broken by (assigned, distance) — so a pile of idle
        workers spreads across needy sites instead of mobbing the nearest
        one; plain automated harvesters fall back to gathering the
        nearest non-empty resource."""
        e = self.engine
        for uid, h in self.harvesters.items():
            if h.state != HarvesterState.IDLE or uid not in e.uid_to_slot:
                continue
            if h.transport_automated and self._assign_transport_job(uid, h):
                continue
            if not h.automated or not self.resources:
                continue
            names_ok = set(h.gather_speeds) | set(h.max_carry)
            best, best_d = -1, np.inf
            for ruid, res in self.resources.items():
                if ruid not in e.uid_to_slot or res.amount <= 0:
                    continue
                if names_ok and res.name not in names_ok:
                    continue
                d = float(np.linalg.norm(self._pos_of(uid) - self._pos_of(ruid)))
                if d < best_d:
                    best, best_d = ruid, d
            if best >= 0:
                self.gather(uid, best)

    def _assign_transport_job(self, uid: int, h: HarvesterComp) -> bool:
        """Pick the cheapest (cost, assigned, distance) needy site the
        worker can service and start a transport mission to it
        (ref: target_site_for_resource + compare_jobs,
        automation.c:163-301)."""
        e = self.engine
        fac = self._ents("faction")["faction"]
        my_fac = fac[e.uid_to_slot[uid]]
        names = h.priority or sorted(
            {n for s in self.storages.values() for n in s.desired})
        for rname in names:
            if rname in h.do_not_transport or h.max_carry.get(rname, 0) <= 0:
                continue
            ranked = []
            for suid, s in self.storages.items():
                slot = e.uid_to_slot.get(suid)
                if slot is None or fac[slot] != my_fac:
                    continue
                if s.desired.get(rname, 0) <= s.stored.get(rname, 0):
                    continue
                dist = float(np.linalg.norm(self._pos_of(uid)
                                            - self._pos_of(suid)))
                assigned = self._transport_assigned.get(suid, 0)
                cost = int(dist / self.TRANSPORT_UNIT_COST_DISTANCE) + assigned
                ranked.append((cost, assigned, dist, suid))
            ranked.sort()
            for _, _, _, suid in ranked:
                if self.transport_resources(uid, suid):
                    return True
        return False

    def _tick_replenish(self) -> None:
        for res in self.resources.values():
            if res.replenishable and res.amount < res.initial:
                res.amount = min(res.initial, res.amount + res.replenish_amount)
