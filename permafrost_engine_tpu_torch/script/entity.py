"""Script-facing entity classes: pf.Entity and its mixin hierarchy.

Mirrors the reference's Python entity classes (ref: src/script/py_entity.c:
278-1329): a base Entity plus mixins AnimEntity, CombatableEntity,
BuildableEntity, BuilderEntity, ResourceEntity, HarvesterEntity,
StorageSiteEntity, MovableEntity, WaterEntity, AirEntity, GarrisonEntity,
GarrisonableEntity, PopulationContributorEntity and
PopulationLimitContributorEntity. Attribute access bridges to the device
arena through the Engine (the reference bridges to G_*/E_* C APIs).

Identity: one Python object per uid, tracked in the engine-bound context
(weakrefs, like py_entity.c's weakref-based identity map).

Port of ``permafrost_engine_tpu/script/entity.py``. A property reads the one
element of the entity's slot, one device read each (one synchronization on
the card, as the JAX property is one transfer of its column); ``pos`` reads
its position and height in one. Setters and orders write the engine's
tensors in place, on its device and in each column's dtype, between
segments; components go through the port's ``game/economy.py``.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from permafrost_engine_tpu_torch.core.config import (
    CombatStance,
    EntityFlags,
    MoveState,
    NavDomain,
)
from permafrost_engine_tpu_torch.core.events import EventType
from permafrost_engine_tpu_torch.game.economy import (
    BuildingComp,
    BuilderComp,
    GarrisonComp,
    HarvesterComp,
    PopulationComp,
    ResourceComp,
    StorageComp,
)


class Entity:
    """Base scriptable entity (ref: py_entity.c pf.Entity)."""

    _extra_flags = 0
    _domain = NavDomain.GROUND

    def __init__(self, pfobj_path: str = "", name: str = "", pos=(0.0, 0.0),
                 *, faction_id: int = 0, radius: float = 1.0,
                 speed: float = 10.0, vision_range: float = 60.0, **kw):
        ctx = _ctx()
        eng = ctx.engine
        flags = int(EntityFlags.COLLISION | EntityFlags.SELECTABLE)
        flags |= self._collect_flags()
        pos2 = np.asarray(self._pos2(pos), np.float32).reshape(1, 2)
        uid = eng.spawn_batch(
            pos2, faction=faction_id, radius=radius, max_speed=speed,
            flags=flags, domain=self._domain, vision_range=vision_range,
            **{k: v for k, v in kw.items()
               if k in ("hp", "attack_range", "base_dmg", "armour_pc",
                        "attack_period", "is_ranged", "sel_radius")},
        )[0]
        self.uid = uid
        self.name = name
        self.pfobj_path = pfobj_path
        self.tags: set[str] = set()
        # subformation identity: the script class is the unit type, with
        # an optional class-level `formation_priority` int (ref:
        # Entity_TypeID + S_FormationPriority, py_script.c:4746-4784).
        # The qualname hash is stable across processes (save/load).
        import zlib
        cls = type(self)
        eng.unit_type[uid] = (
            int(getattr(cls, "formation_priority", 0)),
            zlib.crc32(cls.__qualname__.encode()))
        self._init_components()
        ctx.entities[uid] = weakref.ref(self)

    def _collect_flags(self) -> int:
        f = 0
        for klass in type(self).__mro__:
            f |= getattr(klass, "_extra_flags", 0)
        return f

    def _init_components(self) -> None:
        pass

    @staticmethod
    def _pos2(pos):
        """Accept (x, z) or the reference's (x, y, z)."""
        if len(pos) == 3:
            return (pos[0], pos[2])
        return tuple(pos)

    # -- engine bridges ------------------------------------------------------

    @property
    def _eng(self):
        return _ctx().engine

    @property
    def _slot(self) -> int:
        return self._eng.uid_to_slot[self.uid]

    def _read(self, name: str):
        """The slot's element of entity column `name`, as a Python scalar."""
        return getattr(self._eng.state.ents, name)[self._slot].item()

    def _write(self, name: str, value) -> None:
        """Set the slot's element of entity column `name`, in place."""
        getattr(self._eng.state.ents, name)[self._slot] = value

    @property
    def pos(self):
        e, s = self._eng.state.ents, self._slot
        x, z, h = torch.cat([e.pos[s], e.height[s:s + 1]]).tolist()
        return (x, h, z)

    @pos.setter
    def pos(self, value):
        self._eng.teleport(self.uid, self._pos2(value))

    @property
    def rotation(self) -> float:
        return float(self._read("facing"))

    @property
    def faction_id(self) -> int:
        return int(self._read("faction"))

    @property
    def selection_radius(self) -> float:
        return float(self._read("sel_radius"))

    @property
    def selectable(self) -> bool:
        return bool(int(self._read("flags")) & int(EntityFlags.SELECTABLE))

    @property
    def zombie(self) -> bool:
        return self.uid not in self._eng.uid_to_slot

    def ping(self) -> bool:
        return not self.zombie

    # -- events ----------------------------------------------------------------

    def register(self, event: int, handler, arg=None) -> None:
        ctx = _ctx()
        wrapped = (lambda a, h=handler, x=arg: h(x, a)) if arg is not None else handler
        ctx.engine.bus.subscribe(event, wrapped, uid=self.uid)

    def unregister(self, event: int, handler) -> None:
        _ctx().engine.bus.unsubscribe(event, handler, uid=self.uid)

    def notify(self, event: int, arg=None) -> None:
        _ctx().engine.bus.notify(event, arg, uid=self.uid)

    # -- lifecycle ---------------------------------------------------------------

    def zombiefy(self) -> None:
        """Remove from simulation, keep the Python object (ref: py_entity)."""
        eng = self._eng
        if self.uid in eng.uid_to_slot:
            eng.bus.notify(EventType.ENTITY_REMOVED, {"uid": self.uid})
            eng.despawn(self.uid)
            _ctx().entities.pop(self.uid, None)

    def __eq__(self, other):
        return isinstance(other, Entity) and other.uid == self.uid

    def __hash__(self):
        return hash(self.uid)

    def __repr__(self):
        return f"<{type(self).__name__} uid={self.uid} name={self.name!r}>"


class MovableEntity(Entity):
    _extra_flags = int(EntityFlags.MOVABLE)

    def move(self, pos) -> bool:
        return self._eng.move([self.uid], self._pos2(pos))

    def stop(self) -> None:
        self._eng.stop([self.uid])

    def seek_enemies(self) -> bool:
        """Hunt nearest enemies via a whole-map enemy-seek field."""
        return self._eng.seek_enemies([self.uid])

    @property
    def speed(self) -> float:
        return float(self._read("max_speed"))

    @speed.setter
    def speed(self, v: float) -> None:
        self._write("max_speed", float(v))

    @property
    def moving(self) -> bool:
        return self._eng.movestate_of(self.uid) != MoveState.ARRIVED


class AnimEntity(Entity):
    """Animated entity: clip playback state lives host-side; pose matrices
    are batched on device (render/anim.py). ref: src/anim/anim.c."""
    _extra_flags = int(EntityFlags.ANIMATED)

    def _init_components(self) -> None:
        super()._init_components()
        ctx = _ctx()
        ctx.engine.anim.register(self.uid, idle_clip="idle")

    def play_anim(self, name: str, mode: int = 0) -> None:
        _ctx().engine.anim.play(self.uid, name, mode)

    def get_anim(self) -> str:
        return _ctx().engine.anim.current(self.uid)


class CombatableEntity(Entity):
    _extra_flags = int(EntityFlags.COMBATABLE)

    @property
    def hp(self) -> float:
        return float(self._read("hp"))

    @hp.setter
    def hp(self, v: float) -> None:
        self._write("hp", float(v))

    @property
    def max_hp(self) -> float:
        return float(self._read("max_hp"))

    @property
    def base_dmg(self) -> float:
        return float(self._read("base_dmg"))

    @property
    def base_armour(self) -> float:
        return float(self._read("armour_pc"))

    @property
    def attack_range(self) -> float:
        return float(self._read("attack_range"))

    @property
    def stance(self) -> CombatStance:
        return CombatStance(int(self._read("stance")))

    @stance.setter
    def stance(self, v) -> None:
        self._eng.set_stance([self.uid], int(v))

    def hold_position(self) -> None:
        self.stance = CombatStance.HOLD_POSITION

    def attack(self, target: "Entity") -> None:
        """Explicit attack order: chase + engage the target."""
        self._write("target", self._eng.uid_to_slot[target.uid])
        self._write("stance", int(CombatStance.AGGRESSIVE))


class BuildableEntity(Entity):
    _extra_flags = int(EntityFlags.BUILDING)

    def _init_components(self) -> None:
        super()._init_components()
        eco = _ctx().engine.economy
        eco.buildings[self.uid] = BuildingComp(
            required=dict(getattr(self, "required_resources", {})))

    @property
    def _bc(self) -> BuildingComp:
        return _ctx().engine.economy.buildings[self.uid]

    def found(self) -> None:
        _ctx().engine.economy.found_building(self.uid)

    def supply(self, name: str, amount: int) -> int:
        return _ctx().engine.economy.supply_building(self.uid, name, amount)

    @property
    def completed(self) -> bool:
        from permafrost_engine_tpu_torch.game.economy import BuildingState
        return self._bc.state == BuildingState.COMPLETED

    @property
    def progress(self) -> float:
        return self._bc.progress

    @property
    def rally_point(self):
        return self._bc.rally_point

    @rally_point.setter
    def rally_point(self, pos):
        self._bc.rally_point = self._pos2(pos)


class BuilderEntity(MovableEntity):
    _extra_flags = int(EntityFlags.BUILDER)

    def _init_components(self) -> None:
        super()._init_components()
        _ctx().engine.economy.builders[self.uid] = BuilderComp()

    def build(self, building: BuildableEntity) -> None:
        _ctx().engine.economy.build(self.uid, building.uid)


class ResourceEntity(Entity):
    _extra_flags = int(EntityFlags.RESOURCE)

    def __init__(self, *args, resource_name: str = "Wood",
                 resource_amount: int = 100, **kw):
        self._res_name = resource_name
        self._res_amount = resource_amount
        super().__init__(*args, **kw)

    def _init_components(self) -> None:
        super()._init_components()
        _ctx().engine.economy.resources[self.uid] = ResourceComp(
            name=self._res_name, amount=self._res_amount,
            initial=self._res_amount)

    @property
    def resource_name(self) -> str:
        return _ctx().engine.economy.resources[self.uid].name

    @property
    def resource_amount(self) -> int:
        return _ctx().engine.economy.resources[self.uid].amount


class HarvesterEntity(MovableEntity):
    _extra_flags = int(EntityFlags.HARVESTER)

    def _init_components(self) -> None:
        super()._init_components()
        _ctx().engine.economy.harvesters[self.uid] = HarvesterComp()

    @property
    def _hc(self) -> HarvesterComp:
        return _ctx().engine.economy.harvesters[self.uid]

    def gather(self, resource: ResourceEntity) -> None:
        _ctx().engine.economy.gather(self.uid, resource.uid)
        _ctx().engine.bus.notify(
            EventType.HARVEST_TARGET_ACQUIRED,
            {"uid": self.uid, "resource": resource.uid})

    def drop_off(self, storage: "StorageSiteEntity") -> None:
        _ctx().engine.economy.drop_off(self.uid, storage.uid)

    def set_max_carry(self, name: str, amount: int) -> None:
        self._hc.max_carry[name] = amount

    def set_gather_speed(self, name: str, speed: float) -> None:
        self._hc.gather_speeds[name] = speed

    def carried(self, name: str) -> int:
        return self._hc.carried.get(name, 0)

    # -- transport missions + strategies (ref: py_entity.c:776-861) --------

    def transport(self, storage: "StorageSiteEntity") -> bool:
        """Bring resources to the target storage site, using the
        harvester's strategy and priority list (ref: py_entity.c:776)."""
        return _ctx().engine.economy.transport_resources(
            self.uid, storage.uid)

    @property
    def strategy(self):
        return self._hc.strategy

    @strategy.setter
    def strategy(self, value) -> None:
        from permafrost_engine_tpu_torch.game.economy import GatherStrategy
        self._hc.strategy = GatherStrategy(value)

    @property
    def automatic_transport(self) -> bool:
        return self._hc.transport_automated

    @automatic_transport.setter
    def automatic_transport(self, value: bool) -> None:
        self._hc.transport_automated = bool(value)

    @property
    def transport_priority(self) -> list:
        return list(self._hc.priority)

    def increase_transport_priority(self, name: str) -> None:
        p = self._hc.priority
        if name not in p:
            p.append(name)
        i = p.index(name)
        if i > 0:
            p[i - 1], p[i] = p[i], p[i - 1]

    def decrease_transport_priority(self, name: str) -> None:
        p = self._hc.priority
        if name not in p:
            p.append(name)
            return
        i = p.index(name)
        if i < len(p) - 1:
            p[i + 1], p[i] = p[i], p[i + 1]

    def get_do_not_transport(self, name: str) -> bool:
        return name in self._hc.do_not_transport

    def set_do_not_transport(self, name: str, flag: bool = True) -> None:
        if flag:
            self._hc.do_not_transport.add(name)
        else:
            self._hc.do_not_transport.discard(name)


class StorageSiteEntity(Entity):
    _extra_flags = int(EntityFlags.STORAGE_SITE)

    def _init_components(self) -> None:
        super()._init_components()
        _ctx().engine.economy.storages[self.uid] = StorageComp()

    @property
    def _sc(self) -> StorageComp:
        return _ctx().engine.economy.storages[self.uid]

    def set_capacity(self, name: str, amount: int) -> None:
        self._sc.capacity[name] = amount

    def get_storable(self, name: str) -> int:
        return self._sc.capacity.get(name, 0) - self._sc.stored.get(name, 0)

    def get_curr(self, name: str) -> int:
        return self._sc.stored.get(name, 0)

    def set_desired(self, name: str, amount: int) -> None:
        self._sc.desired[name] = amount

    def get_desired(self, name: str) -> int:
        return self._sc.desired.get(name, 0)

    @property
    def do_not_take_land(self) -> bool:
        return self._sc.do_not_take_land

    @do_not_take_land.setter
    def do_not_take_land(self, value: bool) -> None:
        self._sc.do_not_take_land = bool(value)

    @property
    def do_not_take_water(self) -> bool:
        return self._sc.do_not_take_water

    @do_not_take_water.setter
    def do_not_take_water(self, value: bool) -> None:
        self._sc.do_not_take_water = bool(value)


class WaterEntity(MovableEntity):
    _extra_flags = int(EntityFlags.WATER)
    _domain = NavDomain.WATER


class AirEntity(MovableEntity):
    _extra_flags = int(EntityFlags.AIR)
    _domain = NavDomain.AIR


class GarrisonEntity(MovableEntity):
    """Unit that can enter garrisonable holders (ref: py_entity Garrison)."""
    _extra_flags = int(EntityFlags.GARRISON)

    def garrison(self, holder: "GarrisonableEntity") -> bool:
        return _ctx().engine.economy.garrison(self.uid, holder.uid)


class GarrisonableEntity(Entity):
    _extra_flags = int(EntityFlags.GARRISONABLE)

    def __init__(self, *args, garrison_capacity: int = 4, **kw):
        self._gcap = garrison_capacity
        super().__init__(*args, **kw)

    def _init_components(self) -> None:
        super()._init_components()
        _ctx().engine.economy.garrisons[self.uid] = GarrisonComp(
            capacity=self._gcap)

    @property
    def garrisoned_units(self) -> list[int]:
        return list(_ctx().engine.economy.garrisons[self.uid].held)

    def evict(self, uid: int | None = None) -> list[int]:
        return _ctx().engine.economy.evict(self.uid, uid)


class PopulationContributorEntity(Entity):
    def __init__(self, *args, population_cost: int = 1, **kw):
        self._pop_cost = population_cost
        super().__init__(*args, **kw)

    def _init_components(self) -> None:
        super()._init_components()
        eco = _ctx().engine.economy
        comp = eco.population.setdefault(self.uid, PopulationComp())
        comp.cost = self._pop_cost


class PopulationLimitContributorEntity(Entity):
    def __init__(self, *args, population_provided: int = 5, **kw):
        self._pop_prov = population_provided
        super().__init__(*args, **kw)

    def _init_components(self) -> None:
        super()._init_components()
        eco = _ctx().engine.economy
        comp = eco.population.setdefault(self.uid, PopulationComp())
        comp.provides = self._pop_prov
        comp.cost = 0


def _ctx():
    from permafrost_engine_tpu_torch.script import pf
    return pf.context()
