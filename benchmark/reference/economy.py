"""One economy tick, plainly: the harvesters, builders, idle-worker
automation and replenishment of upstream's RTS (``scripts/rts/main.py``
over src/game/harvester.c, storage_site.c, resource.c, building.c,
builder.c and automation.c:163-301), as the port's ``game/economy.py``
gives their semantics. Plain Python and numpy: it imports neither the
port nor JAX.

``tick(tables, host, slots, max_hp, structures)`` runs one tick from

- ``tables``: the component tables as plain records (``resources``,
  ``harvesters``, ``storages``, ``buildings``, ``builders``, each a dict
  by uid of dicts of the component's fields, enums as ints, and
  ``transport_assigned``, a dict by storage uid);
- ``host``: the entity columns the tick reads (``pos``, ``sel_radius``,
  ``faction``, ``alive``, ``layer``), as host arrays by slot;
- ``slots``: uid -> slot of every entity in the world;
- ``max_hp``: the entities' ``max_hp`` column, which the builders read;
- ``structures``: the uids whose footprints are cut into the nav map;

and returns (tables after the tick, the operations it issued in order):
``("move", uid, (x, z))``, ``("stop", uid)``, ``("despawn", uid)``,
``("unstamp", uid)`` (a despawned structure's footprint lifted) and
``("hp", uid, value)``. A move's goal is the target entity's position as
``host`` holds it: the tick's orders change no column it reads.

Departures from the port: none in what is computed. The events the port
notifies on its bus (resource exhausted, picked up, transport target,
building completed) are left out; nothing of the tables depends on them.
Kept as the port has it: a harvester re-targeted by a transport deposit
counts once more in ``transport_assigned`` without the old count being
released first (the leak of ``transport_resources``).
"""

from __future__ import annotations

import copy

import numpy as np

# HarvesterState, GatherStrategy, BuildingState (economy.py)
IDLE, TO_RESOURCE, HARVESTING, TO_STORAGE, TRANSPORT_GETTING = range(5)
NEAREST, EXCESS, GATHERING = range(3)
MARKED, FOUNDED, SUPPLIED, COMPLETED = range(4)
NEAR = 6.0                        # interaction proximity in world units
NUM_FOOTPRINTS = 4
GROUND, WATER = 0, 1
UNIT_COST_DISTANCE = 150.0        # automation.c:71
DEFAULT_SPEED, DEFAULT_CARRY = 1, 10


class _Tick:
    def __init__(self, tables, host, slots, max_hp, structures):
        t = copy.deepcopy(tables)
        self.res = t["resources"]
        self.harv = t["harvesters"]
        self.stor = t["storages"]
        self.bld = t["buildings"]
        self.bldr = t["builders"]
        self.assigned = t["transport_assigned"]
        self.tables = t
        self.host = host
        self.slots = dict(slots)
        self.max_hp = max_hp
        self.structures = set(structures)
        self.ops: list = []

    # -- the world ------------------------------------------------------------

    def pos(self, uid):
        return self.host["pos"][self.slots[uid]]

    def dist(self, a, b) -> float:
        return float(np.linalg.norm(self.pos(a) - self.pos(b)))

    def near(self, a, b) -> bool:
        if a not in self.slots or b not in self.slots:
            return False
        rad = self.host["sel_radius"]
        return self.dist(a, b) <= float(rad[self.slots[a]]) \
            + float(rad[self.slots[b]]) + NEAR

    def faction(self, uid):
        return self.host["faction"][self.slots[uid]]

    def move(self, uid, target):
        self.ops.append(("move", uid, tuple(self.pos(target))))

    def stop(self, uid):
        self.ops.append(("stop", uid))

    def despawn(self, uid):
        if uid in self.structures:
            self.structures.discard(uid)
            self.ops.append(("unstamp", uid))
        del self.slots[uid]
        self.ops.append(("despawn", uid))

    # -- the commands the tick gives -------------------------------------------

    def gather(self, uid, ruid):
        h = self.harv[uid]
        h["state"] = TO_RESOURCE
        h["target_resource"] = ruid
        self.move(uid, ruid)

    def drop_off(self, uid, suid):
        h = self.harv[uid]
        h["state"] = TO_STORAGE
        h["target_storage"] = suid
        self.move(uid, suid)

    def clear_transport(self, h):
        if h["transport_dest"] >= 0:
            d = h["transport_dest"]
            self.assigned[d] = max(0, self.assigned.get(d, 0) - 1)
        h["transport_dest"] = -1
        h["transport_src"] = -1
        h["res_name"] = None

    def transport_resource_for(self, h, suid):
        s = self.stor.get(suid)
        if s is None:
            return None
        for name in (h["priority"] or sorted(s["desired"])):
            if name in h["do_not_transport"]:
                continue
            if s["desired"].get(name, 0) > s["stored"].get(name, 0):
                return name
        return None

    def nearest_resource_named(self, uid, name):
        best, best_d = -1, np.inf
        for ruid, r in self.res.items():
            if r["name"] != name or r["amount"] <= 0 \
                    or ruid not in self.slots:
                continue
            d = self.dist(uid, ruid)
            if d < best_d:
                best, best_d = ruid, d
        return best

    def transport_source(self, uid, dest, name, strategy):
        if uid not in self.slots:
            return -1
        mine = self.faction(uid)
        domain = int(self.host["layer"][self.slots[uid]]) // NUM_FOOTPRINTS

        def eligible(suid, s, excess):
            if suid not in self.slots or suid == dest \
                    or self.faction(suid) != mine:
                return False
            if name in s["do_not_take"]:
                return False
            if s["do_not_take_land"] and domain == GROUND:
                return False
            if s["do_not_take_water"] and domain == WATER:
                return False
            b = self.bld.get(suid)
            if b is not None and b["state"] in (MARKED, FOUNDED):
                return False
            stored = s["stored"].get(name, 0)
            if stored <= 0 or s["capacity"].get(name, 0) <= 0:
                return False
            return not excess or stored > s["desired"].get(name, 0)

        anchor = dest if dest in self.slots else uid
        for excess in ((True, False) if strategy == EXCESS else (False,)):
            best, best_d = -1, np.inf
            for suid, s in self.stor.items():
                if not eligible(suid, s, excess):
                    continue
                d = self.dist(anchor, suid)
                if d < best_d:
                    best, best_d = suid, d
            if best >= 0:
                return best
        return -1

    def transport_resources(self, uid, suid) -> bool:
        h = self.harv[uid]
        name = self.transport_resource_for(h, suid)
        if name is None:
            return False
        if h["strategy"] == GATHERING:
            ruid = self.nearest_resource_named(uid, name)
            if ruid >= 0 and (h["gather_speeds"].get(name, 0) > 0
                              or h["max_carry"].get(name, 0) > 0):
                h["transport_dest"] = suid
                h["res_name"] = name
                self.assigned[suid] = self.assigned.get(suid, 0) + 1
                self.gather(uid, ruid)
                return True
        src = self.transport_source(uid, suid, name, h["strategy"])
        if src < 0:
            return False
        h["state"] = TRANSPORT_GETTING
        h["transport_dest"] = suid
        h["transport_src"] = src
        h["res_name"] = name
        self.assigned[suid] = self.assigned.get(suid, 0) + 1
        self.move(uid, src)
        return True

    def nearest_storage(self, uid, name):
        mine = self.faction(uid)
        best, best_d = -1, np.inf
        for suid, s in self.stor.items():
            if suid not in self.slots or self.faction(suid) != mine:
                continue
            if s["stored"].get(name, 0) >= s["capacity"].get(name, 0):
                continue
            d = self.dist(uid, suid)
            if d < best_d:
                best, best_d = suid, d
        return best

    def head_to_storage_or_idle(self, uid, h):
        names = [k for k, v in h["carried"].items() if v > 0]
        if h["transport_dest"] >= 0 and h["transport_dest"] in self.stor \
                and names:
            self.drop_off(uid, h["transport_dest"])
            return
        if names:
            suid = self.nearest_storage(uid, names[0])
            if suid >= 0:
                self.drop_off(uid, suid)
                return
        h["state"] = IDLE
        self.clear_transport(h)

    # -- the systems, in the tick's order ---------------------------------------

    def harvesters(self):
        for uid, h in self.harv.items():
            if uid not in self.slots:
                continue
            state = h["state"]
            if state == TO_RESOURCE:
                r = self.res.get(h["target_resource"])
                if r is None or r["amount"] <= 0:
                    h["state"] = IDLE
                elif self.near(uid, h["target_resource"]):
                    self.stop(uid)
                    h["state"] = HARVESTING
            elif state == HARVESTING:
                self.harvest(uid, h)
            elif state == TO_STORAGE:
                self.deliver(uid, h)
            elif state == TRANSPORT_GETTING:
                self.transport_getting(uid, h)

    def harvest(self, uid, h):
        ruid = h["target_resource"]
        r = self.res.get(ruid)
        if r is None or r["amount"] <= 0:
            self.head_to_storage_or_idle(uid, h)
            return
        name = r["name"]
        cap = h["max_carry"].get(name, DEFAULT_CARRY)
        take = int(min(h["gather_speeds"].get(name, DEFAULT_SPEED),
                       r["amount"], cap - h["carried"].get(name, 0)))
        r["amount"] -= take
        h["carried"][name] = h["carried"].get(name, 0) + take
        if r["amount"] <= 0 and not r["replenishable"]:
            del self.res[ruid]
            if ruid in self.slots:
                self.despawn(ruid)
        if h["carried"].get(name, 0) >= cap:
            self.head_to_storage_or_idle(uid, h)

    def deliver(self, uid, h):
        s = self.stor.get(h["target_storage"])
        if s is None:
            h["state"] = IDLE
            self.clear_transport(h)
            return
        if not self.near(uid, h["target_storage"]):
            return
        self.stop(uid)
        for name, amount in list(h["carried"].items()):
            room = s["capacity"].get(name, 0) - s["stored"].get(name, 0)
            put = max(0, min(room, amount))
            s["stored"][name] = s["stored"].get(name, 0) + put
            h["carried"][name] = amount - put
        h["carried"] = {k: v for k, v in h["carried"].items() if v > 0}
        if h["transport_dest"] >= 0:
            dest = h["transport_dest"]
            self.clear_transport(h)
            h["state"] = IDLE
            if self.transport_resource_for(h, dest) is not None:
                self.transport_resources(uid, dest)
        elif h["target_resource"] in self.res:
            self.gather(uid, h["target_resource"])
        else:
            h["state"] = IDLE

    def transport_getting(self, uid, h):
        src = self.stor.get(h["transport_src"])
        name = h["res_name"]
        if src is None or name is None or h["transport_dest"] not in self.stor:
            self.clear_transport(h)
            h["state"] = IDLE
            return
        if not self.near(uid, h["transport_src"]):
            return
        self.stop(uid)
        stored = src["stored"].get(name, 0)
        desired = src["desired"].get(name, 0)
        cap = h["max_carry"].get(name, DEFAULT_CARRY)
        room = cap - h["carried"].get(name, 0)
        if h["strategy"] == EXCESS:
            fresh = self.transport_source(uid, h["transport_dest"], name,
                                          EXCESS)
            if fresh == h["transport_src"] and stored <= desired:
                take = min(room, stored)
            else:
                take = max(min(room, stored - desired), 0)
        else:
            take = min(room, stored)
        src["stored"][name] = stored - take
        h["carried"][name] = h["carried"].get(name, 0) + take
        carried = h["carried"].get(name, 0)
        if carried < cap:
            nxt = self.transport_source(uid, h["transport_dest"], name,
                                        h["strategy"])
            if nxt >= 0 and nxt != h["transport_src"]:
                h["transport_src"] = nxt
                self.move(uid, nxt)
                return
        if carried == 0:
            self.clear_transport(h)
            h["state"] = IDLE
            return
        h["state"] = TO_STORAGE
        h["target_storage"] = h["transport_dest"]
        self.move(uid, h["transport_dest"])

    def builders(self):
        for uid, b in self.bldr.items():
            if b["target_building"] < 0 or uid not in self.slots:
                continue
            target = b["target_building"]
            bc = self.bld.get(target)
            if bc is None or bc["state"] == COMPLETED:
                b["target_building"] = -1
                b["building"] = False
                continue
            if not b["building"] and self.near(uid, target):
                self.stop(uid)
                b["building"] = True
            if b["building"] and bc["state"] == SUPPLIED:
                bc["progress"] = min(1.0, bc["progress"] + b["build_speed"])
                slot = self.slots[target]
                self.ops.append(("hp", target, float(np.float32(
                    float(self.max_hp[slot]) * bc["progress"]))))
                if bc["progress"] >= 1.0:
                    bc["state"] = COMPLETED
                    b["target_building"] = -1
                    b["building"] = False

    def automation(self):
        for uid, h in self.harv.items():
            if h["state"] != IDLE or uid not in self.slots:
                continue
            if h["transport_automated"] and self.transport_job(uid, h):
                continue
            if not h["automated"] or not self.res:
                continue
            allowed = set(h["gather_speeds"]) | set(h["max_carry"])
            best, best_d = -1, np.inf
            for ruid, r in self.res.items():
                if ruid not in self.slots or r["amount"] <= 0:
                    continue
                if allowed and r["name"] not in allowed:
                    continue
                d = self.dist(uid, ruid)
                if d < best_d:
                    best, best_d = ruid, d
            if best >= 0:
                self.gather(uid, best)

    def transport_job(self, uid, h) -> bool:
        mine = self.faction(uid)
        names = h["priority"] or sorted(
            {n for s in self.stor.values() for n in s["desired"]})
        for name in names:
            if name in h["do_not_transport"] \
                    or h["max_carry"].get(name, 0) <= 0:
                continue
            jobs = []
            for suid, s in self.stor.items():
                if suid not in self.slots or self.faction(suid) != mine:
                    continue
                if s["desired"].get(name, 0) <= s["stored"].get(name, 0):
                    continue
                d = self.dist(uid, suid)
                n = self.assigned.get(suid, 0)
                jobs.append((int(d / UNIT_COST_DISTANCE) + n, n, d, suid))
            jobs.sort()
            for *_, suid in jobs:
                if self.transport_resources(uid, suid):
                    return True
        return False

    def replenish(self):
        for r in self.res.values():
            if r["replenishable"] and r["amount"] < r["initial"]:
                r["amount"] = min(r["initial"],
                                  r["amount"] + r["replenish_amount"])


def tick(tables: dict, host: dict, slots: dict, max_hp, structures=()):
    """One economy tick (module docstring): (tables after, operations)."""
    t = _Tick(tables, host, slots, max_hp, structures)
    t.harvesters()
    t.builders()
    t.automation()
    t.replenish()
    return t.tables, t.ops
