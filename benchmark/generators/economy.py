"""The economy generator: upstream's RTS match (``scripts/rts/main.py``)
beside the battle. Each team's players hold bases at the map's start
locations on the team's side: a storage site with gold and gas nodes around it and workers that
gather and carry to it, handed to the engine's idle-worker automation;
each player's builder is given a new building to found every so often.
The economy runs inside the engine's own frame loop (``Economy.tick`` at
``Engine.economy_period``), one ``Engine.move`` a worker trip, while the
armies fight as ``contact`` has them.

The configuration file's ``economy`` block sizes the match:
``players_per_team``, ``bases_per_player``, per base ``gold_nodes`` of
``gold_amount`` and ``gas_nodes`` of ``gas_amount``, ``gold_workers`` and
``gas_workers``, ``builders_per_player``; ``worker`` (``speed``,
``gather``, ``carry``), ``building`` (``radius``, ``hp``, ``gold``, its
cost) and the map's geometry: the start locations (``base_x``, from each
team's own edge of the map, by ``base_z``) that each base is jittered
from by up to ``base_jitter``, ``node_distance``, and
``building_distance``, the range of distances from the base's storage at
which a building is marked). A traffic file with ``"generator": "economy"`` holds
``contact``'s parameters, with ``orders`` null (the player gives none: the
economy's, the builders' and the waves' are the orders), and ``builds``:
every ``period_frames`` frames each player's builder is given a new
building, marked at a passable spot near the player's first base drawn
from the seed. The generator plays the game script's part: when a builder
has reached its building (the builder's state says so after an economy
tick), it founds the building, which cuts its footprint out of the nav
map, and supplies it at once; the generator commits the cut
(``Engine._commit_nav``) in the same frame, after the engine's call, so
that it falls inside the recorded call whose comparison leaves out what
replans rewrite. The stamped costs and the replans themselves are not
compared with a reference.

The check (``check.verify``): ``EconomyRecorder`` copies each economy
tick's tables, the host columns it read and the orders it gave, and
``judge_extra`` runs ``benchmark/reference/economy.py`` from each copy:
``resources_differ`` (nodes' amounts, storages' stock, harvesters'
loads), ``harvester_states_differ`` (harvesters' states and targets, the
transport counts, builders' targets), ``economy_orders_differ`` (the
moves with their goals, the stops, the despawns and footprint lifts, and
the entity rows whose host columns, ``ECONOMY_COLUMNS``, differ from the
reference tick's with the reference economy's orders applied) and
``building_progress_gap`` (the largest gap of a building's progress, from
its table and from its hit points over their maximum; infinite where a
building's state differs).
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import enum
import math

import numpy as np
import torch

from benchmark import check, scene
from benchmark.generators import contact
from benchmark.structures import lift_structures
from benchmark.reference.config import (
    COST_IMPASSABLE,
    NAV_TILE_SIZE,
    EntityFlags,
    MoveState,
)

# the entity columns an economy tick writes on the host: an order's
# (``Engine.move``: dest, formation_cell, flock, movestate,
# has_formation_cell; ``Engine.stop``: movestate, vel, flock), a builder's
# hit points, a despawn's alive
ECONOMY_COLUMNS = ("dest", "flock", "movestate", "vel", "hp",
                   "formation_cell", "has_formation_cell", "alive")
# of those, what a replan (the nav cadence's, a founding's commit) writes
REPLAN_COLUMNS = contact.HOST_COLUMNS
TABLES = ("resources", "harvesters", "storages", "buildings", "builders")
WORKER_FLAGS = int(EntityFlags.COLLISION | EntityFlags.MOVABLE
                   | EntityFlags.SELECTABLE | EntityFlags.HARVESTER)
BUILDER_FLAGS = int(EntityFlags.COLLISION | EntityFlags.MOVABLE
                    | EntityFlags.SELECTABLE | EntityFlags.BUILDER)
NODE_FLAGS = int(EntityFlags.COLLISION | EntityFlags.SELECTABLE
                 | EntityFlags.RESOURCE)
STORAGE_FLAGS = int(EntityFlags.COLLISION | EntityFlags.SELECTABLE
                    | EntityFlags.BUILDING | EntityFlags.STORAGE_SITE)
BUILDING_FLAGS = int(EntityFlags.COLLISION | EntityFlags.SELECTABLE
                     | EntityFlags.BUILDING)
NODE_RADIUS, STORAGE_RADIUS, WORKER_RADIUS = 2.0, 4.0, 1.0


def plain(comp) -> dict:
    """A component as a plain record: its fields, enums as ints, copied."""
    out = {}
    for f in dataclasses.fields(comp):
        v = getattr(comp, f.name)
        out[f.name] = int(v) if isinstance(v, enum.IntEnum) \
            else copy.deepcopy(v)
    return out


def tables_of(eco) -> dict:
    """The economy's component tables as plain records (the reference's
    form), and its transport counts."""
    out = {name: {int(uid): plain(c) for uid, c in getattr(eco, name).items()}
           for name in TABLES}
    out["transport_assigned"] = {int(k): int(v) for k, v
                                 in eco._transport_assigned.items()}
    return out


class EconomyRecorder(check._Patches):
    """While entered, copies each ``Economy.tick``: the tables before and
    after, the host columns the tick read, the uid -> slot map, the
    ``max_hp`` column, the footprints cut into the nav map, and the
    engine calls the tick made (``move``, ``stop``, ``despawn`` and
    ``set_structure_blocking``), each with the index of the recorded call
    of the timed path it falls in (``segments``, the ``check.Recorder``'s
    list). The wrappers only copy and pass every call on unchanged."""

    def __init__(self):
        super().__init__()
        self.ticks: list = []
        self.segments: list = []

    def __enter__(self):
        from permafrost_engine_tpu_torch.game import economy

        rec = self

        def wrap(orig):
            def tick(eco):
                e = eco.engine
                entry = {"seg": len(rec.segments),
                         "before": tables_of(eco),
                         "slots": dict(e.uid_to_slot),
                         "structures": set(e._structures),
                         "max_hp": e.ents_host("max_hp")["max_hp"].copy(),
                         "calls": [], "host": None}
                calls = entry["calls"]

                def spy(name, note):
                    bound = getattr(e, name)

                    def call(*args, **kw):
                        out = bound(*args, **kw)
                        if note is not None:
                            calls.append(note(*args, **kw))
                        return out
                    setattr(e, name, call)

                def host(*names):
                    out = type(e).ents_host(e, *names)
                    if entry["host"] is None:
                        entry["host"] = {k: v.copy() for k, v in out.items()}
                    return out

                spy("move", lambda uids, goal: (
                    "move", *map(int, uids),
                    tuple(float(x) for x in goal)))
                spy("stop", lambda uids: ("stop", *map(int, uids)))
                spy("despawn", lambda uid: ("despawn", int(uid)))
                spy("set_structure_blocking", lambda uid, blocking=True: (
                    ("stamp" if blocking else "unstamp"), int(uid)))
                e.ents_host = host
                try:
                    orig(eco)
                finally:
                    for name in ("move", "stop", "despawn",
                                 "set_structure_blocking", "ents_host"):
                        e.__dict__.pop(name, None)
                entry["after"] = tables_of(eco)
                rec.ticks.append(entry)
            return tick

        self._patch(economy.Economy, "tick", wrap)
        return self


class Cell(contact.Cell):
    """``contact.Cell`` with the economy match beside the battle."""

    def prepare(self) -> None:
        super().prepare()
        self._spawn_bases()
        self.next_build = self.frame
        self.pending: dict[int, int] = {}     # building uid -> builder uid
        self.founded_frames: set[int] = set()
        self.founded = 0
        self.eco_rec = None

    # -- the bases ----------------------------------------------------------------

    def _ground_cost(self) -> np.ndarray:
        return self._layer_costs()[0]

    def _passable(self, xz: np.ndarray, cost: np.ndarray) -> bool:
        """Every point of `xz` lies on a passable ground tile."""
        t = np.floor(np.asarray(xz, np.float64) / NAV_TILE_SIZE).astype(int)
        h, w = cost.shape
        if (t < 0).any() or (t[:, 0] >= w).any() or (t[:, 1] >= h).any():
            return False
        return bool((cost[t[:, 1], t[:, 0]] != COST_IMPASSABLE).all())

    def _army_boxes(self, reach: float) -> list:
        """The armies' spawn blocks, grown by `reach`: no base is laid
        there, since every wave spawns into them."""
        n = self.conf["n_per_side"]
        counts = (scene.arm_counts(self.conf, n) if self.conf["full"]
                  else {"inf": n})
        out = []
        for arm, k in counts.items():
            for x0, z0, files, dx, dz in scene.ARM_BLOCKS[arm] if k else ():
                rows = math.ceil(k / files)
                out.append((x0 - reach, z0 - reach,
                            x0 + files * dx + reach, z0 + rows * dz + reach))
        return out

    def _base_layout(self, centre, angle: float) -> dict:
        """A base's storage, nodes and workers' spawn points around
        `centre`: the gold nodes on an arc of 150 degrees from `angle`,
        the gas nodes opposite, each node's workers 40% of the way from
        the storage to it."""
        ec = self.conf["economy"]
        r = ec["node_distance"]
        ng, nx = ec["gold_nodes"], ec["gas_nodes"]
        arc = np.radians(150.0)
        a_gold = angle + (np.arange(ng) - (ng - 1) / 2.0) * (
            arc / max(ng - 1, 1))
        a_gas = angle + np.pi + (np.arange(nx) - (nx - 1) / 2.0) * \
            np.radians(60.0) / max(nx - 1, 1)
        c = np.asarray(centre, np.float64)

        def ring(a, dist):
            return c + dist * np.stack([np.cos(a), np.sin(a)], 1)

        gold, gas = ring(a_gold, r), ring(a_gas, r * 1.1)
        per_gold = np.repeat(np.arange(ng), -(-ec["gold_workers"] // ng)
                             )[:ec["gold_workers"]]
        per_gas = np.repeat(np.arange(nx), -(-ec["gas_workers"] // nx)
                            )[:ec["gas_workers"]]
        return {"storage": c[None], "gold": gold, "gas": gas,
                "builder": c[None] + [[0.0, 2.0 * STORAGE_RADIUS]],
                "gold_workers": c + 0.4 * (gold[per_gold] - c),
                "gas_workers": c + 0.4 * (gas[per_gas] - c)}

    def _spawn_bases(self) -> None:
        """Each team's bases at the map's start locations (the
        configuration's ``base_x`` and ``base_z``), each jittered by up to
        ``base_jitter`` from the seed onto passable ground clear of the
        armies' spawn blocks; then their entities and components, the
        workers idle and automated."""
        from permafrost_engine_tpu_torch.game.economy import (
            BuilderComp, HarvesterComp, ResourceComp, StorageComp)

        eng, ec, rng = self.eng, self.conf["economy"], self.rng
        eco = eng.economy
        cost = self._ground_cost()
        world_w = cost.shape[1] * NAV_TILE_SIZE
        reach = ec["node_distance"] * 1.1 + 2.0 * NODE_RADIUS
        boxes = self._army_boxes(reach)
        # the map's start locations: team 0's measured from the west edge,
        # team 1's mirrored from the east, one per (row, column) pair
        starts = [(x, z) for z in ec["base_z"] for x in ec["base_x"]]
        n_bases = ec["players_per_team"] * ec["bases_per_player"]
        if len(starts) != n_bases:
            raise ValueError(f"{len(starts)} start locations for {n_bases} "
                             "bases a team")
        jit = ec["base_jitter"]
        w = ec["worker"]
        self.players: list = []                # (team, builder uid, centre)
        self.sites = []                        # storages and nodes, for spacing
        for team in (0, 1):
            for b, (x, z) in enumerate(starts):
                cx = x if team == 0 else world_w - x
                for _ in range(256):
                    centre = np.array([cx + rng.uniform(-jit, jit),
                                       z + rng.uniform(-jit, jit)])
                    angle = rng.uniform(0.0, 2.0 * np.pi)
                    lay = self._base_layout(centre, angle)
                    pts = np.concatenate([v for v in lay.values()])
                    clear = not any(
                        bx0 < centre[0] < bx1 and bz0 < centre[1] < bz1
                        for bx0, bz0, bx1, bz1 in boxes)
                    if clear and self._passable(pts, cost):
                        break
                else:
                    raise RuntimeError(f"no room for base {b} of team {team}")
                self.sites.extend(np.concatenate([lay["storage"], lay["gold"],
                                                  lay["gas"]]))
                s = eng.spawn_batch(lay["storage"].astype(np.float32),
                                    faction=team, radius=STORAGE_RADIUS,
                                    flags=STORAGE_FLAGS, max_speed=0.0,
                                    hp=1500.0)[0]
                eco.storages[s] = StorageComp(
                    capacity={"gold": 1 << 30, "gas": 1 << 30},
                    stored={"gold": 0, "gas": 0})
                for name, amount in (("gold", ec["gold_amount"]),
                                     ("gas", ec["gas_amount"])):
                    for u in eng.spawn_batch(
                            lay[name].astype(np.float32), faction=team,
                            radius=NODE_RADIUS, flags=NODE_FLAGS,
                            max_speed=0.0, hp=1.0):
                        eco.resources[u] = ResourceComp(name, amount, amount)
                    for u in eng.spawn_batch(
                            lay[f"{name}_workers"].astype(np.float32),
                            faction=team, radius=WORKER_RADIUS,
                            flags=WORKER_FLAGS, max_speed=w["speed"],
                            hp=40.0):
                        eco.harvesters[u] = HarvesterComp(
                            gather_speeds={name: w["gather"]},
                            max_carry={name: w["carry"]})
                if b % ec["bases_per_player"] == 0:
                    for u in eng.spawn_batch(
                            lay["builder"].astype(np.float32).repeat(
                                ec["builders_per_player"], 0),
                            faction=team, radius=WORKER_RADIUS,
                            flags=BUILDER_FLAGS, max_speed=w["speed"],
                            hp=40.0):
                        eco.builders[u] = BuilderComp()
                        self.players.append((team, u, centre))
        self.split["workers"] = len(eco.harvesters)
        self.split["builders"] = len(eco.builders)

    # -- the builders ------------------------------------------------------------------

    def _building_spot(self, centre, cost) -> np.ndarray:
        """A passable spot near a base, from the seed: at a distance in
        ``building_distance`` from its storage, clear of every storage,
        node and earlier building."""
        ec = self.conf["economy"]
        lo, hi = ec["building_distance"]
        rad = ec["building"]["radius"]
        sites = np.asarray(self.sites)
        for _ in range(256):
            a = self.rng.uniform(0.0, 2.0 * np.pi)
            d = self.rng.uniform(lo, hi)
            p = np.asarray(centre) + d * np.array([np.cos(a), np.sin(a)])
            corners = p + rad * np.array([[-1, -1], [-1, 1], [1, -1], [1, 1],
                                          [0, 0]])
            if not self._passable(corners, cost):
                continue
            if np.min(np.linalg.norm(sites - p, axis=1)) < 2.0 * rad + 8.0:
                continue
            return p.astype(np.float32)
        raise RuntimeError("no room for a building")

    def _give_buildings(self) -> None:
        """Each player's builder is given a new building, marked near the
        player's first base."""
        from permafrost_engine_tpu_torch.game.economy import BuildingComp

        eng, ec = self.eng, self.conf["economy"]
        b = ec["building"]
        cost = self._ground_cost()
        for team, builder, centre in self.players:
            if builder not in eng.uid_to_slot:
                continue
            spot = self._building_spot(centre, cost)
            uid = eng.spawn_batch(spot[None], faction=team,
                                  radius=b["radius"], flags=BUILDING_FLAGS,
                                  max_speed=0.0, hp=b["hp"])[0]
            self.sites.append(spot)
            eng.economy.buildings[uid] = BuildingComp(
                required={"gold": b["gold"]})
            eng.economy.build(builder, uid)
            self.pending[uid] = builder

    def _found_arrived(self) -> None:
        """The script's part after an economy tick: found and supply each
        marked building whose builder has reached it, then commit the
        footprints' cut before the next tick."""
        from permafrost_engine_tpu_torch.game.economy import BuildingState

        eco = self.eng.economy
        done, founded = [], self.founded
        for uid, builder in self.pending.items():
            bc, bd = eco.buildings.get(uid), eco.builders.get(builder)
            if bc is None or bd is None or bd.target_building != uid:
                done.append(uid)
                continue
            if bd.building and bc.state == BuildingState.MARKED:
                eco.found_building(uid)
                for name, amount in bc.required.items():
                    eco.supply_building(uid, name, amount)
                done.append(uid)
                self.founded += 1
        for uid in done:
            del self.pending[uid]
        if self.founded > founded:
            self.eng._commit_nav()
            self.founded_frames.add(self.frame)

    def before_call(self, n: int) -> None:
        super().before_call(n)
        if self.frame >= self.next_build:
            self._give_buildings()
            self.next_build += self.traffic["builds"]["period_frames"]

    def after_call(self, n: int) -> None:
        super().after_call(n)
        if self.frame % self.eng.economy_period == 0:
            self._found_arrived()

    # -- the window ----------------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        out = super().window(seconds)
        c, eco = out["counters"], self.eng.economy
        print("economy: " + str({
            "ticks": c.get("economy.n", 0), "moves": c.get("economy.moves", 0),
            "stops": c.get("economy.stops", 0),
            "order_ms_mean": (c.get("order.ms", 0.0) / c["order.n"]
                              if c.get("order.n") else None),
            "commits": c.get("nav.commit.n", 0),
            "flocks_peak": self.eng.counters.get("flocks.peak"),
            "flock_reclaims": c.get("flocks.reclaims", 0),
            "founded": self.founded,
            "stored": sum(sum(s.stored.values())
                          for s in eco.storages.values())}), flush=True)
        return out

    # -- the check -------------------------------------------------------------------------

    def recorders(self) -> list:
        self.eco_rec = EconomyRecorder()
        return [self.eco_rec]

    def record(self, frames: int, rec) -> None:
        """``contact.Cell.record``; then every founded building's
        footprint is lifted and the lift committed, outside the recorded
        calls, so that ``map_differ`` holds the nav costs the stamps and
        lifts leave against the map's own compilation."""
        if self.eco_rec is not None:
            self.eco_rec.segments = rec.segments
        self.record_start = self.frame
        self.cadence_period = self.eng.seek_refresh_period
        super().record(frames, rec)
        lift_structures(self.eng)

    def host_columns(self, n: int) -> tuple:
        cols = super().host_columns(n)
        if self.frame % self.eng.economy_period == 0:
            return tuple(dict.fromkeys(cols + ECONOMY_COLUMNS))
        return cols

    def judge_extra(self, device) -> dict:
        from benchmark.reference import economy as ref_eco

        rec = self.eco_rec
        if rec is None or not rec.ticks:
            return {}
        ref = check.Reference(self.conf, self.map_data, device)
        out = {"resources_differ": 0, "harvester_states_differ": 0,
               "economy_orders_differ": 0, "building_progress_gap": 0.0}
        for t in rec.ticks:
            want, ops = ref_eco.tick(t["before"], t["host"], t["slots"],
                                     t["max_hp"], t["structures"])
            _tables(t["after"], want, out)
            got = collections.Counter(t["calls"])
            exp = collections.Counter(_as_call(op) for op in ops
                                      if op[0] != "hp")
            out["economy_orders_differ"] += sum(((got - exp) + (exp - got))
                                                .values())
            if t["seg"] < len(rec.segments):
                before, n, after, _ = rec.segments[t["seg"]]
                frame_ref = ref.run(before, n)
                replanned = self._replanned(t["seg"])
                bad, gap = _rows(after.ents, frame_ref.ents, ops, t["slots"],
                                 t["max_hp"], replanned)
                out["economy_orders_differ"] += bad
                out["building_progress_gap"] = max(
                    out["building_progress_gap"], gap)
        return out

    def _replanned(self, seg: int) -> bool:
        """Whether a replan may have rewritten rows during recorded call
        `seg` (one frame a call): a nav cadence or a founding's commit ran
        in it."""
        frame = self.record_start + seg + 1
        return (frame % self.cadence_period == 0
                or frame in self.founded_frames)


def _as_call(op) -> tuple:
    """A reference operation as the recorder notes the program's call."""
    if op[0] == "move":
        return ("move", int(op[1]), tuple(float(x) for x in op[2]))
    return (op[0], int(op[1]))


def _tables(got: dict, want: dict, out: dict) -> None:
    """Add the table numbers of one tick to `out`."""
    def load(h):
        return h.get("carried", {})

    for table, field in (("resources", None), ("storages", "stored")):
        g, w = got[table], want[table]
        for uid in set(g) | set(w):
            a, b = g.get(uid), w.get(uid)
            if a is None or b is None:
                out["resources_differ"] += 1
            elif (a if field is None else a[field]) != \
                    (b if field is None else b[field]):
                out["resources_differ"] += 1
    gh, wh = got["harvesters"], want["harvesters"]
    for uid in set(gh) | set(wh):
        a, b = gh.get(uid), wh.get(uid)
        if a is None or b is None:
            out["resources_differ"] += 1
            out["harvester_states_differ"] += 1
            continue
        out["resources_differ"] += load(a) != load(b)
        out["harvester_states_differ"] += (
            {k: v for k, v in a.items() if k != "carried"}
            != {k: v for k, v in b.items() if k != "carried"})
    ta, tb = got["transport_assigned"], want["transport_assigned"]
    out["harvester_states_differ"] += sum(
        ta.get(k, 0) != tb.get(k, 0) for k in set(ta) | set(tb))
    gb, wb = got["builders"], want["builders"]
    out["harvester_states_differ"] += sum(
        gb.get(k) != wb.get(k) for k in set(gb) | set(wb))
    gap = out["building_progress_gap"]
    for uid in set(got["buildings"]) | set(want["buildings"]):
        a, b = got["buildings"].get(uid), want["buildings"].get(uid)
        if a is None or b is None or {k: v for k, v in a.items()
                                      if k != "progress"} != \
                {k: v for k, v in b.items() if k != "progress"}:
            gap = math.inf
        else:
            gap = max(gap, abs(a["progress"] - b["progress"]))
    out["building_progress_gap"] = gap


def _rows(got, want, ops, slots, max_hp, replanned: bool
          ) -> tuple[int, float]:
    """The entity rows of an economy frame whose ``ECONOMY_COLUMNS``
    differ from the reference tick's (`want`) with the reference
    economy's operations applied, and the largest gap of a building's hit
    points over their maximum. A moved row's flock is the engine's
    allocation, not the economy's, and is not compared; on a frame with a
    replan no row's ``REPLAN_COLUMNS`` are."""
    exp = {k: getattr(want, k).clone() for k in ECONOMY_COLUMNS}
    moved = torch.zeros_like(exp["alive"])
    hp_rows = []
    for op in ops:
        kind, uid = op[0], op[1]
        if kind not in ("move", "stop", "despawn", "hp"):
            continue
        s = slots[uid]
        if kind == "move":
            g = torch.tensor(op[2], dtype=torch.float32)
            exp["dest"][s] = g
            exp["formation_cell"][s] = g
            exp["movestate"][s] = int(MoveState.MOVING)
            exp["has_formation_cell"][s] = False
            moved[s] = True
        elif kind == "stop":
            exp["movestate"][s] = int(MoveState.ARRIVED)
            exp["vel"][s] = 0.0
            exp["flock"][s] = -1
            moved[s] = False
        elif kind == "despawn":
            exp["alive"][s] = False
        else:
            exp["hp"][s] = op[2]
            hp_rows.append(s)
    bad = torch.zeros_like(moved)
    for k in ECONOMY_COLUMNS:
        if replanned and k in REPLAN_COLUMNS:
            continue
        a, b = getattr(got, k), exp[k]
        eq = a == b
        if a.is_floating_point():
            eq = eq | (torch.isnan(a) & torch.isnan(b))
        row = ~eq.reshape(eq.shape[0], -1).all(1)
        if k == "flock":
            row = row & ~moved
        bad |= row
    gap = 0.0
    for s in hp_rows:
        gap = max(gap, abs(float(got.hp[s]) - float(exp["hp"][s]))
                  / float(max_hp[s]))
    return int(bad.sum()), gap
