"""The battles the benchmark runs: the map, the armies, their standing
orders and the reinforcement waves.

The builders are the benchmark's frozen copies of
``permafrost_engine_tpu_torch/bench.py``'s (``spawn_block``,
``battle_engine``, ``spawn_armies``, ``order_armies``, ``GOALS``) and of ``assets/mapgen.make_battle_map``, so a later change to
the program cannot move the scene. Everything that varies comes from a
configuration file (``benchmark/configs/<name>.json``) and the run's seed:
the spawn jitter is drawn from ``numpy.random.default_rng(seed)``.

The program sees only what it is handed: the map data, the spawn columns
and the orders, through the public ``Engine`` calls.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.config import (
    CombatState,
    DiplomacyState,
    EntityFlags,
    NavDomain,
    footprint_for_radius,
    nav_layer,
)
from benchmark.reference.pfmap import MapData, make_flat_map

# each army's goal: side a marches to side b's start, side b to side a's
GOALS = ((820.0, 512.0), (200.0, 512.0))
# the navies' and the air squadrons' goals, by side
NAVY_GOALS = ((468.0, 620.0), (468.0, 404.0))
AIR_GOALS = ((900.0, 512.0), (140.0, 512.0))
# where each arm spawns, by side: (x0, z0, files, dx, dz)
ARM_BLOCKS = {
    "inf": ((200.0, 212.0, 25, 4.0, 3.0), (820.0, 212.0, 25, 4.0, 3.0)),
    "siege": ((160.0, 380.0, 8, 7.0, 7.0), (930.0, 380.0, 8, 7.0, 7.0)),
    "navy": ((452.0, 400.0, 8, 4.0, 3.0), (452.0, 560.0, 8, 4.0, 3.0)),
    "air": ((120.0, 420.0, 16, 4.0, 3.0), (880.0, 420.0, 16, 4.0, 3.0)),
}
# each arm's unit columns (``Engine.spawn_batch`` keywords); the infantry's
# ranged share is drawn per unit
ARM_UNITS = {
    "siege": dict(radius=2.5, max_speed=10.0, is_ranged=True,
                  attack_range=50.0, base_dmg=30.0, vision_range=90.0,
                  hp=400.0),
    "navy": dict(domain=NavDomain.WATER, radius=1.5, max_speed=24.0,
                 is_ranged=True, attack_range=45.0, base_dmg=15.0,
                 vision_range=90.0, hp=300.0),
    "air": dict(domain=NavDomain.AIR, radius=1.2, max_speed=32.0,
                is_ranged=True, attack_range=30.0, vision_range=100.0,
                hp=150.0),
}


def make_battle_map(chunks: int = 4) -> MapData:
    """The 4x4-chunk battle map: a walled ridge with two gates, a river
    with two bridges and a plateau with two ramp cuts."""
    m = make_flat_map(chunks, chunks)
    s = m.tiles_w / 128.0   # scale for non-4x4 sizes

    def span(a, b):
        return slice(int(a * s), int(b * s))

    m.pathable[span(4, 124), span(44, 46)] = False
    m.pathable[span(28, 38), span(44, 46)] = True    # north gate
    m.pathable[span(88, 98), span(44, 46)] = True    # south gate
    m.base_height[span(0, 128), span(56, 61)] = -2   # the river
    m.base_height[span(36, 48), span(56, 61)] = 0    # north bridge
    m.base_height[span(80, 92), span(56, 61)] = 0    # south bridge
    m.base_height[span(10, 118), span(66, 81)] = 4   # the plateau
    for i, c in enumerate(range(int(66 * s), int(70 * s))):
        h = min(4, i + 1)
        m.base_height[span(36, 48), c] = h
        m.base_height[span(78, 90), c] = h
    for i, c in enumerate(range(int(77 * s), int(81 * s))):
        h = max(0, 3 - i)
        m.base_height[span(36, 48), c] = h
        m.base_height[span(78, 90), c] = h
    return m


def spawn_block(rng, x0: float, z0: float, n: int, files: int,
                dx: float = 4.0, dz: float = 3.0) -> np.ndarray:
    """`n` spawn positions from (x0, z0): `files` columns dx apart, rows dz
    apart, each position jittered by up to half a unit from `rng`."""
    fx = (np.arange(n) % files) * dx
    fz = (np.arange(n) // files) * dz
    x = x0 + fx + (rng.random(n) - 0.5)
    z = z0 + fz + (rng.random(n) - 0.5)
    return np.stack([x, z], 1).astype(np.float32)


def arm_counts(conf: dict, n: int) -> dict:
    """How `n` units of a side split over the configuration's arms (the
    shares of ``conf["arms"]``, the remainder to the infantry)."""
    shares = conf["arms"]
    out = {arm: int(n * share) for arm, share in shares.items()
           if arm != "inf"}
    out["inf"] = n - sum(out.values())
    return out


def build_engine(conf: dict, device, map_data):
    """The battle's engine before the spawns: the configuration's capacity,
    the map if the configuration has terrain, two factions at war, both
    kernels built (``Engine.prewarm_nav``)."""
    from permafrost_engine_tpu_torch.core.config import EngineConfig
    from permafrost_engine_tpu_torch.game.engine import Engine

    eng = Engine(EngineConfig(**conf["engine"]), device=device)
    if map_data is not None:
        eng.load_map_data(map_data)
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, int(DiplomacyState.WAR))
    eng.prewarm_nav()
    return eng


def spawn_arm(eng, rng, conf: dict, side: int, arm: str,
              n: int) -> list[int]:
    """Spawn `n` units of `arm` for `side` at the arm's spawn block;
    returns their uids. The infantry is melee with the configuration's
    ranged share of archers (the first ones melee, as the bench spawns)."""
    if n <= 0:
        return []
    x0, z0, files, dx, dz = ARM_BLOCKS[arm][side]
    pos = spawn_block(rng, x0, z0, n, files, dx, dz)
    if arm == "inf":
        if conf["full"]:
            ranged = np.arange(n) >= n - int(round(n * conf["archer_share"]))
        else:
            ranged = rng.random(n) < conf["archer_share"]
        return eng.spawn_batch(
            pos, faction=side, max_speed=20.0, is_ranged=ranged,
            attack_range=np.where(ranged, 40.0, 5.0), vision_range=80.0,
            hp=200.0)
    kw = dict(ARM_UNITS[arm])
    return eng.spawn_batch(pos, faction=side, **kw)


def spawn_armies(eng, rng, conf: dict) -> list[dict]:
    """Both armies, each a dict of uids by arm. The flat battle draws side
    a's block, then side b's; the full battle each side's arms in turn
    (infantry, siege, navy, air), as the bench draws them."""
    n = conf["n_per_side"]
    counts = arm_counts(conf, n)
    if not conf["full"]:
        ranged = rng.random(n) < conf["archer_share"]
        sides = []
        for side in (0, 1):
            x0, z0, files, dx, dz = ARM_BLOCKS["inf"][side]
            pos = spawn_block(rng, x0, z0, n, files, dx, dz)
            sides.append({"inf": eng.spawn_batch(
                pos, faction=side, max_speed=20.0, is_ranged=ranged,
                attack_range=np.where(ranged, 40.0, 5.0), vision_range=80.0,
                hp=200.0)})
        return sides
    return [{arm: spawn_arm(eng, rng, conf, side, arm, counts[arm])
             for arm in ("inf", "siege", "navy", "air")}
            for side in (0, 1)]


def order_armies(eng, sides: list, full: bool) -> list:
    """The battle's orders, in the bench's order: each army to the other's
    side (with `full`, the corps of infantry and siege in RANK formation,
    the navies across the mid reach, the air squadrons over the map).
    Returns each order's result."""
    if not full:
        return [eng.move(sides[0]["inf"], GOALS[0]),
                eng.move(sides[1]["inf"], GOALS[1])]
    from permafrost_engine_tpu_torch.game.formation import FormationType

    a, b = sides
    return [
        eng.move_in_formation(a["inf"] + a["siege"], GOALS[0],
                              FormationType.RANK),
        eng.move_in_formation(b["inf"] + b["siege"], GOALS[1],
                              FormationType.RANK),
        eng.move(a["navy"], NAVY_GOALS[0]), eng.move(b["navy"], NAVY_GOALS[1]),
        eng.move(a["air"], AIR_GOALS[0]), eng.move(b["air"], AIR_GOALS[1])]


def standing_orders(eng, side: int, arms: dict) -> list:
    """A reinforcement's standing order, by arm: the ground units
    (infantry and siege) to the other side's start, the navy across the
    river's mid reach, the air squadrons over the map. Returns each
    order's result."""
    ground = arms.get("inf", []) + arms.get("siege", [])
    out = []
    if ground:
        out.append(eng.move(ground, GOALS[side]))
    if arms.get("navy"):
        out.append(eng.move(arms["navy"], NAVY_GOALS[side]))
    if arms.get("air"):
        out.append(eng.move(arms["air"], AIR_GOALS[side]))
    return out


def arm_layer(arm: str) -> int:
    """The nav layer of an arm's units."""
    kw = ARM_UNITS.get(arm, {})
    domain = kw.get("domain", NavDomain.GROUND)
    return nav_layer(domain, footprint_for_radius(kw.get("radius", 1.0)))


def living(eng, uids: list[int]) -> set[int]:
    """The units of `uids` that are alive and not corpses."""
    uids = [u for u in uids if u in eng.uid_to_slot]
    if not uids:
        return set()
    h = eng.ents_host("alive", "combatstate")
    slots = np.array([eng.uid_to_slot[u] for u in uids], np.int64)
    live = h["alive"][slots] & (h["combatstate"][slots]
                                != int(CombatState.CORPSE))
    return {u for u, ok in zip(uids, live) if ok}


def alive_by_side(eng) -> np.ndarray:
    """Units of each side that are alive and not corpses."""
    h = eng.ents_host("alive", "faction", "combatstate", "flags")
    live = (h["alive"] & (h["combatstate"] != int(CombatState.CORPSE))
            & ((h["flags"] & int(EntityFlags.MOVABLE)) != 0))
    return np.array([int((live & (h["faction"] == s)).sum()) for s in (0, 1)])
