"""Campaign scenario: a fuller game script over the ``pf`` API.

Port of ``demos/campaign.py``, the depth check for SURVEY layer 8 (the
analogue of the reference's scripts/rts campaign): base building, an
economy loop, population, stances, patrol tasks, region triggers, a staged
assault in formation, and victory detection. Runs on the card; ``--cpu``
asks for the CPU. The mid-assault session goes to a temporary directory.

Run: ``python -m permafrost_engine_tpu_torch.demos.campaign``
"""

from __future__ import annotations

import argparse
import tempfile

CONFIG = dict(max_ents=512, chunks_r=2, chunks_c=2, num_layers=12,
              max_flocks=16, max_projectiles=128, field_slab_slots=32,
              los_slab_slots=32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from permafrost_engine_tpu_torch.core.config import EngineConfig
    from permafrost_engine_tpu_torch.script import pf

    with tempfile.TemporaryDirectory(prefix="campaign_") as tmp:
        pf.init(EngineConfig(**CONFIG), basedir=tmp,
                device="cpu" if args.cpu else "cuda")
        return _play(pf)


def _play(pf) -> dict:
    ctx = pf.context()
    ctx.engine.economy_period = 3
    ctx.engine.seek_refresh_period = 12

    player = pf.add_faction("Player", (0, 90, 255))
    enemy = pf.add_faction("Raiders", (255, 40, 40), controllable=False)
    pf.set_diplomacy_state(player, enemy, pf.DIPLOMACY_STATE_WAR)

    # ---- stage 1: build the base ----------------------------------------
    trees = [pf.ResourceEntity("tree.pfobj", f"tree{i}",
                               pos=(140 + 14 * i, 0, 90),
                               resource_name="Wood", resource_amount=60,
                               faction_id=player) for i in range(3)]
    camp = pf.StorageSiteEntity("camp.pfobj", "camp", pos=(100, 0, 140),
                                faction_id=player)
    camp.set_capacity("Wood", 500)

    workers = [pf.HarvesterEntity("w.pfobj", f"peon{i}",
                                  pos=(90 + 8 * i, 0, 110), speed=90.0,
                                  faction_id=player) for i in range(3)]
    for w in workers:
        w.set_gather_speed("Wood", 5)
        w.set_max_carry("Wood", 10)
        w.gather(trees[0])

    class Barracks(pf.BuildableEntity, pf.PopulationLimitContributorEntity):
        required_resources = {"Wood": 30}

    barracks = Barracks("b.pfobj", "barracks", pos=(170, 0, 170),
                        faction_id=player)
    barracks.found()           # cuts its footprint into nav (dirty chunks)
    builder = pf.BuilderEntity("bl.pfobj", "builder", pos=(120, 0, 150),
                               speed=90.0, faction_id=player)

    # ---- stage 2: defenders on patrol (pf.Task) + a hold-position line ---
    class Soldier(pf.MovableEntity, pf.CombatableEntity,
                  pf.PopulationContributorEntity):
        pass

    guards = [Soldier("s.pfobj", f"guard{i}", pos=(150 + 8 * i, 0, 200),
                      speed=70.0, faction_id=player, base_dmg=18.0,
                      hp=160.0, attack_range=8.0)
              for i in range(4)]
    for g in guards[:2]:
        g.stance = pf.COMBAT_STANCE_HOLD_POSITION

    waypoints = [(120, 0, 220), (220, 0, 220)]

    class PatrolTask(pf.Task):
        """Waypoint patrol (the reference's task-driven unit AI; effect()
        discipline keeps it replayable across session loads)."""

        def __run__(self):
            ent = self._args[0]
            i = 0
            while not ent.zombie:
                self.effect(ent.move, waypoints[i % 2])
                i += 1
                yield self.sleep(90)

    PatrolTask(guards[2])

    # region trigger: units entering the base perimeter raise an alarm
    pf.Region("perimeter", (150.0, 0.0, 180.0), radius=120.0)
    alarms = []
    pf.register_event_handler(
        pf.EVENT_REGION_ENTERED,
        lambda a: alarms.append(a) if a.get("region") == "perimeter" else None)

    # ---- raiders --------------------------------------------------------
    raiders = [pf.CombatableEntity("r.pfobj", f"raider{i}",
                                   pos=(420 + 8 * i, 0, 420),
                                   faction_id=enemy, hp=90.0, base_dmg=8.0,
                                   is_ranged=(i % 3 == 0),
                                   attack_range=30.0 if i % 3 == 0 else 6.0)
               for i in range(8)]

    deaths = []
    pf.register_event_handler(pf.EVENT_ENTITY_DEATH, deaths.append)

    # ---- run the economy until the barracks can be supplied + built ------
    supplied = False
    for build_s in range(60):
        pf.step(60)
        wood = pf.get_resource_stored(player, "Wood")
        if not supplied and wood >= 30:
            # deliver the stored wood into the construction site and put
            # the builder on it (the completion happens over economy
            # ticks while the builder works, BuildingState SUPPLIED ->
            # COMPLETED)
            camp._sc.stored["Wood"] -= 30
            barracks.supply("Wood", 30)
            builder.build(barracks)
            supplied = True
        if supplied and barracks.completed:
            break
    assert barracks.completed, "barracks never completed"
    assert pf.get_population_limit(player) > 0, "pop limit not contributed"
    assert pf.get_population(player) >= 4, "soldiers not counted"

    # ---- stage 3: the assault, in RANK formation ------------------------
    army = [Soldier("a.pfobj", f"atk{i}",
                    pos=(100 + 10 * (i % 6), 0, 240 + 10 * (i // 6)),
                    speed=70.0, faction_id=player, base_dmg=20.0, hp=150.0)
            for i in range(12)]
    pf.move_in_formation(army, (430, 0, 430), pf.FORMATION_RANK)
    assert pf.save_session("campaign_mid.bin")
    assert pf.load_session("campaign_mid.bin")

    won = False
    for assault_s in range(60):
        pf.step(60)
        raiders_alive = sum(0 if r.zombie else (1 if r.hp > 0 else 0)
                            for r in raiders)
        if raiders_alive == 0:
            won = True
            break
    assert won, "raiders survived the assault"
    survivors = sum(0 if a.zombie else (1 if a.hp > 0 else 0) for a in army)
    print(f"victory: raiders eliminated, {survivors}/12 attackers "
          f"survive, {len(deaths)} total deaths, "
          f"alarm events: {len(alarms)}")
    print(f"population {pf.get_population(player)}"
          f"/{pf.get_population_limit(player)}, "
          f"wood stored {pf.get_resource_stored(player, 'Wood')}")
    print("CAMPAIGN COMPLETE")
    return dict(build_s=build_s + 1, assault_s=assault_s + 1,
                survivors=survivors, deaths=len(deaths), alarms=len(alarms),
                population=pf.get_population(player),
                population_limit=pf.get_population_limit(player),
                wood=pf.get_resource_stored(player, "Wood"))


if __name__ == "__main__":
    main()
