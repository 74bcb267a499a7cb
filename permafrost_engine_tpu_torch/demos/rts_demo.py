"""Mini RTS scenario driven entirely through the ``pf`` scripting API.

Port of ``demos/rts_demo.py``, the analogue of the reference's
scripts/rts/main.py demo: two factions, a worker economy, a fight, a save
and load, and a frame dump. Runs on the card; ``--cpu`` asks for the CPU.
Sessions and the frame go to a temporary directory.

Run: ``python -m permafrost_engine_tpu_torch.demos.rts_demo``
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

CONFIG = dict(max_ents=256, chunks_r=2, chunks_c=2, num_layers=12,
              max_flocks=16, max_projectiles=64, field_slab_slots=32,
              los_slab_slots=32)


def setup(pf) -> dict:
    """The demo's world on an initialised `pf` (this port's, or any module
    with its API): factions at war, a worker economy, six knights, six
    grunts, a tower and two scouts ordered to garrison it. Returns the
    pieces by name; ``deaths`` collects the death events."""
    ctx = pf.context()
    ctx.engine.economy_period = 3

    humans = pf.add_faction("Humans", (0, 0, 255))
    orcs = pf.add_faction("Orcs", (255, 0, 0), controllable=False)
    pf.set_diplomacy_state(humans, orcs, pf.DIPLOMACY_STATE_WAR)

    # --- economy ------------------------------------------------------------
    tree = pf.ResourceEntity("tree.pfobj", "tree", pos=(150, 0, 100),
                             resource_name="Wood", resource_amount=50,
                             faction_id=humans)
    hut = pf.StorageSiteEntity("hut.pfobj", "hut", pos=(100, 0, 140),
                               faction_id=humans)
    hut.set_capacity("Wood", 200)
    worker = pf.HarvesterEntity("w.pfobj", "peon", pos=(100, 0, 100),
                                speed=100.0, faction_id=humans)
    worker.set_gather_speed("Wood", 4)
    worker.set_max_carry("Wood", 8)
    worker.gather(tree)

    # --- armies --------------------------------------------------------------
    class Knight(pf.MovableEntity, pf.CombatableEntity):
        """Unit classes compose mixins, like the reference's script classes."""

    knights = [Knight("k.pfobj", f"knight{i}",
                      pos=(80 + 6 * i, 0, 200), speed=60.0,
                      faction_id=humans, base_dmg=20.0, hp=150.0)
               for i in range(6)]
    grunts = [pf.CombatableEntity("g.pfobj", f"grunt{i}",
                                  pos=(300 + 6 * i, 0, 300),
                                  faction_id=orcs, hp=80.0, base_dmg=5.0)
              for i in range(6)]

    deaths = []
    pf.register_event_handler(pf.EVENT_ENTITY_DEATH, deaths.append)

    # --- garrison mission: scouts ride a transport to the front -------------
    tower = pf.GarrisonableEntity("t.pfobj", "tower", pos=(260, 0, 200),
                                  faction_id=humans, garrison_capacity=4)
    scouts = [pf.GarrisonEntity("s.pfobj", f"scout{i}",
                                pos=(60 + 6 * i, 0, 240), speed=80.0,
                                faction_id=humans)
              for i in range(2)]
    # garrison() is move-then-enter: False with a move order while far,
    # True once adjacent; the script drives the mission each second
    for s in scouts:
        s.garrison(tower)
    return dict(humans=humans, worker=worker, knights=knights, grunts=grunts,
                tower=tower, scouts=scouts, deaths=deaths)


def main(argv=None) -> dict:
    """Runs the demo; returns its dumped frame and its count of deaths."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from permafrost_engine_tpu_torch.core.config import EngineConfig
    from permafrost_engine_tpu_torch.script import pf

    with tempfile.TemporaryDirectory(prefix="rts_demo_") as tmp:
        pf.init(EngineConfig(**CONFIG), basedir=tmp,
                device="cpu" if args.cpu else "cuda")
        w = setup(pf)
        humans, grunts, tower = w["humans"], w["grunts"], w["tower"]
        deaths = w["deaths"]
        pending = list(w["scouts"])

        pf.move_in_formation(w["knights"], (300, 0, 280), pf.FORMATION_RANK)
        pf.step(120)

        # --- save MID-MARCH (formation flock live), reload, keep fighting ---
        assert pf.save_session("rts_demo_mid.bin")
        assert pf.load_session("rts_demo_mid.bin")
        # load_session rebuilds the script layer from the blob alone: the
        # pre-save handler lives on inside the restored layer, bound to the
        # restored list. This harness runs outside it, so it registers its
        # own list again to keep observing deaths.
        pf.register_event_handler(pf.EVENT_ENTITY_DEATH, deaths.append)

        for second in range(30):
            pf.step(60)
            pending = [s for s in pending if not s.garrison(tower)]
            wood = pf.get_resource_stored(humans, "Wood")
            orc_alive = sum(0 if g.zombie else (1 if g.hp > 0 else 0)
                            for g in grunts)
            if second % 5 == 4:
                print(f"t={second + 1:2d}s wood={wood:3d} "
                      f"orcs_alive={orc_alive} deaths={len(deaths)}")
            if orc_alive == 0 and wood >= 16:
                break

        assert pf.get_resource_stored(humans, "Wood") >= 16, "economy failed"
        assert any(d["uid"] in [g.uid for g in grunts] for d in deaths), \
            "no orcs died"
        garrisoned = tower.garrisoned_units
        assert len(garrisoned) == 2, f"garrison failed: {garrisoned}"

        # --- session + presentation -----------------------------------------
        assert pf.save_session("rts_demo_save.bin")
        assert pf.load_session("rts_demo_save.bin")
        frame_path = os.path.join(tmp, "rts_demo_frame.npy")
        assert pf.dump_framebuffer(frame_path)
        img = np.load(frame_path)
        print(f"frame: {img.shape}, {img.max()} max value")
        print(f"nav stats: {pf.get_nav_perfstats()}")
        print("RTS DEMO COMPLETE")
        return dict(frame=img, deaths=len(deaths))


if __name__ == "__main__":
    main()
