"""The drop generator: ``contact``'s frame traffic, with six buildings
dropped at the battle map's choke points mid-battle and lifted again, as
walls, towers and gates go up and come down in a player's game. Each drop
and each lift cuts the buildings' footprints into (or out of) the nav map:
the cost push, the portal relink of the dirty chunks, the field
invalidation and the replans of every flock whose path crosses them
(``Engine._commit_nav``).

The buildings are ``permafrost_engine_tpu_torch/bench.py``'s
``place_midfight_structures`` ones, copied here (``SPOTS``) because that
function spawns and stamps at once; here they are spawned in
``prepare()`` without footprints. A traffic file with ``"generator":
"drop"`` holds ``contact``'s parameters and ``drops``: before every
``period_frames``-th frame the living buildings are dropped together, and
``lift_after_frames`` frames after each drop lifted together. The
generator commits at once (``Engine._commit_nav``, which ``Engine.step``
would otherwise run first thing), before the frame's call, so the state
each recorded call is handed already holds the commit; after the recorded
frames every footprint is lifted, so ``map_differ`` holds the nav costs
against the map's own compilation. No number of the generator's own: the
stamped costs and the replans a commit makes are not compared with a
reference.
"""

from __future__ import annotations

import numpy as np

from benchmark.generators import contact
from benchmark.structures import lift_structures
from benchmark.reference.config import EntityFlags

# bench.place_midfight_structures: the six choke points, radius 10
SPOTS = ((356.0, 280.0), (356.0, 744.0), (470.0, 330.0), (470.0, 700.0),
         (590.0, 512.0), (420.0, 512.0))
RADIUS = 10.0
FLAGS = int(EntityFlags.COLLISION | EntityFlags.BUILDING)


class Cell(contact.Cell):
    """``contact.Cell`` with the choke buildings dropped and lifted."""

    def prepare(self) -> None:
        super().prepare()
        self.walls = self.eng.spawn_batch(
            np.asarray(SPOTS, np.float32), faction=0, radius=RADIUS,
            flags=FLAGS, max_speed=0.0, hp=1000.0)
        self.drops = self.lifts = 0

    def _stamp(self, blocking: bool) -> None:
        eng = self.eng
        for u in self.walls:
            if u in eng.uid_to_slot:
                eng.set_structure_blocking(u, blocking)
        eng._commit_nav()

    def before_call(self, n: int) -> None:
        super().before_call(n)
        d = self.traffic["drops"]
        phase = self.frame % d["period_frames"]
        if phase == 0:
            self._stamp(True)
            self.drops += 1
        elif phase == d["lift_after_frames"]:
            self._stamp(False)
            self.lifts += 1

    def record(self, frames: int, rec) -> None:
        super().record(frames, rec)
        lift_structures(self.eng)
