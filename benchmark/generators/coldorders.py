"""The cold-orders generator: ``contact``'s frame traffic, with every order
sent to a place that no earlier order of the run targeted, so most of an
order's fields miss the nav service's field cache and are integrated
(kernel K2) and installed anew. A player's attack-moves, scouting and
expansion go to such places all over the map.

A traffic file with ``"generator": "coldorders"`` holds ``contact``'s
parameters; its ``orders`` hold ``side``, ``groups`` and
``period_frames``: side ``side``'s army split, from the seed, into
``groups`` control groups of one nav layer each (``contact``'s split),
and every ``period_frames`` frames the next group ordered, whole, to a
nav tile of its layer drawn from the seed among every passable tile of
the map. No tile is drawn twice in a run.
"""

from __future__ import annotations

import numpy as np

from benchmark import scene
from benchmark.generators import contact


class Cell(contact.Cell):
    """``contact.Cell`` with orders to fresh goals over the whole map."""

    def _plan_orders(self, o: dict) -> None:
        """The control groups, then for each layer they move on every
        passable nav tile in an order drawn from the seed."""
        from benchmark.reference.config import COST_IMPASSABLE

        self.groups = self._control_groups(o)
        cost = self._layer_costs()
        self.tiles: dict[str, np.ndarray] = {}
        self.next_tile: dict[str, int] = {}
        for arm in dict.fromkeys(a for a, _ in self.groups):
            rc = np.argwhere(cost[scene.arm_layer(arm)] != COST_IMPASSABLE)
            self.tiles[arm] = rc[self.rng.permutation(len(rc))]
            self.next_tile[arm] = 0
        self.used: set[tuple[int, int]] = set()

    def goal(self, arm: str):
        """The centre of the next tile of `arm`'s layer in the drawn order
        that no order of the run has had."""
        from benchmark.reference.config import NAV_TILE_SIZE

        tiles, i = self.tiles[arm], self.next_tile[arm]
        while i < len(tiles) and tuple(tiles[i]) in self.used:
            i += 1
        if i == len(tiles):
            raise RuntimeError(f"every passable tile of the {arm} layer "
                               "has had an order")
        self.next_tile[arm] = i + 1
        r, c = (int(x) for x in tiles[i])
        self.used.add((r, c))
        return np.array([(c + 0.5) * NAV_TILE_SIZE, (r + 0.5) * NAV_TILE_SIZE],
                        np.float32)
