"""Battle-map generator: a 4x4-chunk map with walls, a river, a cliff
plateau with ramp cuts, and choke points — the obstacle world the port's
battle runs on (``chip_smoke.py``).

The port's own copy of ``tools/mapgen.py`` (``make_battle_map``, verbatim,
over the port's ``assets/pfmap.py``).

The reference's defining workload is crowds navigating AROUND things
(ref: src/navigation/nav.c:1774-2047 hierarchical path requests,
src/game/movement.c:4312-4413 movement under terrain). The flat default map
leaves the nav stack idle; this map makes A*, portal graphs, field caches,
chokepoint crowding and height-aware shadowcast fog all hot.

Layout (map tiles, 128x128 at 8 world units/tile; armies spawn in the
flat west [x<350] and east [x>690] zones and march into each other):

  x tiles 44-45   wall (unpathable) with two 7-tile gates
  x tiles 56-60   river (water domain) with two land bridges
  x tiles 66-80   +4 plateau: cliff edges, two gradual ramp cuts
"""

from __future__ import annotations

from permafrost_engine_tpu_torch.assets.pfmap import MapData, make_flat_map


def make_battle_map(chunks: int = 4) -> MapData:
    m = make_flat_map(chunks, chunks)
    s = m.tiles_w / 128.0   # scale for non-4x4 sizes

    def cols(a, b):
        return slice(int(a * s), int(b * s))

    def rows(a, b):
        return slice(int(a * s), int(b * s))

    # ---- west wall with two gates (choke points) -------------------------
    # gates/bridges are ~10-12 tiles (80-96 world units): wide enough for
    # a 5000-unit army to stream through without a permanent jam, narrow
    # enough that A*, portals and choke crowding stay hot
    m.pathable[rows(4, 124), cols(44, 46)] = False
    m.pathable[rows(28, 38), cols(44, 46)] = True    # north gate
    m.pathable[rows(88, 98), cols(44, 46)] = True    # south gate

    # ---- river with two bridges (water layers live here) -----------------
    m.base_height[rows(0, 128), cols(56, 61)] = -2
    m.base_height[rows(36, 48), cols(56, 61)] = 0    # north bridge
    m.base_height[rows(80, 92), cols(56, 61)] = 0    # south bridge

    # ---- plateau with cliff edges and two ramp cuts ----------------------
    m.base_height[rows(10, 118), cols(66, 81)] = 4
    # gradual ramp cuts: height climbs 1 unit per map tile across the cut
    for i, c in enumerate(range(int(66 * s), int(70 * s))):
        h = min(4, i + 1)
        m.base_height[rows(36, 48), c] = h
        m.base_height[rows(78, 90), c] = h
    for i, c in enumerate(range(int(77 * s), int(81 * s))):
        h = max(0, 3 - i)
        m.base_height[rows(36, 48), c] = h
        m.base_height[rows(78, 90), c] = h

    return m
