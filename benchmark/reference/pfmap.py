"""PFMAP terrain data and its compilation to nav grids.

The benchmark's frozen copy of
``permafrost_engine_tpu_torch/assets/pfmap.py``, taken when the benchmark
was defined and kept as it was: part of the plain reference that
``benchmark/check.py`` holds the program against. It imports nothing of the
program and nothing of JAX.

The port's own copy of the parts of ``permafrost_engine_tpu/assets/pfmap.py``
the port uses: ``MapData``, ``make_flat_map`` and ``compile_nav_costs`` with
what they need, verbatim (numpy on the host). The parsed map is *compiled*
to the engine's arrays: per-layer nav cost grids at 2x tile resolution (the
reference's nav field resolution, nav_data.h:45) with footprint dilation,
plus a height field for terrain queries.

"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.config import (
    COST_IMPASSABLE,
    FOOTPRINTS,
    NUM_DOMAINS,
    NUM_FOOTPRINTS,
    TILES_PER_CHUNK,
)

HEIGHT_SCALE = 2.0  # world units per height unit

TILETYPE_FLAT = 0x0
RAMP_TYPES = (0x1, 0x2, 0x3, 0x4)
CORNER_TYPES = tuple(range(0x5, 0xD))


@dataclasses.dataclass
class MapData:
    chunks_r: int
    chunks_c: int
    materials: list[tuple[str, str]]          # (name, texture file)
    splats: list[tuple[int, int]]
    tile_type: np.ndarray                     # u8[TH, TW]
    base_height: np.ndarray                   # i8[TH, TW]
    ramp_height: np.ndarray                   # u8[TH, TW]
    top_mat: np.ndarray                       # i16[TH, TW]
    side_mat: np.ndarray                      # i16[TH, TW]
    pathable: np.ndarray                      # bool[TH, TW]
    no_bump: np.ndarray                       # bool[TH, TW]
    blend_normals: np.ndarray                 # bool[TH, TW]
    cover: np.ndarray                         # u8[TH, TW]
    edge_blend: np.ndarray                    # u8[TH, TW, 4] N/E/S/W modes

    @property
    def tiles_h(self) -> int:
        return self.chunks_r * TILES_PER_CHUNK

    @property
    def tiles_w(self) -> int:
        return self.chunks_c * TILES_PER_CHUNK


def _dilate_blocked(blocked: np.ndarray, k: int) -> np.ndarray:
    """Binary dilation with a k x k square (footprint erosion of passable
    space — a larger unit can't fit near obstacles)."""
    if k <= 1:
        return blocked
    h, w = blocked.shape
    pad = k // 2
    p = np.pad(blocked, pad, constant_values=True)
    out = np.zeros_like(blocked)
    for dr in range(k):
        for dc in range(k):
            out |= p[dr:dr + h, dc:dc + w]
    return out


def corner_heights(m: MapData):
    """Per-tile corner heights in height units: each corner is raised by
    ramp_height depending on the tile type — the exact corner tables of
    the reference (ref: src/map/tile.c:126-179 M_Tile_{NW,NE,SW,SE}Height).
    Returns (nw, ne, sw, se) f32[TH, TW]."""
    t = m.tile_type
    b = m.base_height.astype(np.float32)
    r = m.ramp_height.astype(np.float32)

    def raised(types):
        return np.isin(t, types).astype(np.float32)

    # type codes: RAMP_SN=1 NS=2 EW=3 WE=4; CORNER CONCAVE/CONVEX
    # SW=5/6 SE=7/8 NW=9/a NE=b/c (ref: tile.h:58-72)
    nw = b + r * raised((0x1, 0x3, 0x6, 0x7, 0x8, 0xc))
    ne = b + r * raised((0x1, 0x4, 0x5, 0x6, 0x8, 0xa))
    sw = b + r * raised((0x2, 0x3, 0x8, 0xa, 0xb, 0xc))
    se = b + r * raised((0x2, 0x4, 0x6, 0x9, 0xa, 0xc))
    return nw, ne, sw, se


def nav_heights(m: MapData) -> np.ndarray:
    """Heights at nav resolution (2x2 nav tiles per map tile), in height
    units: bilinear corner interpolation sampled at quadrant centers —
    ramps really slope instead of being flat at base height
    (ref: M_Tile_HeightAtPos, src/map/tile.c:249-259; corner tiles use
    triangle planes there, bilinear is a close interior approximation)."""
    nw, ne, sw, se = corner_heights(m)
    th, tw = nw.shape
    out = np.empty((2 * th, 2 * tw), np.float32)
    quads = {(0, 0): (0.25, 0.25), (0, 1): (0.75, 0.25),
             (1, 0): (0.25, 0.75), (1, 1): (0.75, 0.75)}
    for (qr, qc), (fw, fh) in quads.items():
        out[qr::2, qc::2] = (nw * (1 - fw) * (1 - fh) + ne * fw * (1 - fh)
                             + sw * (1 - fw) * fh + se * fw * fh)
    return out


def compile_nav_costs(m: MapData) -> tuple[np.ndarray, np.ndarray]:
    """MapData -> (cost_base u8[L, H, W], heights f32[H, W]) at nav
    resolution (2x2 nav tiles per map tile, ref: nav_data.h:45).

    Domains: GROUND passable on pathable land tiles; WATER on submerged
    tiles (base height < 0, matching M_Tile water queries); AIR everywhere.
    Footprint layers dilate the blocked set (ref: nav layer classification,
    nav.h:78-92). Ground cost carries a slope penalty so fields prefer flat
    routes over climbing ramp chains; cliffs steeper than MAX_CLIMB per
    tile are impassable outright (matching the reference, where only ramp
    tiles connect height levels).
    """
    land_ok = m.pathable & (m.base_height >= 0)
    water_ok = m.base_height < 0

    # upsample to nav resolution; heights are ramp-interpolated
    up = lambda a: np.repeat(np.repeat(a, 2, axis=0), 2, axis=1)
    land_ok = up(land_ok)
    water_ok = up(water_ok)
    hu = nav_heights(m)
    heights = hu * HEIGHT_SCALE
    is_ramp = up(np.isin(m.tile_type, RAMP_TYPES + CORNER_TYPES))

    # per-tile height steps to 4-neighbours (in height units)
    step = np.zeros_like(hu)
    dr = np.abs(np.diff(hu, axis=0))
    dc = np.abs(np.diff(hu, axis=1))
    # a height step burdens BOTH adjacent tiles
    step[1:, :] = np.maximum(step[1:, :], dr)
    step[:-1, :] = np.maximum(step[:-1, :], dr)
    step[:, 1:] = np.maximum(step[:, 1:], dc)
    step[:, :-1] = np.maximum(step[:, :-1], dc)
    MAX_CLIMB = 2.0  # height units per nav tile crossable without a ramp
    cliff = (step > MAX_CLIMB) & ~is_ramp

    slope_cost = np.clip(1 + step.astype(np.int32), 1, 8).astype(np.uint8)

    h, w = land_ok.shape
    num_layers = NUM_DOMAINS * NUM_FOOTPRINTS
    cost = np.ones((num_layers, h, w), np.uint8)
    domain_blocked = {
        0: ~land_ok | cliff,     # GROUND
        1: ~water_ok,            # WATER
        2: np.zeros_like(land_ok),  # AIR
    }
    for d in range(NUM_DOMAINS):
        for fi, k in enumerate(FOOTPRINTS):
            layer = d * NUM_FOOTPRINTS + fi
            if d == 0:
                cost[layer] = slope_cost
            blocked = _dilate_blocked(domain_blocked[d], k)
            cost[layer][blocked] = COST_IMPASSABLE
    return cost, heights


def make_flat_map(chunks_r: int, chunks_c: int, num_materials: int = 1) -> MapData:
    """Programmatic all-flat map (tests, default engine world)."""
    th, tw = chunks_r * TILES_PER_CHUNK, chunks_c * TILES_PER_CHUNK
    return MapData(
        chunks_r=chunks_r, chunks_c=chunks_c,
        materials=[(f"mat{i}", f"mat{i}.png") for i in range(num_materials)],
        splats=[],
        tile_type=np.zeros((th, tw), np.uint8),
        base_height=np.zeros((th, tw), np.int8),
        ramp_height=np.zeros((th, tw), np.uint8),
        top_mat=np.zeros((th, tw), np.int16),
        side_mat=np.zeros((th, tw), np.int16),
        pathable=np.ones((th, tw), bool),
        no_bump=np.zeros((th, tw), bool),
        blend_normals=np.zeros((th, tw), bool),
        cover=np.zeros((th, tw), np.uint8),
        edge_blend=np.zeros((th, tw, 4), np.uint8),
    )
