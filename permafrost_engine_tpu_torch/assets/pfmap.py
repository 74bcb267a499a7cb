"""PFMAP terrain data and its compilation to nav grids.

The port's own copy of the parts of ``permafrost_engine_tpu/assets/pfmap.py``
the port uses: ``MapData``, ``make_flat_map`` and ``compile_nav_costs`` with
what they need, verbatim (numpy on the host). The parsed map is *compiled*
to the engine's arrays: per-layer nav cost grids at 2x tile resolution (the
reference's nav field resolution, nav_data.h:45) with footprint dilation,
plus a height field for terrain queries.

The PFMAP text format too (ref: docs/pfmap.txt v1.2): ``parse_pfmap`` (the
header, material and splat lists, then 32x32-tile chunks of 24-character
tile records, parsed in Python) and ``write_pfmap``, for ``pf.load_map``
and ``pf.load_map_string``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from permafrost_engine_tpu_torch.core.config import (
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


class PFMapError(ValueError):
    pass


def parse_pfmap(text: str) -> MapData:
    all_lines = text.splitlines()
    cursor = [0]

    def lines():
        while cursor[0] < len(all_lines):
            ln = all_lines[cursor[0]]
            cursor[0] += 1
            yield ln
    lines = lines()

    def next_line():
        for ln in lines:
            ln = ln.strip()
            if ln:
                return ln
        raise PFMapError("unexpected end of file")

    def header(key):
        ln = next_line().split()
        if ln[0] != key:
            raise PFMapError(f"expected '{key}', got {ln[0]!r}")
        return ln[1]

    version = float(header("version"))
    num_materials = int(header("num_materials"))
    num_splats = int(header("num_splats")) if version >= 1.1 else 0
    num_rows = int(header("num_rows"))
    num_cols = int(header("num_cols"))

    materials = []
    for _ in range(num_materials):
        parts = next_line().split()
        if parts[0] != "material":
            raise PFMapError(f"bad material line: {parts}")
        materials.append((parts[1], parts[2]))

    splats = []
    for _ in range(num_splats):
        parts = next_line().split()
        if parts[0] != "splat":
            raise PFMapError(f"bad splat line: {parts}")
        splats.append((int(parts[1]), int(parts[2])))

    th, tw = num_rows * TILES_PER_CHUNK, num_cols * TILES_PER_CHUNK
    tile_type = np.zeros((th, tw), np.uint8)
    base_height = np.zeros((th, tw), np.int8)
    ramp_height = np.zeros((th, tw), np.uint8)
    top_mat = np.zeros((th, tw), np.int16)
    side_mat = np.zeros((th, tw), np.int16)
    pathable = np.zeros((th, tw), bool)
    no_bump = np.zeros((th, tw), bool)
    blend_normals = np.zeros((th, tw), bool)
    cover = np.zeros((th, tw), np.uint8)
    edge_blend = np.zeros((th, tw, 4), np.uint8)

    # chunks in row-major order; tiles row-major within a chunk. Linear
    # file index -> global (r, c):
    total = num_rows * num_cols * TILES_PER_CHUNK * TILES_PER_CHUNK
    idx = np.arange(total)
    chunk = idx // (TILES_PER_CHUNK * TILES_PER_CHUNK)
    within = idx % (TILES_PER_CHUNK * TILES_PER_CHUNK)
    rr = (chunk // num_cols) * TILES_PER_CHUNK + within // TILES_PER_CHUNK
    cc_ = (chunk % num_cols) * TILES_PER_CHUNK + within % TILES_PER_CHUNK

    toks = "\n".join(all_lines[cursor[0]:]).split()
    if len(toks) < total:
        raise PFMapError(f"expected {total} tiles, found {len(toks)}")
    for i in range(total):
        t = toks[i]
        if len(t) != 24:
            raise PFMapError(f"tile record must be 24 chars, got {t!r}")
        r, c = rr[i], cc_[i]
        tile_type[r, c] = int(t[0], 16)
        sign = -1 if t[1] == "-" else 1
        base_height[r, c] = sign * int(t[2:4])
        ramp_height[r, c] = int(t[4:6])
        top_mat[r, c] = int(t[6:9])
        side_mat[r, c] = int(t[9:12])
        pathable[r, c] = t[12] == "1"
        blend_normals[r, c] = t[14] == "1"
        no_bump[r, c] = t[15] == "1"
        cover[r, c] = int(t[16])
        edge_blend[r, c] = [int(ch) for ch in t[17:21]]

    return MapData(
        chunks_r=num_rows, chunks_c=num_cols, materials=materials,
        splats=splats, tile_type=tile_type, base_height=base_height,
        ramp_height=ramp_height, top_mat=top_mat, side_mat=side_mat,
        pathable=pathable, no_bump=no_bump, blend_normals=blend_normals,
        cover=cover, edge_blend=edge_blend)


def write_pfmap(m: MapData) -> str:
    """Serialize MapData back to PFMAP text (editor support)."""
    out = [f"version 1.2",
           f"num_materials {len(m.materials)}",
           f"num_splats {len(m.splats)}",
           f"num_rows {m.chunks_r}",
           f"num_cols {m.chunks_c}"]
    for name, tex in m.materials:
        out.append(f"material {name} {tex}")
    for a, b in m.splats:
        out.append(f"splat {a} {b}")
    for cr in range(m.chunks_r):
        for cc in range(m.chunks_c):
            for tr in range(TILES_PER_CHUNK):
                row = []
                for tc in range(TILES_PER_CHUNK):
                    r = cr * TILES_PER_CHUNK + tr
                    c = cc * TILES_PER_CHUNK + tc
                    h = int(m.base_height[r, c])
                    rec = (
                        f"{int(m.tile_type[r, c]):X}"
                        f"{'-' if h < 0 else '+'}{abs(h):02d}"
                        f"{int(m.ramp_height[r, c]):02d}"
                        f"{int(m.top_mat[r, c]):03d}"
                        f"{int(m.side_mat[r, c]):03d}"
                        f"{1 if m.pathable[r, c] else 0}0"
                        f"{1 if m.blend_normals[r, c] else 0}"
                        f"{1 if m.no_bump[r, c] else 0}"
                        f"{int(m.cover[r, c])}"
                        + "".join(str(int(x)) for x in m.edge_blend[r, c])
                        + "000")
                    row.append(rec)
                # first tile of each chunk row starts a new line (spec 3.3)
                out.append(" ".join(row[:10]))
                for j in range(10, len(row), 10):
                    out.append(" ".join(row[j:j + 10]))
    return "\n".join(out) + "\n"



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
