"""Debug-visualization overlays, gated on the `pf.debug.*` settings.

The reference treats these overlays as its primary debugging instrument:
flow/LOS/enemy-seek/arrival fields, islands, portals and blockers
(ref: src/navigation/nav.c:2520-3320), HRVO cones
(ref: src/game/clearpath.c:420), formation cells
(ref: src/game/formation.c:1378) and region outlines
(ref: src/game/region.c:459) are drawn straight into the 3D view.

Here each overlay is a pure *extractor* producing world-space geometry
(arrow segments, tile tints, outlines) from engine state, plus one shared
projector/rasterizer that composites the primitives onto a rendered
frame. Extractors are plain NumPy over host mirrors / fetched state — this
is a debug path, synchronous fetches are acceptable — and are unit-tested
at the geometry level (tests/test_debug_overlays.py).

Port of ``permafrost_engine_tpu/render/debug_overlays.py``: the same
extractors and rasterizer. The entity columns come from the frame's one
``Engine.ents_host`` copy (`host`, taken here when the caller passes
none); the other tables are copied to the host when their overlay is on
(the flock table in one ``Engine.host_copies`` call). The nav service's
island labels are int64 on the host where the JAX package's are int32:
they are cast before they index the palette.
"""

from __future__ import annotations

import numpy as np

from permafrost_engine_tpu_torch.core.config import (
    CHUNK_SIZE_UNITS,
    FIELD_RES,
    FLOW_DIR_OFFSETS,
    NAV_TILE_SIZE,
    FogState,
)

# primitive = ("line", x0, y0, x1, y1, rgb) | ("dot", x, y, half, rgb)
# in *screen* pixels after projection; extractors emit world-space floats.

COL_FLOW = (255, 255, 255)
COL_LOS = (90, 220, 90)
COL_SEEK = (255, 120, 60)
COL_ARRIVAL = (120, 160, 255)
COL_PORTAL = (255, 230, 60)
COL_PORTAL_LINK = (200, 160, 30)
COL_BLOCKER = (255, 80, 40)
COL_COST = (190, 40, 40)
COL_CHUNK = (40, 40, 40)
COL_HRVO = (255, 60, 220)
COL_FORMATION = (80, 230, 230)
COL_REGION = (240, 240, 100)
COL_RANGE = (230, 60, 60)
COL_TARGET = (255, 0, 0)
COL_VISION = (250, 250, 160)
_ISLAND_PALETTE = np.array(
    [(66, 135, 245), (245, 160, 66), (66, 245, 150), (245, 66, 120),
     (180, 120, 245), (245, 230, 66), (66, 230, 245), (150, 245, 66)],
    np.uint8)

_DIR_VECS = np.array([(float(dc), float(dr)) for dr, dc in FLOW_DIR_OFFSETS],
                     np.float32)  # index by FlowDir code -> (dx, dz) tiles


# ---------------------------------------------------------------------------
# extractors (world-space, pure, unit-tested)
# ---------------------------------------------------------------------------

def flow_arrows(flow_codes: np.ndarray, origin_xz: tuple[float, float],
                tile: float = NAV_TILE_SIZE, decimate: int = 2,
                scale: float = 0.8):
    """Flow-field codes -> arrow segments.

    Returns (starts f32[M,2], vecs f32[M,2]) in world XZ: one arrow per
    `decimate`-th tile with a non-FD_NONE code, pointing along the decoded
    direction (ref: nav.c flow overlay draws one line per tile).
    """
    h, w = flow_codes.shape
    rr, cc = np.meshgrid(np.arange(0, h, decimate), np.arange(0, w, decimate),
                         indexing="ij")
    codes = flow_codes[rr, cc].astype(np.int32)
    on = codes > 0
    rr, cc, codes = rr[on], cc[on], codes[on]
    starts = np.stack([origin_xz[0] + (cc + 0.5) * tile,
                       origin_xz[1] + (rr + 0.5) * tile], -1).astype(np.float32)
    vecs = _DIR_VECS[codes] * (tile * scale)
    return starts, vecs


def tile_mask_points(mask: np.ndarray, origin_xz=(0.0, 0.0),
                     tile: float = NAV_TILE_SIZE, decimate: int = 1):
    """Boolean tile mask -> tile-centre points f32[M,2] (world XZ)."""
    m = mask[::decimate, ::decimate]
    rr, cc = np.nonzero(m)
    rr, cc = rr * decimate, cc * decimate
    return np.stack([origin_xz[0] + (cc + 0.5) * tile,
                     origin_xz[1] + (rr + 0.5) * tile], -1).astype(np.float32)


def island_points(islands: np.ndarray, passable: np.ndarray,
                  tile: float = NAV_TILE_SIZE, decimate: int = 2):
    """Island ids -> (points f32[M,2], colors u8[M,3]) colored by id."""
    ids = islands[::decimate, ::decimate]
    ok = passable[::decimate, ::decimate] & (ids >= 0)
    rr, cc = np.nonzero(ok)
    cols = _ISLAND_PALETTE[ids[rr, cc] % len(_ISLAND_PALETTE)]
    pts = np.stack([(cc * decimate + 0.5) * tile,
                    (rr * decimate + 0.5) * tile], -1).astype(np.float32)
    return pts, cols


def portal_segments(graph) -> tuple[np.ndarray, np.ndarray]:
    """PortalGraph -> (span segments f32[P,2,2], link segments f32[E,2,2]).

    Span segments run along each portal's tile run on the chunk border;
    link segments join paired portal midpoints (ref: nav.c portal overlay).
    """
    spans, mids = [], {}
    for p in graph.portals:
        cr, cc = p.chunk
        ox = cc * CHUNK_SIZE_UNITS
        oz = cr * CHUNK_SIZE_UNITS
        t = NAV_TILE_SIZE
        lo, hi = p.lo, p.hi + 1
        if p.side == "N":
            a = (ox + lo * t, oz)
            b = (ox + hi * t, oz)
        elif p.side == "S":
            a = (ox + lo * t, oz + FIELD_RES * t)
            b = (ox + hi * t, oz + FIELD_RES * t)
        elif p.side == "W":
            a = (ox, oz + lo * t)
            b = (ox, oz + hi * t)
        else:  # E
            a = (ox + FIELD_RES * t, oz + lo * t)
            b = (ox + FIELD_RES * t, oz + hi * t)
        spans.append((a, b))
        mids[p.pid] = ((a[0] + b[0]) / 2, (a[1] + b[1]) / 2)
    links = []
    for p in graph.portals:
        if p.paired >= 0 and p.pid < p.paired and p.paired in mids:
            links.append((mids[p.pid], mids[p.paired]))
    return (np.asarray(spans, np.float32).reshape(-1, 2, 2),
            np.asarray(links, np.float32).reshape(-1, 2, 2))


def hrvo_cones(pos: np.ndarray, vel: np.ndarray, radius: np.ndarray,
               i: int, neigh: np.ndarray, leg_len: float = 24.0):
    """HRVO cone geometry for entity `i` vs each neighbour index.

    Mirrors the solver's construction (ops/clearpath.py: RVO apex
    = (v_i + v_j)/2, legs = p_hat rotated by +/- asin(combR/dist)).
    Returns dict with apex f32[K,2] (world offset from pos_i is velocity
    space; drawn anchored at pos_i), legs_l/legs_r f32[K,2] unit leg
    directions (ref: src/game/clearpath.c:130-247 + debug draw :420).
    """
    rel = pos[neigh] - pos[i]                       # [K,2]
    dist = np.maximum(np.linalg.norm(rel, axis=-1), 1e-6)
    comb_r = (radius[i] + radius[neigh]) * 1.05
    p_hat = rel / dist[:, None]
    sin_t = np.clip(comb_r / dist, 0.0, 1.0)
    cos_t = np.sqrt(np.maximum(1.0 - sin_t**2, 0.0))
    legs_l = np.stack([cos_t * p_hat[:, 0] - sin_t * p_hat[:, 1],
                       sin_t * p_hat[:, 0] + cos_t * p_hat[:, 1]], -1)
    legs_r = np.stack([cos_t * p_hat[:, 0] + sin_t * p_hat[:, 1],
                       -sin_t * p_hat[:, 0] + cos_t * p_hat[:, 1]], -1)
    apex = (vel[i][None] + vel[neigh]) / 2.0
    return {"apex": apex.astype(np.float32),
            "legs_l": (legs_l * leg_len).astype(np.float32),
            "legs_r": (legs_r * leg_len).astype(np.float32),
            "sin_t": sin_t.astype(np.float32)}


def circle_points(center_xz, radius: float, segs: int = 24) -> np.ndarray:
    a = np.linspace(0, 2 * np.pi, segs + 1)
    return np.stack([center_xz[0] + radius * np.cos(a),
                     center_xz[1] + radius * np.sin(a)], -1).astype(np.float32)


def region_outline(region) -> np.ndarray:
    """Region -> closed polyline f32[M,2] (ref: region.c:459 overlay)."""
    if region.shape == "circle":
        return circle_points(region.pos[:2] if len(region.pos) == 2
                             else (region.pos[0], region.pos[-1]),
                             region.radius)
    x, z = (region.pos[0], region.pos[-1])
    hx, hz = region.half_x, region.half_z
    return np.array([(x - hx, z - hz), (x + hx, z - hz), (x + hx, z + hz),
                     (x - hx, z + hz), (x - hx, z - hz)], np.float32)


def chunk_boundary_lines(chunks_r: int, chunks_c: int) -> np.ndarray:
    """Grid lines between chunks, f32[E,2,2] world XZ."""
    W = chunks_c * CHUNK_SIZE_UNITS
    H = chunks_r * CHUNK_SIZE_UNITS
    segs = []
    for r in range(chunks_r + 1):
        segs.append(((0.0, r * CHUNK_SIZE_UNITS), (W, r * CHUNK_SIZE_UNITS)))
    for c in range(chunks_c + 1):
        segs.append(((c * CHUNK_SIZE_UNITS, 0.0), (c * CHUNK_SIZE_UNITS, H)))
    return np.asarray(segs, np.float32)


# ---------------------------------------------------------------------------
# projection + rasterization
# ---------------------------------------------------------------------------

def _ground_y(engine, x: np.ndarray, z: np.ndarray) -> np.ndarray:
    hts = engine.heights
    r = np.clip((z / NAV_TILE_SIZE).astype(int), 0, hts.shape[0] - 1)
    c = np.clip((x / NAV_TILE_SIZE).astype(int), 0, hts.shape[1] - 1)
    return hts[r, c] + 0.3


def _project(engine, camera, pts_xz: np.ndarray, w: int, h: int,
             y: np.ndarray | None = None):
    """World XZ points -> (px f32[M], py f32[M], ok bool[M])."""
    if len(pts_xz) == 0:
        return (np.zeros(0), np.zeros(0), np.zeros(0, bool))
    x, z = pts_xz[:, 0], pts_xz[:, 1]
    if y is None:
        y = _ground_y(engine, x, z)
    vp = camera.proj_matrix() @ camera.view_matrix()
    p = np.stack([x, y, z, np.ones_like(x)], -1) @ vp.T
    ok = p[:, 3] > 1e-3
    px = (p[:, 0] / np.maximum(p[:, 3], 1e-6) * 0.5 + 0.5) * w
    py = (0.5 - p[:, 1] / np.maximum(p[:, 3], 1e-6) * 0.5) * h
    return px, py, ok


def _draw_line(img, x0, y0, x1, y1, color):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    if n > 4 * max(img.shape):   # mostly-offscreen degenerate projection
        return
    t = np.linspace(0.0, 1.0, n + 1)
    xs = np.round(x0 + (x1 - x0) * t).astype(int)
    ys = np.round(y0 + (y1 - y0) * t).astype(int)
    on = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[on], xs[on]] = color


def _draw_dots(img, px, py, ok, color, half=1):
    xs = np.round(px[ok]).astype(int)
    ys = np.round(py[ok]).astype(int)
    h, w = img.shape[:2]
    on = (xs >= half) & (xs < w - half) & (ys >= half) & (ys < h - half)
    xs, ys = xs[on], ys[on]
    cols = color[ok][on] if isinstance(color, np.ndarray) else color
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            img[ys + dy, xs + dx] = cols


def _draw_segments(img, engine, camera, segs: np.ndarray, color, w, h):
    """segs f32[E,2,2] world XZ -> lines."""
    if len(segs) == 0:
        return
    a = _project(engine, camera, segs[:, 0], w, h)
    b = _project(engine, camera, segs[:, 1], w, h)
    for i in range(len(segs)):
        if a[2][i] and b[2][i]:
            _draw_line(img, a[0][i], a[1][i], b[0][i], b[1][i], color)


def _draw_arrows(img, engine, camera, starts, vecs, color, w, h):
    if len(starts) == 0:
        return
    tips = starts + vecs
    # arrowhead: two short barbs rotated +/- 150deg from the direction
    d = vecs / np.maximum(np.linalg.norm(vecs, axis=-1, keepdims=True), 1e-6)
    c150, s150 = np.cos(2.62), np.sin(2.62)
    barb1 = np.stack([d[:, 0] * c150 - d[:, 1] * s150,
                      d[:, 0] * s150 + d[:, 1] * c150], -1)
    barb2 = np.stack([d[:, 0] * c150 + d[:, 1] * s150,
                      -d[:, 0] * s150 + d[:, 1] * c150], -1)
    blen = np.linalg.norm(vecs, axis=-1, keepdims=True) * 0.35
    segs = np.concatenate([
        np.stack([starts, tips], 1),
        np.stack([tips, tips + barb1 * blen], 1),
        np.stack([tips, tips + barb2 * blen], 1)], 0)
    _draw_segments(img, engine, camera, segs, color, w, h)


def _draw_polyline(img, engine, camera, pts: np.ndarray, color, w, h):
    segs = np.stack([pts[:-1], pts[1:]], 1)
    _draw_segments(img, engine, camera, segs, color, w, h)


# ---------------------------------------------------------------------------
# the overlay pass
# ---------------------------------------------------------------------------

HOST_COLUMNS = ("alive", "pos", "vel", "radius", "height", "attack_range",
                 "target", "has_formation_cell", "formation_cell")


def _np(t) -> np.ndarray:
    return t.cpu().numpy()


def apply_debug_overlays(img: np.ndarray, engine, camera,
                         w: int, h: int, host: dict | None = None) -> np.ndarray:
    """Composite every enabled pf.debug.* overlay onto `img` (u8[h,w,3]).
    `host` holds the frame's entity columns (``Engine.ents_host``)."""
    get = engine.settings.get

    def on(name: str) -> bool:
        try:
            return bool(get(f"pf.debug.{name}"))
        except Exception:   # setting not registered (no pf.init) -> off
            return False

    wanted = [n for n in (
        "show_flow_fields", "show_enemy_seek_fields", "show_arrival_fields",
        "show_nav_cost_base", "show_nav_islands", "show_nav_portals",
        "show_nav_blockers", "show_chunk_boundaries", "show_hrvo_debug",
        "show_formations", "show_combat_ranges", "show_combat_targets",
        "show_faction_vision", "show_harvester_state",
        "show_automation_state") if on(n)]
    regions_on = _regions_shown(engine)
    if not wanted and not regions_on:
        return img

    img = img.copy()
    if host is None:
        host = engine.ents_host(*HOST_COLUMNS)
    try:
        layer = int(get("pf.debug.navigation_layer") or 0)
    except Exception:
        layer = 0
    st = engine.state
    cfg = engine.cfg

    if "show_chunk_boundaries" in wanted:
        segs = chunk_boundary_lines(cfg.chunks_r, cfg.chunks_c)
        _draw_segments(img, engine, camera, segs, COL_CHUNK, w, h)

    if "show_nav_cost_base" in wanted:
        cost = _np(st.nav.cost_base[layer])
        pts = tile_mask_points(cost == 0xFF, decimate=1)
        px, py, ok = _project(engine, camera, pts, w, h)
        _draw_dots(img, px, py, ok, COL_COST)

    if "show_nav_blockers" in wanted:
        blk = _np(st.nav.blockers[layer])
        pts = tile_mask_points(blk > 0, decimate=1)
        px, py, ok = _project(engine, camera, pts, w, h)
        _draw_dots(img, px, py, ok, COL_BLOCKER)

    if "show_nav_islands" in wanted:
        isl = engine.nav.islands(layer)
        cost = _np(st.nav.cost_base[layer])
        pts, cols = island_points(np.asarray(isl, np.int32), cost < 0xFF)
        px, py, ok = _project(engine, camera, pts, w, h)
        _draw_dots(img, px, py, ok, cols)

    if "show_nav_portals" in wanted:
        spans, links = portal_segments(engine.nav.graph(layer))
        _draw_segments(img, engine, camera, spans, COL_PORTAL, w, h)
        _draw_segments(img, engine, camera, links, COL_PORTAL_LINK, w, h)

    if "show_flow_fields" in wanted:
        _flow_field_overlay(img, engine, camera, w, h)

    if "show_enemy_seek_fields" in wanted:
        fid = int(get("pf.debug.enemy_seek_fields_faction_id") or 0)
        slot = int(st.factions.chase_slot[fid, layer])
        if slot >= 0:
            codes = _np(st.fields.global_flow[slot])
            starts, vecs = flow_arrows(codes, (0.0, 0.0), decimate=4)
            _draw_arrows(img, engine, camera, starts, vecs, COL_SEEK, w, h)

    if "show_arrival_fields" in wanted:
        fl = engine.host_copies(st.flocks, "global_slot", "active")
        gs = fl["global_slot"]
        for f in np.nonzero(fl["active"])[0]:
            slot = int(gs[f])
            if slot >= 0:
                codes = _np(st.fields.global_flow[slot])
                starts, vecs = flow_arrows(codes, (0.0, 0.0), decimate=4)
                _draw_arrows(img, engine, camera, starts, vecs,
                             COL_ARRIVAL, w, h)

    if "show_formations" in wanted:
        hasc = host["has_formation_cell"] & host["alive"]
        cells = host["formation_cell"][hasc]
        # pf.debug.formation_cell_index highlights one cell (drawn larger
        # in a distinct color — ref: formation.c:1378 debug draw indexes)
        try:
            hi = int(get("pf.debug.formation_cell_index") or 0)
        except Exception:
            hi = 0
        for i, cxz in enumerate(cells):
            if i == hi:
                _draw_polyline(img, engine, camera,
                               circle_points(cxz, 2.6, segs=10),
                               (255, 255, 80), w, h)
            else:
                _draw_polyline(img, engine, camera,
                               circle_points(cxz, 1.6, segs=8),
                               COL_FORMATION, w, h)

    if "show_hrvo_debug" in wanted:
        _hrvo_overlay(img, engine, camera, w, h, host)

    if "show_combat_ranges" in wanted or "show_combat_targets" in wanted:
        _combat_overlay(img, engine, camera, w, h, host,
                        ranges="show_combat_ranges" in wanted,
                        targets="show_combat_targets" in wanted)

    if "show_faction_vision" in wanted:
        fid = int(get("pf.debug.enemy_seek_fields_faction_id") or 0)
        fog = _np(st.fog.state[fid])
        pts = tile_mask_points(fog == int(FogState.VISIBLE),
                               tile=2 * NAV_TILE_SIZE, decimate=2)
        px, py, ok = _project(engine, camera, pts, w, h)
        _draw_dots(img, px, py, ok, COL_VISION, half=0)

    if "show_harvester_state" in wanted or "show_automation_state" in wanted:
        _economy_overlay(img, engine, camera, w, h, host)

    if regions_on:
        for r in engine.regions.regions.values():
            _draw_polyline(img, engine, camera, region_outline(r),
                           COL_REGION, w, h)
    return img


def _regions_shown(engine) -> bool:
    try:
        from permafrost_engine_tpu_torch.script import pf
        ctx = pf._context
        return (ctx is not None and ctx.engine is engine
                and ctx.show_regions_flag)
    except Exception:
        return False


def _flow_field_overlay(img, engine, camera, w, h):
    """Per-flock chunk flow fields + LOS tint (ref: nav.c:2520+)."""
    st = engine.state
    fl = engine.host_copies(st.flocks, "active", "field_slot", "los_slot")
    active, fslots, lslots = fl["active"], fl["field_slot"], fl["los_slot"]
    flow = None
    los = None
    nchunks_c = engine.cfg.chunks_c
    for f in np.nonzero(active)[0]:
        for chunk in np.nonzero(fslots[f] >= 0)[0]:
            if flow is None:
                flow = _np(st.fields.flow)
                los = _np(st.fields.los)
            cr, cc = divmod(int(chunk), nchunks_c)
            origin = (cc * CHUNK_SIZE_UNITS, cr * CHUNK_SIZE_UNITS)
            codes = flow[int(fslots[f, chunk])]
            starts, vecs = flow_arrows(codes, origin, decimate=4)
            _draw_arrows(img, engine, camera, starts, vecs, COL_FLOW, w, h)
            ls = int(lslots[f, chunk])
            if ls >= 0:
                pts = tile_mask_points(los[ls] > 0, origin, decimate=4)
                px, py, ok = _project(engine, camera, pts, w, h)
                _draw_dots(img, px, py, ok, COL_LOS, half=0)


def _hrvo_overlay(img, engine, camera, w, h, host):
    """Cones the avoidance solve sees for the first selected entity
    (ref: clearpath.c:420 debug draw)."""
    sel = list(engine.selection.selection)
    if not sel:
        return
    slot = engine.uid_to_slot.get(int(sel[0]))
    if slot is None:
        return
    pos, vel = host["pos"], host["vel"]
    rad, alive = host["radius"], host["alive"]
    d = np.linalg.norm(pos - pos[slot], axis=-1)
    neigh = np.nonzero(alive & (d > 1e-6) & (d < 32.0))[0][:16]
    if not len(neigh):
        return
    cones = hrvo_cones(pos, vel, rad, slot, neigh)
    anchor = pos[slot]
    for k in range(len(neigh)):
        apex_w = anchor + cones["apex"][k]
        segs = np.asarray([
            (apex_w, apex_w + cones["legs_l"][k]),
            (apex_w, apex_w + cones["legs_r"][k])], np.float32)
        _draw_segments(img, engine, camera, segs, COL_HRVO, w, h)


def _combat_overlay(img, engine, camera, w, h, host, *, ranges, targets):
    alive, rng = host["alive"], host["attack_range"]
    pos, tgt = host["pos"], host["target"]
    sel_slots = [s for u in engine.selection.selection
                 if (s := engine.uid_to_slot.get(int(u))) is not None]
    slots = sel_slots or list(np.nonzero(alive & (rng > 0))[0][:64])
    for s in slots:
        if not alive[s]:
            continue
        if ranges and rng[s] > 0:
            _draw_polyline(img, engine, camera,
                           circle_points(pos[s], float(rng[s])),
                           COL_RANGE, w, h)
        if targets and tgt[s] >= 0 and alive[tgt[s]]:
            segs = np.asarray([(pos[s], pos[tgt[s]])], np.float32)
            _draw_segments(img, engine, camera, segs, COL_TARGET, w, h)


def _economy_overlay(img, engine, camera, w, h, host):
    """Colored state dots above harvesters (ref: the reference's
    harvester/automation state overlays draw text; a color key keeps the
    raster cheap): gathering=green, transporting=blue, idle=grey."""
    eco = getattr(engine, "economy", None)
    if eco is None:
        return
    states = getattr(eco, "harvesters", {})
    if not states:
        return
    key = {"HARVESTING": (60, 220, 60), "TO_RESOURCE": (120, 220, 120),
           "TO_STORAGE": (60, 120, 240)}
    pos, hgt = host["pos"], host["height"]
    for uid, hstate in states.items():
        slot = engine.uid_to_slot.get(int(uid))
        if slot is None:
            continue
        name = str(getattr(hstate, "state", hstate)).split(".")[-1].upper()
        col = next((v for k, v in key.items() if k in name), (160, 160, 160))
        pt = np.asarray([[pos[slot, 0], pos[slot, 1]]], np.float32)
        y = np.asarray([hgt[slot] + 5.0], np.float32)
        px, py, ok = _project(engine, camera, pt, w, h, y=y)
        _draw_dots(img, px, py, ok, col, half=1)
