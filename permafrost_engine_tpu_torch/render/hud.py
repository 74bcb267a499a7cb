"""HUD composition: minimap, cursor glyph, storage-site / garrison panels.

These are the consumers of the pf styling state that scripts configure:
`pf.set_minimap_position/size/border_clr/render_all` style the minimap
(ref: src/map/minimap.c + gl_minimap.c), `pf.activate_system_cursor` /
`set_cursor_rts_mode` pick the cursor glyph (ref: src/cursor.c), and
`pf.set_storage_site_ui_*` / `set_garrison_ui_*` style the per-entity
panels (ref: src/game/storage_site.c + garrison.c UI, game.c:1070+).

All drawing is host-side numpy over the finished frame, in the same
virtual-resolution coordinate system the UI compositor uses
(1920x1080 -> frame pixels).

Port of ``permafrost_engine_tpu/render/hud.py``, the same numpy
compositor over the port's ``pf`` context. The entity panels read
positions from the frame's one ``Engine.ents_host`` copy (`host`, taken
here when the caller passes none).
"""

from __future__ import annotations

import numpy as np

# cursor glyphs: unit-space (0..1) polylines per system-cursor kind
_ARROW = [(0.0, 0.0), (0.0, 1.0), (0.28, 0.72), (0.55, 0.95), (0.68, 0.82),
          (0.42, 0.6), (0.75, 0.52), (0.0, 0.0)]
_SCROLL = {   # direction vectors for the 8 edge-scroll cursors
    "scroll_top": (0, -1), "scroll_bot": (0, 1),
    "scroll_left": (-1, 0), "scroll_right": (1, 0),
    "scroll_top_left": (-1, -1), "scroll_top_right": (1, -1),
    "scroll_bot_left": (-1, 1), "scroll_bot_right": (1, 1),
}
_CURSOR_COLORS = {
    "default": (250, 250, 250), "pointer": (250, 250, 250),
    "target": (250, 250, 90), "attack": (250, 80, 60),
    "no_attack": (140, 140, 140), "build": (90, 220, 90),
    "transport": (90, 170, 250), "garrison": (200, 140, 250),
    "drop_off": (250, 190, 90),
}


def _vscale(ctx, w: int, h: int) -> tuple[float, float]:
    vw, vh = ctx.ui.virtual_resolution
    return w / vw, h / vh


def _line(img, x0, y0, x1, y1, color):
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1))
    t = np.linspace(0.0, 1.0, n + 1)
    xs = np.round(x0 + (x1 - x0) * t).astype(int)
    ys = np.round(y0 + (y1 - y0) * t).astype(int)
    on = (xs >= 0) & (xs < img.shape[1]) & (ys >= 0) & (ys < img.shape[0])
    img[ys[on], xs[on]] = color


def compose_minimap(img: np.ndarray, engine, ctx) -> np.ndarray:
    """Paste the minimap at the scripted position/size with the scripted
    border color (pf.set_minimap_* state, ref: gl_minimap.c placement)."""
    mm = ctx.minimap
    if not mm.get("shown", False):
        return img
    from permafrost_engine_tpu_torch.render.draw import minimap_raster
    h, w = img.shape[:2]
    sx, sy = _vscale(ctx, w, h)
    size_px = max(int(mm["size"] * min(sx, sy)), 8)
    pov = None if mm.get("render_all") else ctx.player_faction
    tile = minimap_raster(engine, size=size_px, faction_pov=pov)
    # nearest-resize the raster to the exact on-screen square
    ry = (np.arange(size_px) * tile.shape[0] // size_px)
    rx = (np.arange(size_px) * tile.shape[1] // size_px)
    tile = tile[ry][:, rx]
    x0, y0 = mm["position"]
    # top-left anchor in virtual coords (pf.mouse_over_minimap uses the
    # same convention); clamp into the frame
    px = int(np.clip(x0 * sx, 0, w - size_px))
    py = int(np.clip(y0 * sy, 0, h - size_px))
    img = img.copy()
    img[py:py + size_px, px:px + size_px] = tile
    bc = tuple(int(c) for c in mm["border_clr"][:3])
    img[py, px:px + size_px] = bc
    img[py + size_px - 1, px:px + size_px] = bc
    img[py:py + size_px, px] = bc
    img[py:py + size_px, px + size_px - 1] = bc
    ctx.minimap["screen_rect"] = (px, py, size_px, size_px)
    return img


def compose_cursor(img: np.ndarray, ctx) -> np.ndarray:
    """Draw the active cursor glyph at the injected mouse position
    (ref: src/cursor.c hardware cursors; composited here because frames
    stream to a browser/file with no OS cursor)."""
    if not ctx.cursor.get("compose", False):
        return img
    h, w = img.shape[:2]
    sx, sy = _vscale(ctx, w, h)
    mx, my = ctx.mouse_pos
    px, py = mx * sx, my * sy
    kind = str(ctx.cursor.get("active", "default"))
    img = img.copy()
    size = max(10.0 * min(sx, sy) * 4, 7.0)
    if kind.startswith("scroll"):
        dx, dy = _SCROLL.get(kind, (0, -1))
        n = np.hypot(dx, dy)
        dx, dy = dx / n, dy / n
        tip = (px + dx * size, py + dy * size)
        _line(img, px, py, tip[0], tip[1], (250, 250, 250))
        for s in (-1, 1):
            bx = -dx * 0.4 + s * dy * 0.3
            by = -dy * 0.4 - s * dx * 0.3
            _line(img, tip[0], tip[1], tip[0] + bx * size, tip[1] + by * size,
                  (250, 250, 250))
    else:
        col = _CURSOR_COLORS.get(kind, (250, 250, 250))
        pts = [(px + ux * size, py + uy * size) for ux, uy in _ARROW]
        for a, b in zip(pts[:-1], pts[1:]):
            _line(img, a[0], a[1], b[0], b[1], col)
    return img


def compose_entity_panels(img: np.ndarray, engine, ctx, camera,
                          host: dict | None = None) -> np.ndarray:
    """Storage-site stock bars + garrison occupancy chips above entities
    scripts opted in via pf.storage_site_show_ui / pf.garrison_show_ui,
    styled by the pf.set_storage_site_ui_* / set_garrison_ui_* state."""
    shown_ss = [u for u, on in ctx.storage_ui.get("shown", {}).items() if on]
    shown_g = [u for u, on in ctx.garrison_ui.get("shown", {}).items() if on]
    mode = None
    try:
        mode = int(engine.settings.get("pf.game.storage_site_ui_mode"))
    except Exception:
        pass
    if mode == 0:   # SS_UI_SHOW_ALWAYS: every storage site
        shown_ss = list(getattr(engine.economy, "storages", {}).keys())
    elif mode == 1:  # SS_UI_SHOW_SELECTED: selected sites + explicit opts
        sel = {int(u) for u in engine.selection.selection}
        shown_ss = [u for u in getattr(engine.economy, "storages", {})
                    if int(u) in sel] + [u for u in shown_ss
                                         if int(u) not in sel]
    elif mode == 2:  # SS_UI_SHOW_NEVER
        shown_ss = []
    if not shown_ss and not shown_g:
        return img
    h, w = img.shape[:2]
    img = img.copy()
    if host is None:
        host = engine.ents_host("pos", "height")
    pos, hgt = host["pos"], host["height"]
    border = tuple(int(c) for c in ctx.storage_ui["border_color"][:3])
    font = tuple(int(c) for c in ctx.storage_ui["font_color"][:3])
    gfont = tuple(int(c) for c in ctx.garrison_ui["font_color"][:3])

    def anchor(uid):
        s = engine.uid_to_slot.get(int(uid))
        if s is None:
            return None
        p = camera.world_to_screen(
            (pos[s, 0], hgt[s] + 6.0, pos[s, 1]), w, h)
        if p is None:
            return None
        x, y = int(p[0]), int(p[1])
        if not (12 <= x < w - 12 and 6 <= y < h - 6):
            return None
        return x, y

    for uid in shown_ss:
        comp = getattr(engine.economy, "storages", {}).get(int(uid))
        a = anchor(uid)
        if comp is None or a is None:
            continue
        x, y = a
        caps = comp.capacity or {}
        total_cap = sum(caps.values())
        total = sum(comp.stored.get(k, 0) for k in caps)
        frac = (total / total_cap) if total_cap else 0.0
        img[y - 1:y + 2, x - 11:x + 12] = border
        fill = int(20 * np.clip(frac, 0, 1))
        img[y, x - 10:x - 10 + fill] = font
    for uid in shown_g:
        comp = getattr(engine.economy, "garrisons", {}).get(int(uid))
        a = anchor(uid)
        if a is None:
            continue
        x, y = a
        units = len(getattr(comp, "held", []) or []) if comp else 0
        cap = int(getattr(comp, "capacity", 0) or 0) if comp else 0
        img[y - 1:y + 2, x - 9:x + 10] = (30, 30, 30)
        for i in range(min(cap, 9)):
            col = gfont if i < units else (90, 90, 90)
            img[y, x - 8 + 2 * i] = col
    return img


def compose_hud(img: np.ndarray, engine, camera,
                host: dict | None = None) -> np.ndarray:
    """Full HUD pass, bound to the pf context owning this engine."""
    try:
        from permafrost_engine_tpu_torch.script import pf
        ctx = pf._context
    except Exception:
        return img
    if ctx is None or ctx.engine is not engine:
        return img
    img = compose_entity_panels(img, engine, ctx, camera, host)
    img = compose_minimap(img, engine, ctx)
    img = compose_cursor(img, ctx)
    return img
