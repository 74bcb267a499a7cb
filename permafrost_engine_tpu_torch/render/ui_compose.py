"""UI draw-list -> pixels: the nuklear rasterizer analogue.

The reference records nuklear draw commands and rasterizes them in a GL
pass (ref: src/render/gl_ui.c, src/ui.c:163-267 virtual-
resolution layout). Here windows keep their headless draw-list contract
(script/ui.py) and this module composites them onto a rendered frame on
the host: panels, title bars, and widgets (labels, buttons, checkboxes,
options, sliders, progress bars, text edits) drawn with PIL in virtual-
resolution coordinates scaled to the frame.

Port of ``permafrost_engine_tpu/render/ui_compose.py``, verbatim over the
port's ``script/ui.py`` and ``script/ui_style.py``.
"""

from __future__ import annotations

import numpy as np

from permafrost_engine_tpu_torch.script.ui import (
    TITLE_H,
    WINDOW_BORDER,
    WINDOW_TITLE,
    Window,
    layout_window,
)

TEXT = (212, 212, 214, 255)


def _c(v, fallback):
    """Style color -> PIL RGBA; image-path items fall back to a flat fill
    (the compositor has no texture atlas)."""
    if v is None or isinstance(v, str):
        return fallback
    return tuple(int(x) for x in v)


def compose_ui(frame: np.ndarray, windows: dict[str, Window],
               virtual_resolution=(1920, 1080)) -> np.ndarray:
    """Composite all shown windows onto u8[h, w, 3]; returns a new array.

    Widget colors/paddings come from the per-widget-class style objects
    (script/ui_style.py STYLES — the nuklear style mirror); buttons use
    the style snapshot captured when the widget was recorded, so scoped
    `with ButtonStyle(...)` overrides land on exactly their widgets
    (ref: py_ui_style.c styles consumed by nuklear's rasterizer)."""
    shown = [w for w in windows.values() if w.shown]
    if not shown:
        return frame
    from PIL import Image, ImageDraw, ImageFont

    from permafrost_engine_tpu_torch.script.ui_style import STYLES

    wstyle = STYLES["window_style"]
    hstyle = STYLES["window_header_style"]
    cstyle = STYLES["checkbox_style"]
    ostyle = STYLES["option_style"]
    sstyle = STYLES["slider_style"]
    pstyle = STYLES["progress_style"]
    estyle = STYLES["edit_style"]

    h, w = frame.shape[:2]
    vw, vh = virtual_resolution
    sx, sy = w / vw, h / vh
    base = Image.fromarray(frame).convert("RGBA")
    layer = Image.new("RGBA", (w, h), (0, 0, 0, 0))
    d = ImageDraw.Draw(layer)
    font = ImageFont.load_default()

    def rect(r, fill, outline=None):
        x, y, rw, rh = r
        d.rectangle([x * sx, y * sy, (x + rw) * sx, (y + rh) * sy],
                    fill=fill, outline=outline)

    def text(r, s, color=TEXT, pad=3):
        x, y, _rw, rh = r
        d.text((x * sx + pad, y * sy + max((rh * sy - 10) / 2, 0)),
               str(s), fill=color, font=font)

    for win in shown:
        wx, wy, ww, wh = win.rect
        rect((wx, wy, ww, wh), _c(wstyle.background, (38, 38, 42, 215)),
             outline=(_c(wstyle.border_color, (20, 20, 20, 255))
                      if win.flags & WINDOW_BORDER else None))
        if win.flags & WINDOW_TITLE:
            rect((wx, wy, ww, TITLE_H),
                 _c(hstyle.normal, (52, 70, 98, 235)))
            text((wx, wy, ww, TITLE_H), win.name,
                 _c(hstyle.label_normal, TEXT))
        for kind, item, r in layout_window(win):
            if kind == "label":
                c = item[2]
                text(r, item[1],
                     (c[0], c[1], c[2], 255) if c else TEXT)
            elif kind == "button":
                bs = item[2] if len(item) > 2 and item[2] else {}
                rect(r, _c(bs.get("normal"), (58, 58, 64, 255)),
                     outline=_c(bs.get("border_color"),
                                (120, 120, 126, 255)))
                text(r, item[1], _c(bs.get("text_normal"), TEXT))
            elif kind == "checkbox":
                x, y, rw, rh = r
                box = (x, y + rh * 0.15, rh * 0.7, rh * 0.7)
                rect(box, _c(cstyle.normal, (58, 58, 64, 255)),
                     outline=_c(cstyle.border_color, (120, 120, 126, 255)))
                val = win._widget_state.get(("check", item[1]), item[2])
                if val:
                    rect((box[0] + box[2] * 0.25, box[1] + box[3] * 0.25,
                          box[2] * 0.5, box[3] * 0.5),
                         _c(cstyle.cursor_normal, (92, 144, 210, 255)))
                text((x + rh * 0.9, y, rw - rh, rh), item[1],
                     _c(cstyle.text_normal, TEXT))
            elif kind == "option":
                x, y, rw, rh = r
                rect((x, y + rh * 0.25, rh * 0.5, rh * 0.5),
                     (_c(ostyle.cursor_normal, (92, 144, 210, 255))
                      if item[2] else _c(ostyle.normal, (58, 58, 64, 255))),
                     outline=_c(ostyle.border_color, (120, 120, 126, 255)))
                text((x + rh * 0.7, y, rw - rh, rh), item[1],
                     _c(ostyle.text_normal, TEXT))
            elif kind == "slider":
                _, minv, cur, maxv, _step = item
                x, y, rw, rh = r
                rect((x, y + rh * 0.4, rw, rh * 0.2),
                     _c(sstyle.bar_normal, (58, 58, 64, 255)))
                frac = 0.0 if maxv <= minv else (cur - minv) / (maxv - minv)
                rect((x, y + rh * 0.4, rw * frac, rh * 0.2),
                     _c(sstyle.bar_filled, (92, 144, 210, 255)))
                kx = x + frac * rw
                cw, chh = sstyle.cursor_size
                rect((kx - cw / 2, y + rh * 0.15, cw, max(chh, rh * 0.7)),
                     _c(sstyle.cursor_normal, (92, 144, 210, 255)))
            elif kind == "progress":
                _, cur, maxv = item
                x, y, rw, rh = r
                rect(r, _c(pstyle.normal, (58, 58, 64, 255)))
                frac = 0.0 if maxv <= 0 else min(cur / maxv, 1.0)
                rect((x, y, rw * frac, rh),
                     _c(pstyle.cursor_normal, (92, 144, 210, 255)))
            elif kind == "text_edit":
                rect(r, _c(estyle.normal, (24, 24, 26, 255)),
                     outline=_c(estyle.border_color, (120, 120, 126, 255)))
                text(r, item[2] + "_", _c(estyle.text_normal, TEXT))
            elif kind == "group":
                text(r, f"[{item[1]}]")
            # "image"/"spacer"/"row" need no pixels here

    out = Image.alpha_composite(base, layer).convert("RGB")
    return np.asarray(out, np.uint8)
