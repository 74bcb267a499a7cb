"""Script-facing UI: windows, widgets, styles (headless immediate-mode).

The reference embeds nuklear and mirrors its full widget/style surface to
Python (ref: src/script/py_ui.c, py_ui_style.c; layout in src/ui.c:163-267).
This engine is headless-first: windows keep the same API (subclass Window,
override update(), call widget methods) and the widget calls record a
draw-list each frame instead of rasterizing. A terminal/debug renderer can
print it; a GUI front-end can consume it. Virtual-resolution layout and
resize masks follow the reference's semantics.

The port's own copy of ``permafrost_engine_tpu/script/ui.py``, the same code
but for the package name.
"""

from __future__ import annotations

import dataclasses
from typing import Any

# resize mask bits (ref: ui.h virtual-resolution anchoring)
ANCHOR_X_LEFT = 1 << 0
ANCHOR_X_RIGHT = 1 << 1
ANCHOR_X_CENTER = 1 << 2
ANCHOR_Y_TOP = 1 << 3
ANCHOR_Y_BOT = 1 << 4
ANCHOR_Y_CENTER = 1 << 5
ANCHOR_DEFAULT = ANCHOR_X_LEFT | ANCHOR_Y_TOP

WINDOW_BORDER = 1 << 0
WINDOW_MOVABLE = 1 << 1
WINDOW_SCALABLE = 1 << 2
WINDOW_CLOSABLE = 1 << 3
WINDOW_MINIMIZABLE = 1 << 4
WINDOW_NO_SCROLLBAR = 1 << 5
WINDOW_TITLE = 1 << 6


@dataclasses.dataclass
class Style:
    """Flat style bag (the reference mirrors every nuklear style knob;
    scripts may set arbitrary attributes)."""
    props: dict = dataclasses.field(default_factory=dict)

    def __getattr__(self, k):
        try:
            return self.__dict__["props"][k]
        except KeyError:
            raise AttributeError(k) from None

    def __setattr__(self, k, v):
        if k == "props":
            super().__setattr__(k, v)
        else:
            self.props[k] = v


class Window:
    """Subclass and override update(); widgets record into the draw list."""

    def __init__(self, name: str, rect, flags: int = WINDOW_TITLE,
                 resize_mask: int = ANCHOR_DEFAULT):
        self.name = name
        self.rect = list(rect)          # (x, y, w, h) in virtual resolution
        self.flags = flags
        self.resize_mask = resize_mask
        self.shown = False
        self.style = Style()
        self.draw_list: list[tuple] = []
        self._row: tuple | None = None
        self._widget_state: dict[str, Any] = {}

    # -- lifecycle ---------------------------------------------------------------

    def show(self) -> None:
        self.shown = True
        _ctx().ui_windows[self.name] = self

    def hide(self) -> None:
        self.shown = False
        _ctx().ui_windows.pop(self.name, None)

    def update(self) -> None:
        """Override: issue widget calls each frame."""

    def _render(self) -> list[tuple]:
        self.draw_list = []
        self._slider_ix = 0
        self.update()
        return self.draw_list

    # -- layout -------------------------------------------------------------------

    def layout_row_static(self, height: int, width: int, cols: int) -> None:
        self._row = ("static", height, width, cols)
        self.draw_list.append(("row", self._row))

    def layout_row_dynamic(self, height: int, cols: int) -> None:
        self._row = ("dynamic", height, cols)
        self.draw_list.append(("row", self._row))

    # -- widgets -------------------------------------------------------------------

    def label_colored(self, text: str, r: int, g: int, b: int) -> None:
        self.draw_list.append(("label", text, (r, g, b)))

    def label(self, text: str) -> None:
        self.draw_list.append(("label", text, None))

    def button_label(self, label: str) -> bool:
        # nuklear applies the style live as each widget records, so a
        # scoped `with ButtonStyle(...)` override must be captured AT
        # CALL TIME (our rasterization is deferred to the compositor)
        from permafrost_engine_tpu_torch.script.ui_style import STYLES
        self.draw_list.append(
            ("button", label, STYLES["button_style"].to_dict()))
        clicked = self._widget_state.pop(("click", label), False)
        return clicked

    def simulate_click(self, label: str) -> None:
        """Test hook: press a button before the next update."""
        self._widget_state[("click", label)] = True

    def checkbox(self, label: str, value: bool) -> bool:
        self.draw_list.append(("checkbox", label, value))
        return self._widget_state.get(("check", label), value)

    def option_label(self, label: str, active: bool) -> bool:
        self.draw_list.append(("option", label, active))
        return self._widget_state.get(("option", label), active)

    def selectable_label(self, label: str, align: int, selected: bool
                         ) -> bool:
        """List-row selection widget (ref: nk_selectable_label via
        py_ui.c; the demo window's controlled-faction list uses it).
        Returns the row's selected state after any pending click."""
        self.draw_list.append(("selectable", label, align, selected))
        if self._widget_state.pop(("select", label), False):
            return True
        return selected

    def slider_float(self, minv: float, value: float, maxv: float,
                     step: float) -> float:
        """Sliders are keyed by their ordinal within the window (they carry
        no label); input routing writes the same key."""
        ix = getattr(self, "_slider_ix", 0)
        self._slider_ix = ix + 1
        self.draw_list.append(("slider", minv, value, maxv, step))
        return self._widget_state.get(("slider", ix), value)

    def progress(self, cur: int, maxv: int, modifiable: bool = False) -> int:
        self.draw_list.append(("progress", cur, maxv))
        return cur

    def text_edit(self, key: str, initial: str = "") -> str:
        val = self._widget_state.setdefault(("text", key), initial)
        self.draw_list.append(("text_edit", key, val))
        return val

    def image(self, path: str) -> None:
        self.draw_list.append(("image", path))

    def group(self, name: str) -> None:
        self.draw_list.append(("group", name))

    def spacer(self, cols: int = 1) -> None:
        self.draw_list.append(("spacer", cols))


TITLE_H = 28      # virtual-resolution title-bar height
PAD = 6           # inner padding / inter-widget gap


def layout_window(win: Window, draw_list: list[tuple] | None = None
                  ) -> list[tuple]:
    """Replay a window's draw list into placed widgets.

    Returns [(kind, payload, (x, y, w, h))] in virtual-resolution coords —
    the single geometry pass shared by the pixel compositor
    (render/ui_compose.py) and input routing (ref: nuklear computes the
    same row/column layout internally, src/lib/public/nuklear.h)."""
    if draw_list is None:
        draw_list = win._render()
    wx, wy, ww, wh = win.rect
    placed: list[tuple] = []
    y = wy + (TITLE_H if win.flags & WINDOW_TITLE else 0) + PAD
    row = ("dynamic", 24, 1)
    col = 0
    for item in draw_list:
        if item[0] == "row":
            row = item[1]
            col = 0
            continue
        if row[0] == "static":
            _, rh, rw, cols = row
        else:
            _, rh, cols = row
            rw = (ww - 2 * PAD - (cols - 1) * PAD) / max(cols, 1)
        if col >= cols:                      # wrap to a new implicit row
            col = 0
            y += rh + PAD
        x = wx + PAD + col * (rw + PAD)
        span = int(item[1]) if item[0] == "spacer" else 1
        placed.append((item[0], item, (x, y, rw * span, rh)))
        col += span
        if col >= cols:
            col = 0
            y += rh + PAD
    return placed


class UISystem:
    """Per-frame window rendering + draw-list export + input routing."""

    def __init__(self):
        self.virtual_resolution = (1920, 1080)
        self.active_font = "default"
        self.fonts = {"default"}
        self.text_edit_focus = False
        self.focused_text: tuple | None = None     # (window, key)

    def render_all(self, windows: dict[str, Window]) -> dict[str, list]:
        return {name: w._render() for name, w in windows.items() if w.shown}

    # -- input routing (ref: ui.c event dispatch + nuklear widget logic) ----

    def to_virtual(self, pos, screen_size) -> tuple[float, float]:
        vw, vh = self.virtual_resolution
        sw, sh = screen_size
        return pos[0] * vw / max(sw, 1), pos[1] * vh / max(sh, 1)

    def window_at(self, windows: dict[str, Window], vx: float, vy: float
                  ) -> Window | None:
        for w in reversed(list(windows.values())):   # latest shown on top
            x, y, ww, wh = w.rect
            if w.shown and x <= vx <= x + ww and y <= vy <= y + wh:
                return w
        return None

    def route_click(self, windows: dict[str, Window], pos, screen_size
                    ) -> bool:
        """Dispatch a mouse click to the widget under it. Returns True when
        the click landed on UI (callers then skip world picking, mirroring
        the reference's mouse_over_ui gate)."""
        vx, vy = self.to_virtual(pos, screen_size)
        win = self.window_at(windows, vx, vy)
        if win is None:
            self.text_edit_focus = False
            self.focused_text = None
            return False
        slider_ix = -1
        for kind, item, (x, y, w, h) in layout_window(win):
            if kind == "slider":
                slider_ix += 1
            if not (x <= vx <= x + w and y <= vy <= y + h):
                continue
            if kind == "button":
                win._widget_state[("click", item[1])] = True
            elif kind == "checkbox":
                cur = win._widget_state.get(("check", item[1]), item[2])
                win._widget_state[("check", item[1])] = not cur
            elif kind == "option":
                win._widget_state[("option", item[1])] = True
            elif kind == "selectable":
                win._widget_state[("select", item[1])] = True
            elif kind == "slider":
                _, minv, _cur, maxv, step = item
                frac = (vx - x) / max(w, 1e-6)
                val = minv + frac * (maxv - minv)
                if step > 0:
                    val = minv + round((val - minv) / step) * step
                win._widget_state[("slider", slider_ix)] = \
                    min(max(val, minv), maxv)
            elif kind == "text_edit":
                self.text_edit_focus = True
                self.focused_text = (win, item[1])
                return True
            break
        if self.focused_text and self.focused_text[0] is win:
            pass      # clicking elsewhere in the window keeps focus
        return True

    def route_char(self, ch: str) -> bool:
        """Feed a character (or '\\b' backspace) to the focused text edit."""
        if not self.focused_text:
            return False
        win, key = self.focused_text
        cur = win._widget_state.get(("text", key), "")
        if ch == "\b":
            cur = cur[:-1]
        elif ch in ("\r", "\n"):
            self.text_edit_focus = False
            self.focused_text = None
            return True
        else:
            cur += ch
        win._widget_state[("text", key)] = cur
        return True


def _ctx():
    from permafrost_engine_tpu_torch.script import pf
    return pf.context()
