"""Per-widget-class UI style objects — the nuklear style mirror.

The reference exposes one Python object per nuklear widget style struct
(pf.button_style, pf.checkbox_style, pf.slider_style, ...) whose typed
attributes write straight into the live nuklear context
(ref: src/script/py_ui_style.c:595-6512, 6382-6512 module
registration). Here each class mirrors the reference's getset surface for
that widget — unknown attributes raise AttributeError exactly like a
missing getset — and the UI compositor (render/ui_compose.py) reads the
knobs when rasterizing widgets. Colors are (r, g, b[, a]) tuples; style
"items" that the reference allows to be image paths are accepted as
strings and rendered as flat fills by the compositor.

Scoped overrides (the game scripts' `with ButtonStyle(...)` pattern,
ref: scripts/common/button_style_ctx.py) mutate these objects and restore
them, same as the reference.

The port's own copy of ``permafrost_engine_tpu/script/ui_style.py``,
verbatim. ``render/ui_compose.py`` draws the knobs; the draw lists carry the
same style snapshots.
"""

from __future__ import annotations


def _color(v):
    if isinstance(v, str):          # image path item: kept verbatim
        return v
    t = tuple(float(x) for x in v)
    if len(t) == 3:
        t = t + (255.0,)
    if len(t) != 4:
        raise ValueError(f"color must be (r,g,b[,a]): {v!r}")
    return tuple(int(x) for x in t)


def _vec2(v):
    t = tuple(float(x) for x in v)
    if len(t) != 2:
        raise ValueError(f"vec2 must be (x, y): {v!r}")
    return t


_CASTS = {"color": _color, "vec2": _vec2, "float": float, "int": int,
          "str": str}


class _StyleBase:
    """Typed attribute bag: `_fields` maps name -> (kind, default)."""

    _fields: dict = {}

    def __init__(self, **overrides):
        for name, (_kind, default) in self._fields.items():
            object.__setattr__(self, "_" + name, default)
        for k, v in overrides.items():
            setattr(self, k, v)

    def __getattr__(self, k):
        if k in type(self)._fields:
            return object.__getattribute__(self, "_" + k)
        raise AttributeError(
            f"{type(self).__name__} has no style attribute {k!r}")

    def __setattr__(self, k, v):
        f = type(self)._fields.get(k)
        if f is None:
            raise AttributeError(
                f"{type(self).__name__} has no style attribute {k!r}")
        object.__setattr__(self, "_" + k, _CASTS[f[0]](v))

    # persistence (session save/load keeps styles, the reference's
    # S_UI_Style_Save* streams)
    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._fields}

    def from_dict(self, d: dict) -> None:
        for k, v in d.items():
            if k in self._fields:
                setattr(self, k, v)

    def attrs(self) -> list:
        return sorted(self._fields)


_GREY = (58, 58, 64, 255)
_GREY_HOVER = (70, 70, 78, 255)
_GREY_ACTIVE = (84, 84, 94, 255)
_TEXT = (212, 212, 214, 255)
_BORDER = (120, 120, 126, 255)
_ACCENT = (92, 144, 210, 255)
_DARK = (24, 24, 26, 255)


class UIButtonStyle(_StyleBase):
    """ref: py_ui_style.c:595-668 PyUIButtonStyle_getset."""

    _fields = {
        "normal": ("color", _GREY),
        "hover": ("color", _GREY_HOVER),
        "active": ("color", _GREY_ACTIVE),
        "border_color": ("color", _BORDER),
        "text_background": ("color", (0, 0, 0, 0)),
        "text_normal": ("color", _TEXT),
        "text_hover": ("color", _TEXT),
        "text_active": ("color", _TEXT),
        "text_alignment": ("int", 0x11),       # centered
        "border": ("float", 1.0),
        "rounding": ("float", 0.0),
        "padding": ("vec2", (2.0, 2.0)),
        "image_padding": ("vec2", (0.0, 0.0)),
        "touch_padding": ("vec2", (0.0, 0.0)),
    }


class UIHeaderStyle(_StyleBase):
    """Window title bar (ref: py_ui_style.c:740-830)."""

    _fields = {
        "normal": ("color", (52, 70, 98, 235)),
        "hover": ("color", (52, 70, 98, 235)),
        "active": ("color", (60, 84, 120, 235)),
        "label_normal": ("color", _TEXT),
        "label_hover": ("color", _TEXT),
        "label_active": ("color", _TEXT),
        "padding": ("vec2", (4.0, 4.0)),
        "label_padding": ("vec2", (4.0, 4.0)),
        "spacing": ("vec2", (0.0, 0.0)),
    }


class UIWindowStyle(_StyleBase):
    """ref: nk_style_window mirror (py_ui_style.c window block +
    S_UI_Style_SaveWindow fields)."""

    _fields = {
        "background": ("color", (38, 38, 42, 215)),
        "fixed_background": ("color", (38, 38, 42, 215)),
        "border_color": ("color", (20, 20, 20, 255)),
        "popup_border_color": ("color", (20, 20, 20, 255)),
        "group_border_color": ("color", (60, 60, 66, 255)),
        "border": ("float", 1.0),
        "group_border": ("float", 1.0),
        "rounding": ("float", 0.0),
        "spacing": ("vec2", (4.0, 4.0)),
        "padding": ("vec2", (4.0, 4.0)),
        "group_padding": ("vec2", (4.0, 4.0)),
        "min_row_height_padding": ("float", 8.0),
        "scrollbar_size": ("vec2", (10.0, 10.0)),
    }


class UIToggleStyle(_StyleBase):
    """Checkbox / radio option (ref: py_ui_style.c toggle getsets)."""

    _fields = {
        "normal": ("color", _GREY),
        "hover": ("color", _GREY_HOVER),
        "active": ("color", _GREY_ACTIVE),
        "border_color": ("color", _BORDER),
        "cursor_normal": ("color", _ACCENT),
        "cursor_hover": ("color", _ACCENT),
        "text_normal": ("color", _TEXT),
        "text_hover": ("color", _TEXT),
        "text_active": ("color", _TEXT),
        "text_background": ("color", (0, 0, 0, 0)),
        "padding": ("vec2", (2.0, 2.0)),
        "touch_padding": ("vec2", (0.0, 0.0)),
        "spacing": ("float", 4.0),
        "border": ("float", 1.0),
    }


class UISelectableStyle(_StyleBase):
    _fields = {
        "normal": ("color", _GREY),
        "hover": ("color", _GREY_HOVER),
        "pressed": ("color", _GREY_ACTIVE),
        "normal_active": ("color", _ACCENT),
        "hover_active": ("color", _ACCENT),
        "pressed_active": ("color", _ACCENT),
        "text_normal": ("color", _TEXT),
        "text_hover": ("color", _TEXT),
        "text_pressed": ("color", _TEXT),
        "text_normal_active": ("color", _TEXT),
        "text_hover_active": ("color", _TEXT),
        "text_pressed_active": ("color", _TEXT),
        "text_alignment": ("int", 0x11),
        "rounding": ("float", 0.0),
        "padding": ("vec2", (2.0, 2.0)),
        "touch_padding": ("vec2", (0.0, 0.0)),
        "image_padding": ("vec2", (0.0, 0.0)),
    }


class UISliderStyle(_StyleBase):
    _fields = {
        "normal": ("color", (0, 0, 0, 0)),
        "hover": ("color", (0, 0, 0, 0)),
        "active": ("color", (0, 0, 0, 0)),
        "border_color": ("color", _BORDER),
        "bar_normal": ("color", _GREY),
        "bar_hover": ("color", _GREY),
        "bar_active": ("color", _GREY),
        "bar_filled": ("color", _ACCENT),
        "cursor_normal": ("color", _ACCENT),
        "cursor_hover": ("color", _ACCENT),
        "cursor_active": ("color", _ACCENT),
        "border": ("float", 0.0),
        "rounding": ("float", 0.0),
        "bar_height": ("float", 8.0),
        "padding": ("vec2", (2.0, 2.0)),
        "spacing": ("vec2", (2.0, 2.0)),
        "cursor_size": ("vec2", (6.0, 14.0)),
    }


class UIProgressStyle(_StyleBase):
    _fields = {
        "normal": ("color", _GREY),
        "hover": ("color", _GREY),
        "active": ("color", _GREY),
        "border_color": ("color", _BORDER),
        "cursor_normal": ("color", _ACCENT),
        "cursor_hover": ("color", _ACCENT),
        "cursor_active": ("color", _ACCENT),
        "rounding": ("float", 0.0),
        "border": ("float", 0.0),
        "padding": ("vec2", (2.0, 2.0)),
    }


class UIEditStyle(_StyleBase):
    _fields = {
        "normal": ("color", _DARK),
        "hover": ("color", _DARK),
        "active": ("color", _DARK),
        "border_color": ("color", _BORDER),
        "cursor_normal": ("color", _TEXT),
        "cursor_hover": ("color", _TEXT),
        "text_normal": ("color", _TEXT),
        "text_hover": ("color", _TEXT),
        "text_active": ("color", _TEXT),
        "selected_normal": ("color", _ACCENT),
        "selected_hover": ("color", _ACCENT),
        "border": ("float", 1.0),
        "rounding": ("float", 0.0),
        "padding": ("vec2", (4.0, 4.0)),
        "cursor_size": ("float", 2.0),
        "row_padding": ("float", 2.0),
    }


class UIComboStyle(_StyleBase):
    _fields = {
        "normal": ("color", _GREY),
        "hover": ("color", _GREY_HOVER),
        "active": ("color", _GREY_ACTIVE),
        "border_color": ("color", _BORDER),
        "label_normal": ("color", _TEXT),
        "label_hover": ("color", _TEXT),
        "label_active": ("color", _TEXT),
        "symbol_normal": ("color", _TEXT),
        "symbol_hover": ("color", _TEXT),
        "symbol_active": ("color", _TEXT),
        "border": ("float", 1.0),
        "rounding": ("float", 0.0),
        "content_padding": ("vec2", (4.0, 4.0)),
        "button_padding": ("vec2", (0.0, 4.0)),
        "spacing": ("vec2", (4.0, 0.0)),
    }


class UIScrollbarStyle(_StyleBase):
    _fields = {
        "normal": ("color", _DARK),
        "hover": ("color", _DARK),
        "active": ("color", _DARK),
        "border_color": ("color", _BORDER),
        "cursor_normal": ("color", _GREY),
        "cursor_hover": ("color", _GREY_HOVER),
        "cursor_active": ("color", _GREY_ACTIVE),
        "cursor_border_color": ("color", _BORDER),
        "border": ("float", 0.0),
        "rounding": ("float", 0.0),
        "border_cursor": ("float", 0.0),
        "rounding_cursor": ("float", 0.0),
        "padding": ("vec2", (0.0, 0.0)),
    }


class UIPropertyStyle(_StyleBase):
    _fields = {
        "normal": ("color", _GREY),
        "hover": ("color", _GREY_HOVER),
        "active": ("color", _GREY_ACTIVE),
        "border_color": ("color", _BORDER),
        "label_normal": ("color", _TEXT),
        "label_hover": ("color", _TEXT),
        "label_active": ("color", _TEXT),
        "border": ("float", 1.0),
        "rounding": ("float", 0.0),
        "padding": ("vec2", (4.0, 4.0)),
    }


def make_default_styles() -> dict:
    """The module-level style instances the reference registers
    (py_ui_style.c:6443-6512): one live object per widget class."""
    return {
        "button_style": UIButtonStyle(),
        "contextual_button_style": UIButtonStyle(border=0.0),
        "menu_button_style": UIButtonStyle(border=0.0),
        "selectable_style": UISelectableStyle(),
        "combo_style": UIComboStyle(),
        "option_style": UIToggleStyle(),
        "checkbox_style": UIToggleStyle(),
        "scrollbar_horizontal_style": UIScrollbarStyle(),
        "scrollbar_vertical_style": UIScrollbarStyle(),
        "edit_style": UIEditStyle(),
        "property_style": UIPropertyStyle(),
        "slider_style": UISliderStyle(),
        "progress_style": UIProgressStyle(),
        "window_style": UIWindowStyle(),
        "window_header_style": UIHeaderStyle(),
    }


# the live singletons (the reference's per-context nuklear style structs;
# pf re-exports each entry as a module attribute, py_ui_style.c:6443-6512)
STYLES: dict = make_default_styles()


def styles_to_dict(styles: dict) -> dict:
    return {k: v.to_dict() for k, v in styles.items()}


def styles_from_dict(styles: dict, data: dict) -> None:
    for k, d in (data or {}).items():
        if k in styles:
            styles[k].from_dict(d)
