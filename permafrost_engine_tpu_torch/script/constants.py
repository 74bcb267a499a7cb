"""Script-facing constant surface of the `pf` module.

The reference exposes ~781 constants to game scripts via PY_EXPOSE_ENUM
(ref: src/script/py_constants.c:76-965): the full SDL2
scancode/keycode/keymod/event tables, the engine event enum, and every
script-visible engine enum family (cursors, formations, tile types,
nuklear UI flags, ...).  This module generates the same surface.

Values follow the public SDL2 and nuklear ABIs where the reference
exposes those libraries' enums verbatim (scripts persist them in saves
and compare them against injected events, so the numbers are contract);
engine-native enums use this package's canonical values.

The port's own copy of ``permafrost_engine_tpu/script/constants.py``,
verbatim.
"""

# ---------------------------------------------------------------------------
# SDL2 scancodes (public SDL_scancode.h values).  The reference exposes the
# full table; our input-injection pipeline (pf.inject_key_*) carries these
# in the `scancode` field.
# ---------------------------------------------------------------------------

SDL_SCANCODES: dict[str, int] = {"UNKNOWN": 0}

for _i, _c in enumerate("ABCDEFGHIJKLMNOPQRSTUVWXYZ"):
    SDL_SCANCODES[_c] = 4 + _i
for _i, _c in enumerate("1234567890"):
    SDL_SCANCODES[_c] = 30 + _i

SDL_SCANCODES.update({
    "RETURN": 40, "ESCAPE": 41, "BACKSPACE": 42, "TAB": 43, "SPACE": 44,
    "MINUS": 45, "EQUALS": 46, "LEFTBRACKET": 47, "RIGHTBRACKET": 48,
    "BACKSLASH": 49, "NONUSHASH": 50, "SEMICOLON": 51, "APOSTROPHE": 52,
    "GRAVE": 53, "COMMA": 54, "PERIOD": 55, "SLASH": 56, "CAPSLOCK": 57,
})
for _i in range(12):
    SDL_SCANCODES[f"F{_i + 1}"] = 58 + _i
SDL_SCANCODES.update({
    "PRINTSCREEN": 70, "SCROLLLOCK": 71, "PAUSE": 72, "INSERT": 73,
    "HOME": 74, "PAGEUP": 75, "DELETE": 76, "END": 77, "PAGEDOWN": 78,
    "RIGHT": 79, "LEFT": 80, "DOWN": 81, "UP": 82, "NUMLOCKCLEAR": 83,
    "KP_DIVIDE": 84, "KP_MULTIPLY": 85, "KP_MINUS": 86, "KP_PLUS": 87,
    "KP_ENTER": 88,
})
for _i in range(9):
    SDL_SCANCODES[f"KP_{_i + 1}"] = 89 + _i
SDL_SCANCODES.update({
    "KP_0": 98, "KP_PERIOD": 99, "NONUSBACKSLASH": 100, "APPLICATION": 101,
    "POWER": 102, "KP_EQUALS": 103,
})
for _i in range(12):
    SDL_SCANCODES[f"F{_i + 13}"] = 104 + _i
SDL_SCANCODES.update({
    "EXECUTE": 116, "HELP": 117, "MENU": 118, "SELECT": 119, "STOP": 120,
    "AGAIN": 121, "UNDO": 122, "CUT": 123, "COPY": 124, "PASTE": 125,
    "FIND": 126, "MUTE": 127, "VOLUMEUP": 128, "VOLUMEDOWN": 129,
    "KP_COMMA": 133, "KP_EQUALSAS400": 134,
    "INTERNATIONAL1": 135, "INTERNATIONAL2": 136, "INTERNATIONAL3": 137,
    "INTERNATIONAL4": 138, "INTERNATIONAL5": 139, "INTERNATIONAL6": 140,
    "INTERNATIONAL7": 141, "INTERNATIONAL8": 142, "INTERNATIONAL9": 143,
    "LANG1": 144, "LANG2": 145, "LANG3": 146, "LANG4": 147, "LANG5": 148,
    "LANG6": 149, "LANG7": 150, "LANG8": 151, "LANG9": 152,
    "ALTERASE": 153, "SYSREQ": 154, "CANCEL": 155, "CLEAR": 156,
    "PRIOR": 157, "RETURN2": 158, "SEPARATOR": 159, "OUT": 160,
    "OPER": 161, "CLEARAGAIN": 162, "CRSEL": 163, "EXSEL": 164,
    "KP_00": 176, "KP_000": 177, "THOUSANDSSEPARATOR": 178,
    "DECIMALSEPARATOR": 179, "CURRENCYUNIT": 180, "CURRENCYSUBUNIT": 181,
    "KP_LEFTPAREN": 182, "KP_RIGHTPAREN": 183, "KP_LEFTBRACE": 184,
    "KP_RIGHTBRACE": 185, "KP_TAB": 186, "KP_BACKSPACE": 187,
    "KP_A": 188, "KP_B": 189, "KP_C": 190, "KP_D": 191, "KP_E": 192,
    "KP_F": 193, "KP_XOR": 194, "KP_POWER": 195, "KP_PERCENT": 196,
    "KP_LESS": 197, "KP_GREATER": 198, "KP_AMPERSAND": 199,
    "KP_DBLAMPERSAND": 200, "KP_VERTICALBAR": 201, "KP_DBLVERTICALBAR": 202,
    "KP_COLON": 203, "KP_HASH": 204, "KP_SPACE": 205, "KP_AT": 206,
    "KP_EXCLAM": 207, "KP_MEMSTORE": 208, "KP_MEMRECALL": 209,
    "KP_MEMCLEAR": 210, "KP_MEMADD": 211, "KP_MEMSUBTRACT": 212,
    "KP_MEMMULTIPLY": 213, "KP_MEMDIVIDE": 214, "KP_PLUSMINUS": 215,
    "KP_CLEAR": 216, "KP_CLEARENTRY": 217, "KP_BINARY": 218,
    "KP_OCTAL": 219, "KP_DECIMAL": 220, "KP_HEXADECIMAL": 221,
    "LCTRL": 224, "LSHIFT": 225, "LALT": 226, "LGUI": 227,
    "RCTRL": 228, "RSHIFT": 229, "RALT": 230, "RGUI": 231, "MODE": 257,
    "AUDIONEXT": 258, "AUDIOPREV": 259, "AUDIOSTOP": 260, "AUDIOPLAY": 261,
    "AUDIOMUTE": 262, "MEDIASELECT": 263, "WWW": 264, "MAIL": 265,
    "CALCULATOR": 266, "COMPUTER": 267, "AC_SEARCH": 268, "AC_HOME": 269,
    "AC_BACK": 270, "AC_FORWARD": 271, "AC_STOP": 272, "AC_REFRESH": 273,
    "AC_BOOKMARKS": 274, "BRIGHTNESSDOWN": 275, "BRIGHTNESSUP": 276,
    "DISPLAYSWITCH": 277, "KBDILLUMTOGGLE": 278, "KBDILLUMDOWN": 279,
    "KBDILLUMUP": 280, "EJECT": 281, "SLEEP": 282, "APP1": 283,
    "APP2": 284, "AUDIOREWIND": 285, "AUDIOFASTFORWARD": 286,
})

# ---------------------------------------------------------------------------
# SDL2 keycodes.  SDLK_x = ASCII for printable keys, scancode | (1 << 30)
# otherwise (the public SDL_SCANCODE_TO_KEYCODE mapping).
# ---------------------------------------------------------------------------

SDLK_SCANCODE_MASK = 1 << 30

_SDLK_PRINTABLE = {
    "RETURN": ord("\r"), "ESCAPE": 27, "BACKSPACE": ord("\b"),
    "TAB": ord("\t"), "SPACE": ord(" "), "EXCLAIM": ord("!"),
    "QUOTEDBL": ord('"'), "HASH": ord("#"), "PERCENT": ord("%"),
    "DOLLAR": ord("$"), "AMPERSAND": ord("&"), "QUOTE": ord("'"),
    "LEFTPAREN": ord("("), "RIGHTPAREN": ord(")"), "ASTERISK": ord("*"),
    "PLUS": ord("+"), "COMMA": ord(","), "MINUS": ord("-"),
    "PERIOD": ord("."), "SLASH": ord("/"), "COLON": ord(":"),
    "SEMICOLON": ord(";"), "LESS": ord("<"), "EQUALS": ord("="),
    "GREATER": ord(">"), "QUESTION": ord("?"), "AT": ord("@"),
    "LEFTBRACKET": ord("["), "BACKSLASH": ord("\\"),
    "RIGHTBRACKET": ord("]"), "CARET": ord("^"), "UNDERSCORE": ord("_"),
    "BACKQUOTE": ord("`"), "DELETE": 127, "UNKNOWN": 0,
}

SDL_KEYCODES: dict[str, int] = {}
for _c in "abcdefghijklmnopqrstuvwxyz":
    SDL_KEYCODES[_c] = ord(_c)
for _c in "0123456789":
    SDL_KEYCODES[_c] = ord(_c)
SDL_KEYCODES.update(_SDLK_PRINTABLE)
for _name, _sc in SDL_SCANCODES.items():
    if _name in ("UNKNOWN",) or len(_name) == 1:
        continue
    if _name in _SDLK_PRINTABLE:
        continue  # printable keycode already set from the ASCII table
    if _name in ("GRAVE", "APOSTROPHE", "NONUSHASH", "NONUSBACKSLASH"):
        continue  # SDLK names differ (BACKQUOTE/QUOTE) or are not exposed
    SDL_KEYCODES[_name] = _sc | SDLK_SCANCODE_MASK

# ---------------------------------------------------------------------------
# SDL2 key modifiers
# ---------------------------------------------------------------------------

KMOD_NONE = 0x0000
KMOD_LSHIFT = 0x0001
KMOD_RSHIFT = 0x0002
KMOD_LCTRL = 0x0040
KMOD_RCTRL = 0x0080
KMOD_LALT = 0x0100
KMOD_RALT = 0x0200
KMOD_LGUI = 0x0400
KMOD_RGUI = 0x0800
KMOD_NUM = 0x1000
KMOD_CAPS = 0x2000
KMOD_MODE = 0x4000
KMOD_RESERVED = 0x8000
KMOD_CTRL = KMOD_LCTRL | KMOD_RCTRL
KMOD_SHIFT = KMOD_LSHIFT | KMOD_RSHIFT
KMOD_ALT = KMOD_LALT | KMOD_RALT
KMOD_GUI = KMOD_LGUI | KMOD_RGUI

# ---------------------------------------------------------------------------
# SDL2 event types + mouse buttons (public SDL_events.h values; they sit in
# 0x0-0xffff, below the engine event range, so scripts can register
# handlers on them like on engine events — ref: src/event.h:45-55 range
# table)
# ---------------------------------------------------------------------------

SDL_EVENTS: dict[str, int] = {
    "QUIT": 0x100, "APP_TERMINATING": 0x101, "APP_LOWMEMORY": 0x102,
    "APP_WILLENTERBACKGROUND": 0x103, "APP_DIDENTERBACKGROUND": 0x104,
    "APP_WILLENTERFOREGROUND": 0x105, "APP_DIDENTERFOREGROUND": 0x106,
    "WINDOWEVENT": 0x200, "SYSWMEVENT": 0x201,
    "KEYDOWN": 0x300, "KEYUP": 0x301, "TEXTEDITING": 0x302,
    "TEXTINPUT": 0x303, "KEYMAPCHANGED": 0x304,
    "MOUSEMOTION": 0x400, "MOUSEBUTTONDOWN": 0x401,
    "MOUSEBUTTONUP": 0x402, "MOUSEWHEEL": 0x403,
    "JOYAXISMOTION": 0x600, "JOYBALLMOTION": 0x601, "JOYHATMOTION": 0x602,
    "JOYBUTTONDOWN": 0x603, "JOYBUTTONUP": 0x604, "JOYDEVICEADDED": 0x605,
    "JOYDEVICEREMOVED": 0x606,
    "CONTROLLERAXISMOTION": 0x650, "CONTROLLERBUTTONDOWN": 0x651,
    "CONTROLLERBUTTONUP": 0x652, "CONTROLLERDEVICEADDED": 0x653,
    "CONTROLLERDEVICEREMOVED": 0x654, "CONTROLLERDEVICEREMAPPED": 0x655,
    "FINGERDOWN": 0x700, "FINGERUP": 0x701, "FINGERMOTION": 0x702,
    "DOLLARGESTURE": 0x800, "DOLLARRECORD": 0x801, "MULTIGESTURE": 0x802,
    "CLIPBOARDUPDATE": 0x900,
    "DROPFILE": 0x1000, "DROPTEXT": 0x1001, "DROPBEGIN": 0x1002,
    "DROPCOMPLETE": 0x1003,
    "AUDIODEVICEADDED": 0x1100, "AUDIODEVICEREMOVED": 0x1101,
    "RENDER_TARGETS_RESET": 0x2000, "RENDER_DEVICE_RESET": 0x2001,
    "USEREVENT": 0x8000, "LASTEVENT": 0xFFFF,
}

SDL_BUTTON_LEFT = 1
SDL_BUTTON_MIDDLE = 2
SDL_BUTTON_RIGHT = 3
SDL_BUTTON_X1 = 4
SDL_BUTTON_X2 = 5
SDL_PRESSED = 1
SDL_RELEASED = 0

# ---------------------------------------------------------------------------
# Cursor kinds (ref: src/cursor.h cursortype enum, exposed as CURSOR_*)
# ---------------------------------------------------------------------------

CURSOR_POINTER = 0
CURSOR_SCROLL_TOP = 1
CURSOR_SCROLL_TOP_RIGHT = 2
CURSOR_SCROLL_RIGHT = 3
CURSOR_SCROLL_BOT_RIGHT = 4
CURSOR_SCROLL_BOT = 5
CURSOR_SCROLL_BOT_LEFT = 6
CURSOR_SCROLL_LEFT = 7
CURSOR_SCROLL_TOP_LEFT = 8
CURSOR_TARGET = 9
CURSOR_ATTACK = 10
CURSOR_NO_ATTACK = 11
CURSOR_BUILD = 12
CURSOR_TRANSPORT = 13
CURSOR_GARRISON = 14
CURSOR_DROP_OFF = 15
_CURSOR_MAX = 16

# ---------------------------------------------------------------------------
# Engine enum families (values are this package's canonical ones)
# ---------------------------------------------------------------------------

ANIM_MODE_LOOP = 0
ANIM_MODE_ONCE = 1

CAM_PROJ_PERSPECTIVE = 0
CAM_PROJ_ORTHOGRAPHIC = 1

PF_WF_FULLSCREEN = 0
PF_WF_WINDOW = 1
PF_WF_BORDERLESS_WIN = 2

HB_MODE_ALWAYS = 0
HB_MODE_DAMAGED = 1
HB_MODE_NEVER = 2

SS_UI_SHOW_ALWAYS = 0
SS_UI_SHOW_SELECTED = 1
SS_UI_SHOW_NEVER = 2

TRANSPORT_STRATEGY_NEAREST = 0
TRANSPORT_STRATEGY_EXCESS = 1
TRANSPORT_STRATEGY_GATHERING = 2

MUSIC_MODE_LOOP = 0
MUSIC_MODE_PLAYLIST = 1
MUSIC_MODE_SHUFFLE = 2

REGION_CIRCLE = 0
REGION_RECTANGLE = 1

PROJ_ONLY_HIT_COMBATABLE = 1 << 0
PROJ_ONLY_HIT_ENEMIES = 1 << 1

BLEND_MODE_NOBLEND = 0
BLEND_MODE_BLUR = 1
BLEND_MODE_EDGE = 2

# Map geometry (ref: src/map/public/tile.h:43-48)
X_COORDS_PER_TILE = 8
Y_COORDS_PER_TILE = 4
Z_COORDS_PER_TILE = 8
TILES_PER_CHUNK_WIDTH = 32
TILES_PER_CHUNK_HEIGHT = 32

# Tile types (ref: src/map/public/tile.h:58-72; pfmap.py uses these codes)
TILETYPE_FLAT = 0x0
TILETYPE_RAMP_SN = 0x1
TILETYPE_RAMP_NS = 0x2
TILETYPE_RAMP_EW = 0x3
TILETYPE_RAMP_WE = 0x4
TILETYPE_CORNER_CONCAVE_SW = 0x5
TILETYPE_CORNER_CONVEX_SW = 0x6
TILETYPE_CORNER_CONCAVE_SE = 0x7
TILETYPE_CORNER_CONVEX_SE = 0x8
TILETYPE_CORNER_CONCAVE_NW = 0x9
TILETYPE_CORNER_CONVEX_NW = 0xA
TILETYPE_CORNER_CONCAVE_NE = 0xB
TILETYPE_CORNER_CONVEX_NE = 0xC

TILE_COVER_NONE = 0
TILE_COVER_GRASS_SPARSE = 1
TILE_COVER_GRASS_FULL = 2

MAX_FACTIONS = 15           # ref: src/game/public/game.h:48
AIR_UNIT_HEIGHT = 20.0      # ref: src/game/public/game.h:50
AUDIO_NUM_FG_CHANNELS = 4   # ref: src/audio/public/audio.h

# ---------------------------------------------------------------------------
# nuklear UI enums (public nuklear.h values; ref exposes them via py_ui.c /
# py_constants.c so scripts can build windows — our script/ui.py consumes
# the same flag values)
# ---------------------------------------------------------------------------

NK_WINDOW_BORDER = 1 << 0
NK_WINDOW_MOVABLE = 1 << 1
NK_WINDOW_SCALABLE = 1 << 2
NK_WINDOW_CLOSABLE = 1 << 3
NK_WINDOW_MINIMIZABLE = 1 << 4
NK_WINDOW_NO_SCROLLBAR = 1 << 5
NK_WINDOW_TITLE = 1 << 6
NK_WINDOW_SCROLL_AUTO_HIDE = 1 << 7
NK_WINDOW_BACKGROUND = 1 << 8
NK_WINDOW_SCALE_LEFT = 1 << 9
NK_WINDOW_NO_INPUT = 1 << 10

NK_TEXT_ALIGN_LEFT = 0x01
NK_TEXT_ALIGN_CENTERED = 0x02
NK_TEXT_ALIGN_RIGHT = 0x04
NK_TEXT_ALIGN_TOP = 0x08
NK_TEXT_ALIGN_MIDDLE = 0x10
NK_TEXT_ALIGN_BOTTOM = 0x20
NK_TEXT_LEFT = NK_TEXT_ALIGN_MIDDLE | NK_TEXT_ALIGN_LEFT
NK_TEXT_CENTERED = NK_TEXT_ALIGN_MIDDLE | NK_TEXT_ALIGN_CENTERED
NK_TEXT_RIGHT = NK_TEXT_ALIGN_MIDDLE | NK_TEXT_ALIGN_RIGHT

NK_EDIT_DEFAULT = 0
NK_EDIT_READ_ONLY = 1 << 0
NK_EDIT_AUTO_SELECT = 1 << 1
NK_EDIT_SIG_ENTER = 1 << 2
NK_EDIT_ALLOW_TAB = 1 << 3
NK_EDIT_NO_CURSOR = 1 << 4
NK_EDIT_SELECTABLE = 1 << 5
NK_EDIT_CLIPBOARD = 1 << 6
NK_EDIT_CTRL_ENTER_NEWLINE = 1 << 7
NK_EDIT_NO_HORIZONTAL_SCROLL = 1 << 8
NK_EDIT_ALWAYS_INSERT_MODE = 1 << 9
NK_EDIT_MULTILINE = 1 << 10
NK_EDIT_GOTO_END_ON_ACTIVATE = 1 << 11
NK_EDIT_SIMPLE = NK_EDIT_ALWAYS_INSERT_MODE
NK_EDIT_FIELD = NK_EDIT_SIMPLE | NK_EDIT_SELECTABLE | NK_EDIT_CLIPBOARD
NK_EDIT_BOX = (NK_EDIT_ALWAYS_INSERT_MODE | NK_EDIT_SELECTABLE
               | NK_EDIT_MULTILINE | NK_EDIT_ALLOW_TAB | NK_EDIT_CLIPBOARD)
NK_EDIT_EDITOR = (NK_EDIT_SELECTABLE | NK_EDIT_MULTILINE
                  | NK_EDIT_ALLOW_TAB | NK_EDIT_CLIPBOARD)

NK_SYMBOL_NONE = 0
NK_SYMBOL_X = 1
NK_SYMBOL_UNDERSCORE = 2
NK_SYMBOL_CIRCLE_SOLID = 3
NK_SYMBOL_CIRCLE_OUTLINE = 4
NK_SYMBOL_RECT_SOLID = 5
NK_SYMBOL_RECT_OUTLINE = 6
NK_SYMBOL_TRIANGLE_UP = 7
NK_SYMBOL_TRIANGLE_DOWN = 8
NK_SYMBOL_TRIANGLE_LEFT = 9
NK_SYMBOL_TRIANGLE_RIGHT = 10
NK_SYMBOL_PLUS = 11
NK_SYMBOL_MINUS = 12
NK_SYMBOL_MAX = 13

NK_CHART_LINES = 0
NK_CHART_COLUMN = 1
NK_CHART_MAX = 2
NK_CHART_HOVERING = 0x01
NK_CHART_CLICKED = 0x02

NK_TREE_NODE = 0
NK_TREE_TAB = 1
NK_POPUP_STATIC = 0
NK_POPUP_DYNAMIC = 1
NK_BUTTON_DEFAULT = 0
NK_BUTTON_REPEATER = 1
NK_DYNAMIC = 0
NK_STATIC = 1
NK_FIXED = 0
NK_MODIFIABLE = 1
NK_VERTICAL = 0
NK_HORIZONTAL = 1
NK_MINIMIZED = 0
NK_MAXIMIZED = 1
NK_HIDDEN = 0
NK_SHOWN = 1
NK_RGB = 0
NK_RGBA = 1


def export_into(ns: dict) -> int:
    """Install every constant into `ns` (the pf module globals).

    Returns the number of names exported.
    """
    count = 0
    for name, val in list(globals().items()):
        if name.isupper() or name == "_CURSOR_MAX":
            ns[name] = val
            count += 1
    for name, val in SDL_SCANCODES.items():
        ns[f"SDL_SCANCODE_{name}"] = val
        count += 1
    for name, val in SDL_KEYCODES.items():
        ns[f"SDLK_{name}"] = val
        count += 1
    for name, val in SDL_EVENTS.items():
        ns[f"SDL_{name}"] = val
        count += 1
    # the dict containers themselves are not script-facing constants
    for helper in ("SDL_SCANCODES", "SDL_KEYCODES", "SDL_EVENTS"):
        ns.pop(helper, None)
        count -= 1
    return count
