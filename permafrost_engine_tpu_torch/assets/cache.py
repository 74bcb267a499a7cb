"""Baked-binary asset cache.

The reference bakes parsed assets into a binary cache directory and loads
the bake when the source is unchanged (ref: src/asset_cache.c). Here the
bake is a pickle of the parsed dataclass (MapData / PFObj are numpy-array
dataclasses) keyed by the source text's content hash — loads skip the text
parser entirely.

The port's own copy of ``permafrost_engine_tpu/assets/cache.py``. Its
fingerprint names the port's own ``MapData`` and ``PFObj`` (module and
fields), so a bake of the JAX package's classes never matches a key of
the port's, and its default directory is its own: the port never hands a
caller an object of the JAX package.
"""

from __future__ import annotations

import hashlib
import os
import pickle

CACHE_VERSION = 1
_DEFAULT_DIR = os.path.join(
    os.path.expanduser("~"), ".cache", "permafrost_engine_tpu_torch")


def _parser_fingerprint(kind: str) -> str:
    """Schema fingerprint folded into the key so bakes invalidate when the
    parsed dataclass changes shape or module — no manual CACHE_VERSION
    bumps (ref: the reference's bake format versioning, asset_cache.c)."""
    import dataclasses

    if kind == "pfmap":
        from permafrost_engine_tpu_torch.assets.pfmap import MapData as cls
    elif kind == "pfobj":
        from permafrost_engine_tpu_torch.assets.pfobj import PFObj as cls
    else:
        return "generic"
    return f"{cls.__module__}.{cls.__qualname__}:" + ",".join(
        f.name for f in dataclasses.fields(cls))


def _key(kind: str, text: str) -> str:
    h = hashlib.sha256(
        f"{CACHE_VERSION}:{kind}:{_parser_fingerprint(kind)}:".encode()
        + text.encode()).hexdigest()
    return f"{kind}-{h[:24]}.bake"


def load_baked(kind: str, text: str, cache_dir: str | None = None):
    """Return the baked parse for `text`, or None on miss/corruption."""
    path = os.path.join(cache_dir or _DEFAULT_DIR, _key(kind, text))
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception:
        return None   # any corrupt bake falls back to the text parser


def store_baked(kind: str, text: str, obj, cache_dir: str | None = None):
    d = cache_dir or _DEFAULT_DIR
    try:
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, _key(kind, text) + ".tmp")
        with open(tmp, "wb") as f:
            pickle.dump(obj, f, protocol=4)
        os.replace(tmp, os.path.join(d, _key(kind, text)))
    except OSError:
        pass   # cache is best-effort


def cached_parse(kind: str, text: str, parser, cache_dir: str | None = None):
    """parse-with-bake: returns the baked object on hit, else parses and
    bakes (ref: asset_cache.c bake-on-first-load)."""
    obj = load_baked(kind, text, cache_dir)
    if obj is not None:
        return obj
    obj = parser(text)
    store_baked(kind, text, obj, cache_dir)
    return obj
