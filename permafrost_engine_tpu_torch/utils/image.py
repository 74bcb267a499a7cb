"""Image IO — the stb_image / stb_image_write analogue.

The reference vendors stb_image(+resize) for texture loads and screenshot
dumps (ref: src/lib/public/stb_image.h). Textures aren't
consumed by the headless compute path, but the API surface is: scripts
load splat/icon images and dump framebuffers. Backed by PIL.

The port's own copy of ``permafrost_engine_tpu/utils/image.py``, verbatim:
PIL is imported inside each function, so a host without Pillow imports
this module and fails only when it reads or writes an image file.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str, channels: int = 4) -> np.ndarray:
    """u8[H, W, channels] like stbi_load (channels 1/3/4)."""
    from PIL import Image

    mode = {1: "L", 3: "RGB", 4: "RGBA"}[channels]
    with Image.open(path) as im:
        arr = np.asarray(im.convert(mode), np.uint8)
    if channels == 1:
        arr = arr[..., None]
    return arr


def write_image(path: str, pixels: np.ndarray) -> None:
    """Write u8[H, W] / [H, W, C] to PNG/BMP/... by extension
    (stbi_write_*)."""
    from PIL import Image

    arr = np.asarray(pixels)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def resize_image(pixels: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resize (stb_image_resize analogue)."""
    from PIL import Image

    arr = np.asarray(pixels)
    squeeze = arr.ndim == 3 and arr.shape[2] == 1
    if squeeze:
        arr = arr[..., 0]
    out = np.asarray(Image.fromarray(arr).resize((w, h), Image.BILINEAR))
    if squeeze:
        out = out[..., None]
    return out
