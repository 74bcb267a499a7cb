"""Texture synthesis + atlas for the rasterizer.

The reference samples terrain splat textures and model textures in its
GLSL passes, with Efros-Freeman image quilting providing terrain texture
variation (ref: src/render/gl_image_quilt.c, terrain
shaders). Headless here: terrain detail maps are synthesized from perlin
noise (optionally run through ops/quilt.py for non-repeating variation —
the same role quilting plays in the reference), model textures load from
image files when present, and everything packs into ONE atlas the
deferred shader samples with wrapped UVs (the shared-texture discipline
of gl_batch.c).

Port of ``permafrost_engine_tpu/render/textures.py``: numpy, as there, so
the atlas is byte-equal to the JAX package's. ``detail_map(quilt=True)``
quilts on `device` (the card unless the caller names another).
"""

from __future__ import annotations

import numpy as np

TEX_SIZE = 64      # every atlas tile is TEX_SIZE x TEX_SIZE


def detail_map(kind: str, seed: int = 0, size: int = TEX_SIZE,
               quilt: bool = False, device="cuda") -> np.ndarray:
    """Tileable luminance-detail texture (mean ~1.0) for a terrain kind.
    Tints multiply it, so flat material colors gain surface variation."""
    from permafrost_engine_tpu_torch.utils.noise import tileable2

    n = tileable2(size, size, scale=10.0, octaves=4, seed=seed)
    n = (n - n.mean()) / max(n.std(), 1e-6)
    amp = {"grass": 0.16, "rock": 0.26, "sand": 0.10}.get(kind, 0.15)
    lum = 1.0 + amp * n
    if kind == "rock":     # cracks: second, sharper octave
        n2 = tileable2(size, size, scale=4.0, octaves=2, seed=seed + 7)
        lum = lum - 0.12 * np.abs(n2)
    img = np.repeat(lum[..., None], 3, -1).astype(np.float32)
    if kind == "grass":    # slight hue variation
        img[..., 0] *= 0.96
        img[..., 2] *= 0.92
    if quilt:
        from permafrost_engine_tpu_torch.ops.quilt import image_quilt
        img = image_quilt(np.clip(img * 0.5, 0, 1), size, size,
                          block=size // 4, overlap=size // 16,
                          seed=seed, device=device)[:size, :size] * 2.0
    return np.clip(img, 0.0, 2.0)


class TextureAtlas:
    """Same-size tiles shelf-packed into one image + (row, col) table."""

    def __init__(self):
        self.tiles: list[np.ndarray] = []
        self.names: dict[str, int] = {}

    def add(self, name: str, img: np.ndarray) -> int:
        if name in self.names:
            return self.names[name]
        img = np.asarray(img, np.float32)
        if img.shape[:2] != (TEX_SIZE, TEX_SIZE):
            from permafrost_engine_tpu_torch.utils.image import resize_image
            img = resize_image(
                np.clip(img * 127.5, 0, 255).astype(np.uint8),
                TEX_SIZE, TEX_SIZE).astype(np.float32) / 127.5
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        tid = len(self.tiles)
        self.tiles.append(img[..., :3])
        self.names[name] = tid
        return tid

    def add_file(self, name: str, path: str) -> int:
        """Albedo texture from an image file: stored in [0, 1]; pair with
        a white tint (detail maps are mean-1 and pair with color tints)."""
        from permafrost_engine_tpu_torch.utils.image import load_image
        img = load_image(path, channels=3).astype(np.float32) / 255.0
        return self.add(name, img)

    def build(self):
        """-> (atlas f32[rows*T, cols*T, 3], origins i32[K, 2])."""
        k = max(len(self.tiles), 1)
        cols = int(np.ceil(np.sqrt(k)))
        rows = -(-k // cols)
        atlas = np.ones((rows * TEX_SIZE, cols * TEX_SIZE, 3), np.float32)
        table = np.zeros((k, 2), np.int32)
        for i, img in enumerate(self.tiles):
            r, c = divmod(i, cols)
            atlas[r * TEX_SIZE:(r + 1) * TEX_SIZE,
                  c * TEX_SIZE:(c + 1) * TEX_SIZE] = img
            table[i] = (r * TEX_SIZE, c * TEX_SIZE)
        return atlas, table
