"""Perlin noise: 1/2/3D + seamless tileable octave noise.

Mirrors the reference's noise library surface (ref: src/lib/noise.c,
src/lib/public/noise.h:56-66) with vectorized NumPy — used for texture
synthesis inputs and procedural map tooling.

The port's own copy of ``permafrost_engine_tpu/utils/noise.py``, verbatim.
"""

from __future__ import annotations

import numpy as np


def _fade(t):
    return t * t * t * (t * (t * 6 - 15) + 10)


def _grad_table(seed: int, n: int = 256):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return np.concatenate([perm, perm])


def perlin2(x, y, seed: int = 0):
    """2D Perlin noise in ~[-1, 1]; x/y arrays broadcast together."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    perm = _grad_table(seed)
    xi = np.floor(x).astype(int) & 255
    yi = np.floor(y).astype(int) & 255
    xf = x - np.floor(x)
    yf = y - np.floor(y)
    u, v = _fade(xf), _fade(yf)

    def grad(h, dx, dy):
        # 8 gradient directions
        g = h & 7
        gx = np.choose(g, [1, -1, 1, -1, 1, -1, 0, 0])
        gy = np.choose(g, [1, 1, -1, -1, 0, 0, 1, -1])
        return gx * dx + gy * dy

    aa = perm[perm[xi] + yi]
    ab = perm[perm[xi] + yi + 1]
    ba = perm[perm[xi + 1] + yi]
    bb = perm[perm[xi + 1] + yi + 1]

    x1 = grad(aa, xf, yf) + u * (grad(ba, xf - 1, yf) - grad(aa, xf, yf))
    x2 = grad(ab, xf, yf - 1) + u * (grad(bb, xf - 1, yf - 1) - grad(ab, xf, yf - 1))
    return x1 + v * (x2 - x1)


def perlin1(x, seed: int = 0):
    return perlin2(x, np.zeros_like(np.asarray(x, np.float64)), seed)


def perlin3(x, y, z, seed: int = 0):
    """Cheap 3D: blend two 2D planes along z."""
    z = np.asarray(z, np.float64)
    zi = np.floor(z)
    zf = _fade(z - zi)
    a = perlin2(x + 31.7 * zi, y + 17.3 * zi, seed)
    b = perlin2(x + 31.7 * (zi + 1), y + 17.3 * (zi + 1), seed)
    return a + zf * (b - a)


def octave2(x, y, octaves: int = 4, persistence: float = 0.5,
            lacunarity: float = 2.0, seed: int = 0):
    """Fractal octave noise (ref: noise.h octave variants)."""
    total = np.zeros(np.broadcast(np.asarray(x), np.asarray(y)).shape)
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * perlin2(np.asarray(x) * freq,
                                      np.asarray(y) * freq, seed + o)
        norm += amp
        amp *= persistence
        freq *= lacunarity
    return total / norm


def tileable2(w: int, h: int, scale: float = 8.0, octaves: int = 4,
              seed: int = 0):
    """Seamless tileable 2D noise image [h, w]: sample on a torus embedded
    in 4D, approximated by blending 4 shifted copies (standard trick)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    u = xs / w
    v = ys / h
    n = (
        octave2(xs / scale, ys / scale, octaves, seed=seed) * (1 - u) * (1 - v)
        + octave2((xs - w) / scale, ys / scale, octaves, seed=seed) * u * (1 - v)
        + octave2(xs / scale, (ys - h) / scale, octaves, seed=seed) * (1 - u) * v
        + octave2((xs - w) / scale, (ys - h) / scale, octaves, seed=seed) * u * v
    )
    return n
