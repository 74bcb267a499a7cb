"""Headless map editor.

Port of ``demos/editor.py``, the analogue of the reference's editor scripts
(ref: scripts/editor/main.py): generate terrain with octave noise, carve
water and cliffs, paint materials, round-trip the result through the PFMAP
format, and plan a path across it on an engine. The engine runs on the
card; ``--cpu`` asks for the CPU.

Run: ``python -m permafrost_engine_tpu_torch.demos.editor out.pfmap
[--chunks 2] [--seed 7] [--cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from permafrost_engine_tpu_torch.assets.pfmap import (
    make_flat_map,
    parse_pfmap,
    write_pfmap,
)
from permafrost_engine_tpu_torch.utils.noise import octave2


def generate(chunks: int, seed: int):
    m = make_flat_map(chunks, chunks, num_materials=3)
    m.materials = [("Grass", "grass.png"), ("Rock", "rock.png"),
                   ("Sand", "sand.png")]
    th = m.tiles_h
    ys, xs = np.mgrid[0:th, 0:th].astype(float)
    h = octave2(xs / 24.0, ys / 24.0, octaves=4, seed=seed)
    h = (h - h.mean()) / max(h.std(), 1e-6)

    m.base_height[:] = np.clip(np.round(h * 4), -9, 9).astype(np.int8)
    water = m.base_height < -2
    cliffs = m.base_height > 5
    m.base_height[water] = -4
    m.pathable[:] = ~cliffs
    m.top_mat[:] = np.where(cliffs, 1, np.where(water, 2, 0))
    m.cover[:] = np.where((~water) & (~cliffs)
                          & (np.random.default_rng(seed).random((th, th)) < 0.3),
                          1, 0)
    return m


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="generated.pfmap")
    ap.add_argument("--chunks", type=int, default=2)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    from permafrost_engine_tpu_torch.core.config import (
        UNITS_PER_TILE,
        EngineConfig,
    )
    from permafrost_engine_tpu_torch.game.engine import Engine

    m = generate(args.chunks, args.seed)
    text = write_pfmap(m)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}: {args.chunks}x{args.chunks} chunks, "
          f"{(m.base_height < 0).mean() * 100:.0f}% water, "
          f"{(~m.pathable).mean() * 100:.0f}% cliffs")

    # round-trip + engine validation: load it and plan a path across
    m2 = parse_pfmap(text)
    np.testing.assert_array_equal(m2.base_height, m.base_height)
    np.testing.assert_array_equal(m2.pathable, m.pathable)

    cfg = EngineConfig(max_ents=16, chunks_r=args.chunks, chunks_c=args.chunks,
                       num_layers=12, max_flocks=4, max_projectiles=8,
                       field_slab_slots=32, los_slab_slots=32)
    eng = Engine(cfg, device="cpu" if args.cpu else "cuda")
    eng.load_map_data(m2)
    land = np.argwhere((m2.base_height >= 0) & m2.pathable)
    a, b = land[len(land) // 8], land[-len(land) // 8]
    u = eng.spawn_batch(np.array(
        [[a[1] * UNITS_PER_TILE, a[0] * UNITS_PER_TILE]], np.float32),
        max_speed=100.0)
    ok = eng.move(u, (b[1] * UNITS_PER_TILE, b[0] * UNITS_PER_TILE))
    print(f"path across generated map: {'reachable' if ok else 'unreachable'}"
          f" (cache: {eng.nav.stats})")
    print("EDITOR ROUND-TRIP OK")
    return dict(text=text, reachable=ok, device=eng.device.type)


if __name__ == "__main__":
    main()
