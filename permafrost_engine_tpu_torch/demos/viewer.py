"""Live terminal battle viewer: the presentation stack end to end.

Port of ``demos/viewer.py``: runs the stress battle (``demos/stress.py``'s
``build``) and draws the minimap raster and the draw-buffer statistics to
the terminal every simulated second, the headless stand-in for the
reference's render thread consuming the draw queue. Runs on the card;
``--cpu`` asks for the CPU.

Run: ``python -m permafrost_engine_tpu_torch.demos.viewer [--units 64]
[--seconds 20] [--fog-pov F] [--cpu]``
"""

from __future__ import annotations

import argparse

import numpy as np

from permafrost_engine_tpu_torch.demos.stress import build, report
from permafrost_engine_tpu_torch.render.camera import Camera
from permafrost_engine_tpu_torch.render.draw import draw_buffers, minimap_raster


def ansi_frame(img: np.ndarray, width: int = 64) -> str:
    """Downsample an RGB minimap to coloured terminal blocks."""
    step = max(1, img.shape[1] // width)
    small = img[::2 * step, ::step]
    rows = []
    for row in small:
        out = []
        for px in row:
            r, g, b = (int(x) for x in px)
            if r == g == b == 0:
                out.append(" ")
            else:
                code = 16 + (r * 5 // 255) * 36 + (g * 5 // 255) * 6 + (b * 5 // 255)
                out.append(f"\x1b[48;5;{code}m \x1b[0m")
        rows.append("".join(out))
    return "\n".join(rows)


def main(argv=None) -> list[np.ndarray]:
    """Returns the minimap of every simulated second."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--units", type=int, default=64)
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--fog-pov", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    eng = build(args.units, device="cpu" if args.cpu else "cuda")
    cam = Camera()
    cam.pos = np.array([eng.cfg.world_w / 2, 300.0, eng.cfg.world_h / 2 - 100])

    frames = []
    for s in range(args.seconds):
        eng.step(60)
        img = minimap_raster(eng, size=128, faction_pov=args.fog_pov)
        buf = draw_buffers(eng, cam, alpha=eng.render_alpha)
        visible = buf["visible"].cpu().numpy()
        lods = np.bincount(buf["lod"].cpu().numpy()[visible], minlength=3)
        r = report(eng)
        print("\x1b[2J\x1b[H", end="")
        print(ansi_frame(img))
        print(f"t={s + 1:3d}s alive={r['alive']} visible={int(visible.sum())} "
              f"lod0/1/2={lods[0]}/{lods[1]}/{lods[2]} deaths={r['deaths']}")
        frames.append(img)
    print("VIEWER DONE")
    return frames


if __name__ == "__main__":
    main()
