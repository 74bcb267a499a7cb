"""Record an engine run into a self-contained HTML replay viewer.

Port of ``tools/export_replay.py``. The engine's presentation contract is
draw-buffer arrays (``render/draw.py``); this tool records per-frame unit
states into a compact binary stream (one ``Engine.ents_host`` copy per
recorded frame) and writes one standalone replay.html (a canvas renderer
with no dependencies that works offline) with the baked minimap as the
terrain backdrop. Pillow encodes the backdrop and is imported only there.
The engine runs on the card; ``--cpu`` asks for the CPU.

Run: ``python -m permafrost_engine_tpu_torch.tools.export_replay out.html
[--units 400] [--seconds 40] [--stride 6] [--cpu]``
"""

from __future__ import annotations

import argparse
import base64
import io
import json

import numpy as np


def record(engine, frames: int, stride: int = 6):
    """Capture [T, N, 2] u16 positions (world * 16) and [T, N, 3] u8 state
    (hp %, faction, alive), one sample every `stride` frames."""
    t_pos, t_state = [], []
    for _ in range(frames // stride):
        engine.step(stride)
        h = engine.ents_host("pos", "alive", "hp", "max_hp", "faction")
        xz = np.clip(h["pos"] * 16.0, 0, 65535).astype(np.uint16)
        hpf = np.clip(h["hp"] / np.maximum(h["max_hp"], 1.0) * 100, 0, 100
                      ).astype(np.uint8)
        t_pos.append(xz)
        t_state.append(np.stack([hpf, h["faction"].astype(np.uint8),
                                 h["alive"].astype(np.uint8)], 1))
    return np.stack(t_pos), np.stack(t_state)


def build_html(engine, t_pos, t_state, fps: float) -> str:
    from PIL import Image

    from permafrost_engine_tpu_torch.render.draw import minimap_raster

    mm = minimap_raster(engine, size=512)
    buf = io.BytesIO()
    Image.fromarray(mm).save(buf, format="PNG")
    mm_b64 = base64.b64encode(buf.getvalue()).decode()

    pos_b64 = base64.b64encode(t_pos.astype("<u2").tobytes()).decode()
    st_b64 = base64.b64encode(t_state.tobytes()).decode()
    meta = {
        "frames": int(t_pos.shape[0]),
        "n": int(t_pos.shape[1]),
        "world_w": float(engine.cfg.world_w),
        "world_h": float(engine.cfg.world_h),
        "fps": fps,
    }
    return _TEMPLATE.replace("__META__", json.dumps(meta)) \
                    .replace("__MINIMAP__", mm_b64) \
                    .replace("__POS__", pos_b64) \
                    .replace("__STATE__", st_b64)


_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>permafrost_engine_tpu_torch replay</title>
<style>
 body{background:#111;color:#ccc;font:13px monospace;margin:0;
      display:flex;flex-direction:column;align-items:center}
 canvas{margin-top:8px;image-rendering:pixelated}
 #bar{margin:8px}
 button{font:inherit;background:#333;color:#ccc;border:1px solid #555;
        padding:2px 10px;cursor:pointer}
</style></head><body>
<div id="bar"><button id="play">pause</button>
 <span id="info"></span></div>
<canvas id="c" width="768" height="768"></canvas>
<script>
const META = __META__;
const b64 = s => Uint8Array.from(atob(s), c => c.charCodeAt(0));
const posRaw = new Uint16Array(b64("__POS__").buffer);
const stRaw = b64("__STATE__");
const mm = new Image();
mm.src = "data:image/png;base64,__MINIMAP__";
const FCOL = ["#3c78ff","#ff3c3c","#3cdc3c","#ffdc3c",
              "#c83cff","#3cdcdc","#ff8c00","#969696"];
const cv = document.getElementById("c"), ctx = cv.getContext("2d");
let frame = 0, playing = true;
function draw(){
  const {frames, n, world_w, world_h} = META;
  ctx.imageSmoothingEnabled = false;
  ctx.drawImage(mm, 0, 0, cv.width, cv.height);
  const sx = cv.width / (world_w * 16), sy = cv.height / (world_h * 16);
  const pbase = frame * n * 2, sbase = frame * n * 3;
  for (let i = 0; i < n; i++){
    if (!stRaw[sbase + i*3 + 2]) continue;
    const x = posRaw[pbase/2 + i*2] * sx, z = posRaw[pbase/2 + i*2+1] * sy;
    const hp = stRaw[sbase + i*3], fac = stRaw[sbase + i*3 + 1];
    ctx.fillStyle = FCOL[fac % FCOL.length];
    ctx.globalAlpha = 0.35 + 0.65 * hp / 100;
    ctx.fillRect(x-1.5, z-1.5, 3, 3);
  }
  ctx.globalAlpha = 1;
  document.getElementById("info").textContent =
    `frame ${frame+1}/${frames}  t=${(frame/META.fps).toFixed(1)}s`;
}
setInterval(() => { if (playing){ frame = (frame+1) % META.frames; draw(); } },
            1000 / META.fps);
document.getElementById("play").onclick = e => {
  playing = !playing; e.target.textContent = playing ? "pause" : "play"; };
mm.onload = draw;
</script></body></html>
"""


def build(units: int, device="cuda"):
    """The replay's battle: two armies of `units` (25% ranged) at war on a
    2x2-chunk map, ordered across it."""
    from permafrost_engine_tpu_torch.core.config import DiplomacyState, EngineConfig
    from permafrost_engine_tpu_torch.game.engine import Engine

    cfg = EngineConfig(max_ents=2 * units + 64, chunks_r=2, chunks_c=2,
                       num_layers=1, max_projectiles=512,
                       field_slab_slots=64, los_slab_slots=64)
    eng = Engine(cfg, device=device)
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)
    rng = np.random.default_rng(0)

    def army(x0):
        f = (np.arange(units) % 16) * 5.0
        z = 150.0 + (np.arange(units) // 16) * 5.0
        return np.stack([x0 + f + rng.random(units), z + rng.random(units)], 1
                        ).astype(np.float32)

    ranged = rng.random(units) < 0.25
    a = eng.spawn_batch(army(80.0), faction=0, max_speed=18.0, hp=120.0,
                        is_ranged=ranged,
                        attack_range=np.where(ranged, 40.0, 5.0))
    b = eng.spawn_batch(army(350.0), faction=1, max_speed=18.0, hp=120.0,
                        is_ranged=ranged,
                        attack_range=np.where(ranged, 40.0, 5.0))
    eng.move(a, (400.0, 256.0))
    eng.move(b, (100.0, 256.0))
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?", default="replay.html")
    ap.add_argument("--units", type=int, default=400)
    ap.add_argument("--seconds", type=int, default=40)
    ap.add_argument("--stride", type=int, default=6)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    eng = build(args.units, device="cpu" if args.cpu else "cuda")
    t_pos, t_state = record(eng, args.seconds * 60, args.stride)
    html = build_html(eng, t_pos, t_state, fps=60.0 / args.stride)
    with open(args.out, "w") as f:
        f.write(html)
    alive = int(eng.ents_host("alive")["alive"].sum())
    print(f"wrote {args.out}: {t_pos.shape[0]} frames, "
          f"{t_pos.shape[1]} slots, {len(html)//1024} KiB, "
          f"{alive} units alive at end")
    return t_pos, t_state


if __name__ == "__main__":
    main()
