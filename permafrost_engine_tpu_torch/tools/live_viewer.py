"""Live interactive front-end: stream rendered frames over HTTP.

Port of ``tools/live_viewer.py``. The reference presents through SDL and
OpenGL on a local window; the engine's presentation contract is arrays,
rendered to RGB frames by ``render/scene.py`` on the engine's device. This
tool is the windowing layer: a stdlib HTTP server that streams live frames
to a browser as MJPEG and routes browser input back through ``pf.inject_*``
(clicks select and order units, keys arm orders, arrows pan). Pillow
encodes the frames and is imported only where a frame is encoded. The
engine runs on the card; ``--cpu`` asks for the CPU.

Run: ``python -m permafrost_engine_tpu_torch.tools.live_viewer [--port 8642]
[--units 64] [--wh 640x384] [--cpu]``, then open http://localhost:8642/

Endpoints: ``/`` the viewer page (canvas and input forwarding), ``/stream``
multipart MJPEG of live frames, ``/frame.png`` the current frame,
``/input`` POST ``{type, x, y, button|key|dx,dy}`` -> ``pf.inject_*``.
"""

from __future__ import annotations

import argparse
import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

PAGE = """<!doctype html><html><head><title>permafrost_engine_tpu_torch</title>
<style>body{margin:0;background:#111;display:flex;flex-direction:column;
align-items:center;color:#ccc;font-family:monospace}
img{image-rendering:pixelated;cursor:crosshair}</style></head><body>
<h3>permafrost_engine_tpu_torch — live</h3>
<img id=v src=/stream draggable=false>
<p>left-click: select / order &nbsp; right-click: move &nbsp;
m: arm move &nbsp; a: arm attack &nbsp; arrows: pan</p>
<script>
const v=document.getElementById('v');
function send(o){fetch('/input',{method:'POST',body:JSON.stringify(o)})}
function pos(e){const r=v.getBoundingClientRect();
 return {x:(e.clientX-r.left)/r.width, y:(e.clientY-r.top)/r.height}}
v.addEventListener('mousedown',e=>{e.preventDefault();
 send({type:'click',...pos(e),button:e.button===2?3:1})});
v.addEventListener('contextmenu',e=>e.preventDefault());
v.addEventListener('mousemove',e=>{send({type:'motion',...pos(e)})});
window.addEventListener('keydown',e=>{
 if(e.key==='ArrowLeft')send({type:'pan',dx:-20,dy:0});
 else if(e.key==='ArrowRight')send({type:'pan',dx:20,dy:0});
 else if(e.key==='ArrowUp')send({type:'pan',dx:0,dy:20});
 else if(e.key==='ArrowDown')send({type:'pan',dx:0,dy:-20});
 else send({type:'key',key:e.key});});
</script></body></html>"""


def encode(img: np.ndarray, fmt: str, **kw) -> bytes:
    """A u8[h, w, 3] frame as PNG or JPEG bytes (Pillow)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt, **kw)
    return buf.getvalue()


class LiveServer:
    """Engine-stepping loop and frame producer shared by all HTTP clients."""

    def __init__(self, engine, camera, w: int = 640, h: int = 384,
                 fps: float = 15.0, step_frames: int = 3):
        from permafrost_engine_tpu_torch.render.scene import SceneRenderer
        from permafrost_engine_tpu_torch.script import pf

        self.engine = engine
        self.camera = camera
        self.renderer = SceneRenderer(engine, w, h)
        self.fps = fps
        self.step_frames = step_frames
        # streamed frames carry no OS cursor: compose the engine's cursor
        # glyph (pf cursor styling state) into each frame
        if pf._context is not None and pf._context.engine is engine:
            pf._context.cursor["compose"] = True
        self.lock = threading.Lock()
        self.frame_jpeg = b""
        self.running = True
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()

    def stop(self):
        self.running = False

    def render_frame(self) -> np.ndarray:
        """The current frame, u8[h, w, 3] on the host."""
        with self.lock:
            return self.renderer.render(self.camera)

    def _loop(self):
        while self.running:
            t0 = time.time()
            with self.lock:
                self.engine.step(self.step_frames)
                img = self.renderer.render(self.camera)
            self.frame_jpeg = encode(img, "JPEG", quality=85)
            dt = time.time() - t0
            time.sleep(max(0.0, 1.0 / self.fps - dt))

    # -- input (the browser sends viewport fractions; scale to virtual res) --

    def handle_input(self, msg: dict):
        from permafrost_engine_tpu_torch.script import pf

        ctx = pf.context()
        vw, vh = ctx.ui.virtual_resolution
        with self.lock:
            t = msg.get("type")
            if t == "click":
                pf.inject_mouse_click(msg["x"] * vw, msg["y"] * vh,
                                      int(msg.get("button", 1)))
            elif t == "motion":
                pf.inject_mouse_motion(msg["x"] * vw, msg["y"] * vh)
            elif t == "pan":
                self.camera.pan(float(msg.get("dx", 0)) * 5,
                                float(msg.get("dy", 0)) * 5)
            elif t == "key":
                k = msg.get("key", "")
                if k == "m":
                    pf.set_move_on_left_click()
                elif k == "a":
                    pf.set_attack_on_left_click()


def make_handler(server: LiveServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                self._send(PAGE.encode(), "text/html")
            elif self.path == "/frame.png":
                self._send(encode(server.render_frame(), "PNG"), "image/png")
            elif self.path == "/stream":
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame")
                self.end_headers()
                try:
                    while server.running:
                        jpg = server.frame_jpeg
                        if jpg:
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/jpeg\r\n"
                                b"Content-Length: "
                                + str(len(jpg)).encode() + b"\r\n\r\n"
                                + jpg + b"\r\n")
                        time.sleep(1.0 / server.fps)
                except (BrokenPipeError, ConnectionResetError):
                    pass
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path == "/input":
                n = int(self.headers.get("Content-Length", 0))
                try:
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    server.handle_input(msg)
                    self.send_response(204)
                    self.end_headers()
                except Exception as e:  # noqa: BLE001 — report to client
                    self.send_error(400, str(e))
            else:
                self.send_error(404)

    return Handler


def default_scenario(units: int, device="cuda"):
    """Two armies of `units` at war on rolling terrain with a lake, side 1
    hunting side 0, and a camera over the field. Returns (engine, camera,
    side 0's uids); the engine is ``pf``'s."""
    from permafrost_engine_tpu_torch.core.config import DiplomacyState, EngineConfig
    from permafrost_engine_tpu_torch.game.engine import Engine
    from permafrost_engine_tpu_torch.render.camera import Camera
    from permafrost_engine_tpu_torch.script import pf

    cfg = EngineConfig(max_ents=2 * units + 32)
    eng = Engine(cfg, device=device)
    eng.add_faction(0)
    eng.add_faction(1)
    eng.set_diplomacy(0, 1, DiplomacyState.WAR)

    h, w = cfg.field_h, cfg.field_w
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    heights = 3 + 3 * np.sin(xx / 24) * np.cos(yy / 20)
    heights[(xx - 60) ** 2 + (yy - 190) ** 2 < 900] = -3.0
    eng.heights = heights.astype(np.float32)

    rng = np.random.default_rng(0)
    a = eng.spawn_batch(np.stack([rng.uniform(350, 420, units),
                                  rng.uniform(420, 490, units)], 1)
                        .astype(np.float32), faction=0, max_speed=12.0)
    b = eng.spawn_batch(np.stack([rng.uniform(560, 630, units),
                                  rng.uniform(420, 490, units)], 1)
                        .astype(np.float32), faction=1, max_speed=12.0)
    eng.seek_enemies(b)
    pf.init(engine=eng)
    cam = Camera(pos=np.array([490.0, 110.0, 610.0]), pitch=-42.0, yaw=90.0)
    pf.set_active_camera(cam)
    return eng, cam, a


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--units", type=int, default=64)
    ap.add_argument("--wh", default="640x384")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = ap.parse_args(argv)

    eng, cam, _ = default_scenario(args.units,
                                   device="cpu" if args.cpu else "cuda")
    w, h = (int(x) for x in args.wh.split("x"))
    cam.aspect = w / h
    live = LiveServer(eng, cam, w, h)
    live.start()
    httpd = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(live))
    print(f"live viewer on http://localhost:{args.port}/ "
          f"({w}x{h}, {args.units} units/side)")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        live.stop()


if __name__ == "__main__":
    main()
