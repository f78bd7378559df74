"""Interactive progressive-preview app over HTTP (the mtsgui analog).

The reference's GUI (src/qtgui + libhw) is a Qt viewport fed by
PreviewThread: VPL passes refine while the camera moves, then the full
integrator accumulates (qtgui/preview.h:40). There is no display server
on a headless accelerator host, so the viewport here is a browser page served by a stdlib
HTTP server:

  * a background render thread accumulates progressive passes of the
    REAL integrator into a FilmCheckpoint (render/preview.py), starting
    with a one-frame VPL pass for instant feedback — the same
    warm-start/refine split as the reference;
  * the page polls /frame.png (tonemapped latest accumulation) and
    /state (pass count, spp, generation);
  * dragging orbits the camera, wheel dollies: /camera?yaw=&pitch=&dolly=
    rebuilds the camera transform and restarts accumulation — the
    interactivity the reference gets from PreviewThread restarts.

Run: python -m mitsuba_jax scene.xml --gui [--port 8555]
Everything is stdlib (http.server, threading) + the renderer itself.
"""
from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>mitsuba_jax preview</title><style>
body{background:#181818;color:#ccc;font:13px monospace;margin:14px}
#c{border:1px solid #444;image-rendering:pixelated;cursor:grab}
</style></head><body>
<div id="s">connecting...</div>
<canvas id="c"></canvas>
<script>
const c=document.getElementById('c'),s=document.getElementById('s');
let gen=0,drag=null;
async function state(){return (await fetch('/state')).json()}
async function loop(){
  try{
    const st=await state();
    c.width=st.width;c.height=st.height;
    s.textContent=`pass ${st.pass}  ${st.spp} spp  gen ${st.gen}`;
    const img=new Image();
    img.onload=()=>c.getContext('2d').drawImage(img,0,0);
    img.src='/frame.png?g='+st.gen+'_'+st.pass;
  }catch(e){s.textContent='disconnected'}
  setTimeout(loop,500)}
loop();
c.onmousedown=e=>{drag=[e.clientX,e.clientY]};
window.onmouseup=()=>{drag=null};
window.onmousemove=e=>{if(!drag)return;
  const dx=e.clientX-drag[0],dy=e.clientY-drag[1];drag=[e.clientX,e.clientY];
  fetch(`/camera?yaw=${dx*0.01}&pitch=${dy*0.01}`)};
c.onwheel=e=>{e.preventDefault();
  fetch(`/camera?dolly=${e.deltaY>0?1.1:0.9}`)};
</script></body></html>"""


class PreviewSession:
    """Render loop + camera state shared with the HTTP handlers."""

    def __init__(self, scene, cfg, exposure_ev: float = 0.0,
                 vpl_first: bool = True):
        from mitsuba_jax.core import transform as tf

        self.scene = scene
        self.cfg = cfg
        self.exposure = exposure_ev
        self.vpl_first = vpl_first
        self.lock = threading.Lock()
        self.png = b""
        self.pass_i = 0
        self.spp_total = 0
        self.gen = 0            # bumped on camera change -> restart
        self.stop = False
        # camera orbit state from the scene's to_world
        m = np.asarray(scene.camera.to_world)
        self.origin = m[:3, 3].copy()
        fwd = m[:3, :3] @ np.array([0.0, 0.0, 1.0])
        v0 = np.asarray(scene.geom.v0)
        extent = float(np.linalg.norm(v0.max(0) - v0.min(0)))
        self.target = self.origin + fwd * max(extent * 0.5, 1e-3)
        self.up = np.array([0.0, 1.0, 0.0])
        self._tf = tf

    # --- camera ------------------------------------------------------------
    def orbit(self, yaw: float = 0.0, pitch: float = 0.0,
              dolly: float = 1.0) -> None:
        from mitsuba_jax.core.types import replace

        with self.lock:
            r = self.origin - self.target
            cy, sy = np.cos(yaw), np.sin(yaw)
            r = np.array([cy * r[0] + sy * r[2], r[1],
                          -sy * r[0] + cy * r[2]])
            # pitch about the camera-right axis
            right = np.cross(self.up, -r)
            rn = np.linalg.norm(right)
            if rn > 1e-9:
                right /= rn
                cp, sp = np.cos(pitch), np.sin(pitch)
                r = (r * cp + np.cross(right, r) * sp
                     + right * np.dot(right, r) * (1 - cp))
            self.origin = self.target + r * dolly
            cam = self.scene.camera
            new_to_world = self._tf.look_at(self.origin.tolist(),
                                            self.target.tolist(),
                                            self.up.tolist())
            import jax.numpy as jnp

            self.scene = replace(
                self.scene,
                camera=replace(cam, to_world=jnp.asarray(new_to_world)))
            self.gen += 1

    # --- render loop -------------------------------------------------------
    def _encode(self, img) -> bytes:
        from mitsuba_jax.io.bitmap import write_png
        from mitsuba_jax.utils.tonemap import tonemap

        arr = tonemap(np.asarray(img), exposure_ev=self.exposure)
        buf = io.BytesIO()
        write_png(buf, arr)
        return buf.getvalue()

    def run(self, max_passes: int = 10 ** 9) -> None:
        from mitsuba_jax.integrators.path import render
        from mitsuba_jax.render.preview import vpl_preview
        from mitsuba_jax.utils.checkpoint import FilmCheckpoint

        while not self.stop:
            with self.lock:
                gen = self.gen
                scene = self.scene
            fc = FilmCheckpoint(scene.height, scene.width)
            if self.vpl_first:
                try:
                    img = vpl_preview(scene)
                    with self.lock:
                        if self.gen == gen:
                            self.png = self._encode(img)
                            self.pass_i = 0
                except Exception:
                    pass        # VPL warm start is best-effort
            i = 0
            while not self.stop and i < max_passes:
                with self.lock:
                    if self.gen != gen:
                        break   # camera moved: restart accumulation
                img, _ = render(scene, self.cfg, seed=7919 * gen + i)
                fc.add_pass(img, self.cfg.spp)
                png = self._encode(fc.image)
                with self.lock:
                    if self.gen != gen:
                        break
                    self.png = png
                    self.pass_i = i + 1
                    self.spp_total = fc.count
                i += 1
            else:
                # pass budget exhausted: idle until a camera change
                while not self.stop:
                    with self.lock:
                        if self.gen != gen:
                            break
                    time.sleep(0.05)


def serve(scene, cfg, port: int = 8555, max_passes: int = 10 ** 9,
          open_msg: bool = True):
    """Start the preview app; returns (httpd, session, thread) so callers
    (and tests) can drive and shut it down."""
    session = PreviewSession(scene, cfg)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):           # quiet
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif u.path == "/state":
                with session.lock:
                    st = dict(width=session.scene.width,
                              height=session.scene.height,
                              gen=session.gen, spp=session.spp_total)
                    st["pass"] = session.pass_i
                self._send(200, "application/json",
                           json.dumps(st).encode())
            elif u.path == "/frame.png":
                with session.lock:
                    png = session.png
                if not png:
                    self._send(503, "text/plain", b"no frame yet")
                else:
                    self._send(200, "image/png", png)
            elif u.path == "/camera":
                q = {k: float(v[0])
                     for k, v in parse_qs(u.query).items()}
                session.orbit(q.get("yaw", 0.0), q.get("pitch", 0.0),
                              q.get("dolly", 1.0))
                self._send(200, "application/json", b"{}")
            else:
                self._send(404, "text/plain", b"not found")

    httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    t = threading.Thread(target=session.run, args=(max_passes,),
                         daemon=True)
    t.start()
    if open_msg:
        print(f"preview at http://127.0.0.1:{httpd.server_address[1]}/")
    return httpd, session, t
