"""Browser-based interactive hierarchy viewer (counterpart of
``h3dgs_tpu/viewer/web.py``).

Serves a zero-dependency web page (stdlib ``http.server``; orbit / pan /
zoom in inline JS) that streams frames rendered by
:class:`~h3dgs_tpu_torch.viewer.service.HierarchyRenderer`.

Endpoints:
  ``/``            the viewer page (inline HTML+JS, no external assets)
  ``/info``        scene bounds + camera defaults (JSON)
  ``/frame?...``   one rendered frame (JPEG) with ``X-Cut-*`` stat headers

Frame parameters: ``ex,ey,ez`` eye, ``tx,ty,tz`` look-at target, ``fovx``
(radians), ``w,h`` resolution, ``tau`` granularity, ``q`` JPEG quality
(default the viewer's ``quality``, 85), as in the JAX viewer. A frame is
``encode_jpeg(renderer.render(...), q)`` (``io/jpeg_encode.py``, the
port's own encoder: the card's machine has no PIL), the bytes PIL's
encoder gives the JAX viewer. The render path is the service's
tau-budgeted, cut-cached pipeline (K1): rotating in place reuses the
cached cut, and a repeated request (same pose and ``q``) the last frame's
bytes.
"""
from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..io import jpeg_encode
from ..scene.camera import look_at_camera
from .service import HierarchyRenderer

MAX_DIM = 4096  # reject absurd resolutions

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>h3dgs viewer</title>
<style>
  html,body{margin:0;height:100%;background:#101014;color:#cfcfd8;
            font:13px system-ui,sans-serif;overflow:hidden}
  #view{position:absolute;inset:0;width:100%;height:100%;
        object-fit:contain;image-rendering:auto;cursor:grab}
  #hud{position:absolute;left:10px;top:10px;background:#000a;
       padding:8px 10px;border-radius:6px;white-space:pre;line-height:1.5}
  #help{position:absolute;right:10px;top:10px;background:#000a;
        padding:8px 10px;border-radius:6px;text-align:right}
  select{background:#222;color:#cfcfd8;border:1px solid #444}
</style></head><body>
<img id="view" draggable="false">
<div id="hud">connecting…</div>
<div id="help">drag orbit · shift-drag pan · wheel zoom<br>
[ / ] tau · res <select id="res">
<option>640x360</option><option selected>960x540</option>
<option>1280x720</option><option>1920x1080</option></select></div>
<script>
"use strict";
let az=0, el=-0.3, radius=10, target=[0,0,0], tau=6.0, fovx=1.2;
let W=960, H=540, inflight=false, dirty=true, lastT=performance.now();
const img=document.getElementById("view"), hud=document.getElementById("hud");

function eye(){
  return [target[0]+radius*Math.cos(el)*Math.sin(az),
          target[1]+radius*Math.sin(el),
          target[2]-radius*Math.cos(el)*Math.cos(az)];
}
async function frame(){
  if(inflight) return; inflight=true; dirty=false;
  const e=eye();
  const u=`/frame?ex=${e[0]}&ey=${e[1]}&ez=${e[2]}`+
          `&tx=${target[0]}&ty=${target[1]}&tz=${target[2]}`+
          `&fovx=${fovx}&w=${W}&h=${H}&tau=${tau}`;
  try{
    const r=await fetch(u);
    if(r.ok){
      const b=await r.blob();
      const old=img.src; img.src=URL.createObjectURL(b);
      if(old) URL.revokeObjectURL(old);
      const now=performance.now(), fps=1000/(now-lastT); lastT=now;
      hud.textContent=`tau ${tau.toFixed(1)}  cut ${r.headers.get("X-Cut-Size")}`+
        `${r.headers.get("X-Cut-Reused")==="1"?" (cached)":""}\n`+
        `${W}x${H}  ${fps.toFixed(1)} fps`;
    } else { hud.textContent=`error ${r.status}: ${await r.text()}`; }
  } catch(err){ hud.textContent=String(err); }
  inflight=false;
  if(dirty) frame();  // otherwise idle: events re-trigger rendering
}
let drag=null;
img.addEventListener("pointerdown",ev=>{drag=[ev.clientX,ev.clientY,ev.shiftKey];
                                        img.setPointerCapture(ev.pointerId);});
img.addEventListener("pointerup",()=>drag=null);
img.addEventListener("pointermove",ev=>{
  if(!drag) return;
  const dx=ev.clientX-drag[0], dy=ev.clientY-drag[1];
  drag=[ev.clientX,ev.clientY,drag[2]];
  if(drag[2]||ev.buttons&2){ // pan in the view plane
    const s=radius*0.0015, e=eye();
    const f=[target[0]-e[0],target[1]-e[1],target[2]-e[2]];
    const fl=Math.hypot(...f); f.forEach((v,i)=>f[i]=v/fl);
    const r=[f[2],0,-f[0]]; const rl=Math.hypot(...r)||1; r.forEach((v,i)=>r[i]=v/rl);
    const up=[r[1]*f[2]-r[2]*f[1], r[2]*f[0]-r[0]*f[2], r[0]*f[1]-r[1]*f[0]];
    for(let i=0;i<3;i++) target[i]+=(-dx*r[i]+dy*up[i])*s;
  } else { az+=dx*0.005; el=Math.max(-1.5,Math.min(1.5,el-dy*0.005)); }
  dirty=true; frame();
});
img.addEventListener("wheel",ev=>{radius*=Math.exp(ev.deltaY*0.001);
                                  dirty=true; frame(); ev.preventDefault();});
img.addEventListener("contextmenu",ev=>ev.preventDefault());
window.addEventListener("keydown",ev=>{
  if(ev.key==="[") tau=Math.max(0,tau-0.5);
  else if(ev.key==="]") tau+=0.5;
  else return;
  dirty=true; frame();
});
document.getElementById("res").addEventListener("change",ev=>{
  [W,H]=ev.target.value.split("x").map(Number); dirty=true; frame();
});
fetch("/info").then(r=>r.json()).then(i=>{
  target=i.center; radius=i.radius; tau=i.tau; dirty=true; frame();
});
</script></body></html>
"""



class WebViewer:
    """HTTP front end over a HierarchyRenderer (frames serialise on a
    lock: the renderer's cut cache is single-slot)."""

    def __init__(self, renderer: HierarchyRenderer, host: str = "127.0.0.1",
                 port: int = 8090, tau: float = 6.0, quality: int = 85):
        self.renderer = renderer
        self.tau = tau
        self.quality = quality
        # Build the C++ encoder now: a failed build stops the viewer here,
        # and the first frame does not wait for the compiler.
        jpeg_encode._native_encoder()
        self._lock = threading.Lock()
        self._last_frame = None  # (request key, jpeg bytes, stats)
        boxes = np.asarray(renderer.h.boxes)
        lo = boxes[:, 0].min(axis=0)
        hi = boxes[:, 1].max(axis=0)
        self.center = ((lo + hi) / 2).tolist()
        self.radius = float(max(np.linalg.norm(hi - lo) * 0.75, 1e-3))
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            # Keep-alive: every response carries Content-Length, and a
            # per-frame TCP handshake would add an RTT to every
            # interactive frame on a remote link.
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # keep the serving terminal quiet
                pass

            def do_GET(self):
                try:
                    viewer._route(self)
                except BrokenPipeError:
                    pass  # client navigated away mid-frame
                except Exception as ex:  # noqa: BLE001 — serve must survive
                    try:
                        self.send_error(500, str(ex)[:200])
                    except Exception:
                        pass

        self.server = ThreadingHTTPServer((host, port), Handler)
        self._thread = None

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    @staticmethod
    def _send(req, body: bytes, content_type: str, headers=()):
        req.send_response(200)
        req.send_header("Content-Type", content_type)
        req.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            req.send_header(k, v)
        req.end_headers()
        req.wfile.write(body)

    def _route(self, req):
        url = urlparse(req.path)
        if url.path == "/":
            self._send(req, _PAGE.encode("utf-8"),
                       "text/html; charset=utf-8")
        elif url.path == "/info":
            body = json.dumps({
                "center": self.center, "radius": self.radius,
                "tau": self.tau, "n_nodes": int(self.renderer.h.n_nodes),
                "budget": int(self.renderer.budget)}).encode()
            self._send(req, body, "application/json")
        elif url.path == "/frame":
            self._frame(req, parse_qs(url.query))
        else:
            req.send_error(404)

    def _frame(self, req, q):
        def f(name, default):
            v = float(q[name][0]) if name in q else default
            if not math.isfinite(v):
                raise ValueError(f"non-finite {name}")
            return v

        try:
            w = int(f("w", 960))
            h = int(f("h", 540))
            if not (16 <= w <= MAX_DIM and 16 <= h <= MAX_DIM):
                raise ValueError(f"resolution out of range: {w}x{h}")
            c = self.center
            eye = (f("ex", c[0]), f("ey", c[1]), f("ez", c[2] - self.radius))
            target = (f("tx", c[0]), f("ty", c[1]), f("tz", c[2]))
            fovx = f("fovx", 1.2)
            if not 0.0 < fovx < math.pi:
                raise ValueError(f"fovx out of range: {fovx}")
            tau = f("tau", self.tau)
            quality = int(f("q", self.quality))
        except (ValueError, TypeError) as ex:
            req.send_error(400, str(ex)[:200])  # client error, not a 500
            return
        cam = look_at_camera(eye=eye, target=target, fovx=fovx,
                             width=w, height=h)
        key = (eye, target, fovx, w, h, tau, quality)
        with self._lock:
            # Clients re-requesting the same pose get the cached frame:
            # identical frames are bit-identical.
            if self._last_frame is not None and self._last_frame[0] == key:
                _, body, stats = self._last_frame
            else:
                img, stats = self.renderer.render(cam, tau=tau)
                body = jpeg_encode.encode_jpeg(img, quality)
                self._last_frame = (key, body, stats)
        self._send(req, body, "image/jpeg", (
            ("Cache-Control", "no-store"),
            ("X-Cut-Size", str(stats["cut_size"])),
            ("X-Cut-Reused", "1" if stats["cut_reused"] else "0"),
            ("X-Limit", f"{stats['limit']:.6g}")))

    def start(self):
        """Serve on a background thread (tests / embedding)."""
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def serve_forever(self):
        print(f"h3dgs web viewer on http://{self.server.server_address[0]}"
              f":{self.port}/", flush=True)
        self.server.serve_forever()
