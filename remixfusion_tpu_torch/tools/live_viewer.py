"""Live SLAM viewer served over HTTP.

Counterpart of remixfusion_tpu.tools.live_viewer (the headless replacement
for the reference's open3d live viewer, reference tools/viz.py:1-210 +
tools/visualizer.py:1-117): a daemon-thread HTTP server publishes the
latest reconstruction render (or input frame), the estimated-vs-GT
trajectory and live timing stats to any browser. Publishing is a lock and
an array reference swap; encoding happens per HTTP request, so an
unwatched run pays nothing more. RemixFusionTorch starts one when the
config sets viz.live (1: any free port, else that port).

Endpoints:
  /            one-page viewer (polls the two below)
  /frame       latest published frame (JPEG where imageio can write one,
               else BMP -- both render in any browser)
  /state.json  frame index, fps, downsampled est/gt trajectories, stats
"""

from __future__ import annotations

import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>remixfusion_tpu_torch live</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:16px}
#row{display:flex;gap:16px;flex-wrap:wrap}
img,canvas{border:1px solid #444;image-rendering:pixelated}
#stats{margin-top:8px;white-space:pre}
</style></head><body>
<h3>remixfusion_tpu_torch &mdash; live</h3>
<div id="row">
  <img id="frame" width="480" alt="waiting for first frame">
  <canvas id="traj" width="360" height="360"></canvas>
</div>
<div id="stats">connecting...</div>
<script>
const img = document.getElementById('frame');
const cv = document.getElementById('traj');
const ctx = cv.getContext('2d');
function drawTraj(est, gt){
  ctx.fillStyle = '#181818'; ctx.fillRect(0, 0, cv.width, cv.height);
  const pts = est.concat(gt);
  if (!pts.length) return;
  let xs = pts.map(p => p[0]), zs = pts.map(p => p[2]);
  const x0 = Math.min(...xs), x1 = Math.max(...xs);
  const z0 = Math.min(...zs), z1 = Math.max(...zs);
  const s = 0.9 * Math.min(cv.width / Math.max(1e-6, x1 - x0),
                           cv.height / Math.max(1e-6, z1 - z0));
  const px = p => [cv.width/2 + s*(p[0]-(x0+x1)/2),
                   cv.height/2 + s*(p[2]-(z0+z1)/2)];
  const poly = (tr, color) => {
    if (!tr.length) return;
    ctx.strokeStyle = color; ctx.beginPath();
    tr.forEach((p, i) => { const q = px(p);
      i ? ctx.lineTo(q[0], q[1]) : ctx.moveTo(q[0], q[1]); });
    ctx.stroke();
  };
  poly(gt, '#3a7');
  poly(est, '#e83');
  if (est.length){ const q = px(est[est.length-1]);
    ctx.fillStyle = '#e83'; ctx.beginPath();
    ctx.arc(q[0], q[1], 4, 0, 6.3); ctx.fill(); }
}
async function tick(){
  try {
    const r = await fetch('state.json'); const st = await r.json();
    img.src = 'frame?t=' + st.seq;
    drawTraj(st.est || [], st.gt || []);
    let txt = 'frame ' + st.frame + (st.n ? '/' + st.n : '');
    if (st.fps) txt += '   ' + st.fps.toFixed(1) + ' fps';
    for (const [k, v] of Object.entries(st.extra || {}))
      txt += '\\n' + k + ': ' + v;
    document.getElementById('stats').textContent = txt;
  } catch (e) {
    document.getElementById('stats').textContent = 'disconnected';
  }
  setTimeout(tick, 500);
}
tick();
</script></body></html>"""


def encode_bmp(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> BMP bytes (24-bit, bottom-up): the viewer's
    encoder where no JPEG writer is installed."""
    h, w = rgb.shape[:2]
    row = w * 3
    pad = (-row) % 4
    body = np.zeros((h, row + pad), np.uint8)
    # BMP stores BGR bottom-up
    body[:, :row] = rgb[::-1, :, ::-1].reshape(h, row)
    data = body.tobytes()
    off = 14 + 40
    header = struct.pack("<2sIHHI", b"BM", off + len(data), 0, 0, off)
    dib = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(data),
                      2835, 2835, 0, 0)
    return header + dib + data


def _encode_frame(rgb: np.ndarray):
    """(bytes, content_type) for a uint8 [H, W, 3] frame: JPEG through
    imageio where it is installed with a JPEG writer, else BMP."""
    try:
        import imageio.v2 as imageio
        return imageio.imwrite("<bytes>", rgb, format="jpg"), "image/jpeg"
    except (ImportError, ValueError, RuntimeError, OSError):
        return encode_bmp(rgb), "image/bmp"


class LiveViewer:
    """Thread-safe publish side + daemon HTTP server.

    publish_frame(rgb) and publish_state(...) are called from the SLAM
    loop; encoding is deferred to request time and cached per sequence
    number, so an unwatched run pays only the reference swap."""

    def __init__(self, port: int = 0, host: str = "0.0.0.0"):
        self._lock = threading.Lock()
        self._frame = None          # uint8 [H, W, 3]
        self._encoded = None        # (seq, bytes, ctype) cache
        self._seq = 0
        self._state = {"frame": 0, "seq": 0}
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif path == "/state.json":
                    with viewer._lock:
                        st = dict(viewer._state, seq=viewer._seq)
                    self._send(200, "application/json",
                               json.dumps(st).encode())
                elif path == "/frame":
                    body = viewer._encoded_frame()
                    if body is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, body[1], body[0])
                else:
                    self._send(404, "text/plain", b"not found")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="live-viewer")
        self._thread.start()

    # ------------------------------------------------------- publish side
    def publish_frame(self, rgb: np.ndarray):
        """rgb: float [0,1] or uint8, [H, W, 3]. Cheap (no encode)."""
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0.0, 1.0) * 255).astype(np.uint8)
        with self._lock:
            self._frame = rgb
            self._seq += 1

    def publish_state(self, frame: int, n: int = 0, fps: float = 0.0,
                      est=None, gt=None, extra=None, max_pts: int = 400):
        """est/gt: [K, 4, 4] pose arrays (or [K, 3] positions)."""
        def positions(poses):
            if poses is None or len(poses) == 0:
                return []
            p = np.asarray(poses, np.float32)
            pts = p[:, :3, 3] if p.ndim == 3 else p[:, :3]
            step = max(1, len(pts) // max_pts)
            return pts[::step].round(4).tolist()

        st = {"frame": int(frame), "n": int(n), "fps": float(fps),
              "est": positions(est), "gt": positions(gt),
              "extra": extra or {}}
        with self._lock:
            self._state = st

    # -------------------------------------------------------- serve side
    def _encoded_frame(self):
        with self._lock:
            frame, seq = self._frame, self._seq
            cached = self._encoded
        if frame is None:
            return None
        if cached is not None and cached[0] == seq:
            return cached[1], cached[2]
        body, ctype = _encode_frame(frame)
        with self._lock:
            self._encoded = (seq, body, ctype)
        return body, ctype

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5)
