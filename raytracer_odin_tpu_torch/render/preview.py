"""Headless live preview, the replacement for the reference's SDL2 debug
window (debug.odin:12-152; port of raytracer_odin_tpu/render/preview.py).

Two facilities:

  * snapshot writing: every N seconds the current accumulator is tone-mapped
    and written to a PNG/PPM file (any layer and mode), optionally with the
    world-space debug-line overlay (BVH level boxes) that the reference
    draws with its X/C keys (debug.odin:127-146).

  * a small HTTP server (`--preview-port`, bound to 127.0.0.1): GET / serves
    an HTML page that polls the latest frame; GET
    /frame.png?layer=1&mode=variance&lines=2&pixel=x,y selects the layer
    (keys 1-0 in the reference), the output mode (Q-W-E-R-T...), the BVH
    overlay level and the pixel whose ray paths are drawn: the keyboard and
    mouse of debug.odin:51-75, 102-125 mapped onto query parameters.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from raytracer_odin_tpu_torch.io import png as png_codec
from raytracer_odin_tpu_torch.render import output as output_mod
from raytracer_odin_tpu_torch.utils.math3d import line_to_screen


def draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Clipped segment draw on a uint8 HxWx3 image."""
    h, w, _ = img.shape
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    xs = np.linspace(x0, x1, n).astype(int)
    ys = np.linspace(y0, y1, n).astype(int)
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = np.clip(np.asarray(color) * 255, 0,
                                  255).astype(np.uint8)


def bvh_debug_lines(flat_bvh, max_level: int | None = None):
    """AABB wireframes per BVH level (finish_scene's rc_log_aabb walk,
    raytracer.odin:78-90) of a DeviceBVH on any device. Returns a list of
    (a, b, color, level) world segments, 12 a node, of every node or of
    the nodes at `max_level` (the root is level 1)."""
    lo = flat_bvh.lo.cpu().numpy()
    hi = flat_bvh.hi.cpu().numpy()
    n = lo.shape[0]
    count = flat_bvh.count.cpu().numpy()
    hit = flat_bvh.hit_link[0].cpu().numpy()
    miss = flat_bvh.miss_link[0].cpu().numpy()
    # Levels from the octant-0 links: a branch's hit link is its first
    # child, whose miss link is its sibling.
    level = np.zeros(n, np.int32)
    stack = [(0, 1)]
    seen = set()
    while stack:
        node, lev = stack.pop()
        if node >= n or node in seen:
            continue
        seen.add(node)
        level[node] = lev
        if count[node] == 0:
            first_child = hit[node]
            second_child = miss[first_child] if first_child < n else n
            stack.append((first_child, lev + 1))
            if second_child < n:
                stack.append((second_child, lev + 1))
    segs = []
    for i in range(n):
        if max_level is not None and level[i] != max_level:
            continue
        a, b = lo[i], hi[i]
        c = [1.0, 1.0 - 0.1 * (level[i] % 8), 0.2 * (level[i] % 5)]
        for s, e in _box_edges(a, b):
            segs.append((s, e, c, int(level[i])))
    return segs


def _box_edges(a, b):
    def pts(x, y, z):
        return np.array([x, y, z], np.float32)

    return [
        (pts(a[0], a[1], a[2]), pts(b[0], a[1], a[2])),
        (pts(a[0], b[1], a[2]), pts(b[0], b[1], a[2])),
        (pts(a[0], a[1], b[2]), pts(b[0], a[1], b[2])),
        (pts(a[0], b[1], b[2]), pts(b[0], b[1], b[2])),
        (pts(a[0], a[1], a[2]), pts(a[0], b[1], a[2])),
        (pts(b[0], a[1], a[2]), pts(b[0], b[1], a[2])),
        (pts(a[0], a[1], b[2]), pts(a[0], b[1], b[2])),
        (pts(b[0], a[1], b[2]), pts(b[0], b[1], b[2])),
        (pts(a[0], a[1], a[2]), pts(a[0], a[1], b[2])),
        (pts(b[0], a[1], a[2]), pts(b[0], a[1], b[2])),
        (pts(a[0], b[1], a[2]), pts(a[0], b[1], b[2])),
        (pts(b[0], b[1], a[2]), pts(b[0], b[1], b[2])),
    ]


class Preview:
    """Holds the latest stats snapshot and renders frames from it on demand.

    With `scene` and `ray_depth`, ?pixel=x,y on /frame.png (frame(pixel=))
    overlays the ray paths of that pixel (the EXPENSIVE_DEBUG hover feature,
    debug.odin:102-125, via render/debug_rays.py): by default the paths the
    render sampled, re-traced on the scene's device through `intersector`;
    with pixel_src="oracle" the numpy oracle's."""

    def __init__(self, cam_pos, cam_basis, fov_x, dims, flat_bvh=None,
                 scene=None, ray_depth=8, seed=0, intersector="auto"):
        self.cam_pos = np.asarray(cam_pos)
        self.cam_basis = np.asarray(cam_basis)
        self.fov_x = fov_x
        self.dims = dims
        self.flat_bvh = flat_bvh
        self.scene = scene
        self.ray_depth = ray_depth
        self.seed = seed
        self.intersector = intersector
        self._lock = threading.Lock()
        self._stats = None
        self.samples_done = 0
        self._server = None

    def update(self, stats, samples_done: int) -> None:
        with self._lock:
            self._stats = stats
            self.samples_done = samples_done

    def frame(self, layer=0, mode="mean", lines_level=None,
              pixel=None, pixel_src="device") -> np.ndarray | None:
        """The frame of `layer` in `mode` as uint8 [H, W, 3] (None before
        the first update), with the BVH boxes of `lines_level` and the
        paths through `pixel` (image x, row) drawn over it."""
        with self._lock:
            stats = self._stats
        if stats is None:
            return None
        layer = min(layer, stats.count.shape[0] - 1)
        img = output_mod.layer_to_rgb(stats, layer, mode).copy()
        if lines_level is not None and self.flat_bvh is not None:
            for a, b, color, _ in bvh_debug_lines(self.flat_bvh, lines_level):
                s0, s1, ok = line_to_screen(
                    self.cam_pos, self.cam_basis, self.fov_x, self.dims, a, b
                )
                if ok:
                    draw_line(img, s0, s1, color)
        if pixel is not None and self.scene is not None:
            from raytracer_odin_tpu_torch.render import debug_rays

            px, py_img = pixel
            py = self.dims[1] - 1 - py_img  # image row -> reference y (up)
            if pixel_src == "oracle":
                segs = debug_rays.trace_pixel_paths(
                    self.scene, self.dims[0], self.dims[1], self.fov_x,
                    self.ray_depth, px, py, seed=self.seed)
            else:
                segs = debug_rays.trace_pixel_paths_device(
                    self.scene, self.dims[0], self.dims[1], self.fov_x,
                    self.ray_depth, px, py, seed=self.seed,
                    intersector=self.intersector)
            for seg in segs:
                s0, s1, ok = line_to_screen(
                    self.cam_pos, self.cam_basis, self.fov_x, self.dims,
                    seg.origin, seg.end,
                )
                if ok:
                    draw_line(img, s0, s1, seg.color)
        return img

    # -- HTTP ---------------------------------------------------------------

    def serve(self, port: int) -> int:
        """Serve the preview on 127.0.0.1:`port` (0 picks a free port) from
        a daemon thread; returns the port. stop() shuts it down."""
        preview = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                parsed = urlparse(self.path)
                if parsed.path == "/":
                    body = _index_html().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if parsed.path == "/frame.png":
                    q = parse_qs(parsed.query)
                    layer = int(q.get("layer", ["0"])[0])
                    mode = q.get("mode", ["mean"])[0]
                    lines = q.get("lines", [None])[0]
                    lines_level = (int(lines)
                                   if lines not in (None, "", "off") else None)
                    pix = q.get("pixel", [None])[0]
                    pixel = None
                    if pix:
                        xy = pix.split(",")
                        pixel = (int(xy[0]), int(xy[1]))
                    src = q.get("src", ["device"])[0]
                    img = preview.frame(layer, mode, lines_level, pixel, src)
                    if img is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    data = png_codec.encode(img)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(data)
                    return
                self.send_response(404)
                self.end_headers()

        self._server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self._server.server_address[1]

    def stop(self):
        if self._server:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def _index_html() -> str:
    """Built per request, so probes registered through ops/probes.py show
    up in the layer selector by name."""
    from raytracer_odin_tpu_torch.ops import probes

    options = "".join(
        f"<option value={i}>{i}: {name}</option>"
        for i, name in enumerate(probes.layer_names())
    )
    return _INDEX_HTML_HEAD + options + _INDEX_HTML_TAIL


_INDEX_HTML_HEAD = """<!doctype html>
<title>raytracer_odin_tpu_torch preview</title>
<style>body{background:#111;color:#ddd;font-family:monospace}</style>
<p>
layer <select id=layer>"""

_INDEX_HTML_TAIL = """</select>
mode <select id=mode><option>mean</option><option>variance</option>
<option>first</option><option>last</option><option>count</option>
<option>weight</option><option>hash</option><option>naninf</option></select>
bvh-level <input id=lines size=3 placeholder=off>
</p>
<img id=f style="image-rendering:pixelated;width:80%">
<script>
async function tick(){
  const l=document.getElementById('layer').value;
  const m=document.getElementById('mode').value;
  const ln=document.getElementById('lines').value;
  document.getElementById('f').src=`/frame.png?layer=${l}&mode=${m}&lines=${ln}&t=${Date.now()}`;
}
setInterval(tick, 1000); tick();
</script>
"""


class SnapshotWriter:
    """Periodic on_step hook writing the current frame to a file."""

    def __init__(self, preview: Preview, path, every_s: float = 2.0,
                 layer=0, mode="mean"):
        self.preview = preview
        self.path = path
        self.every_s = every_s
        self.layer = layer
        self.mode = mode
        self._last = 0.0

    def __call__(self, stats, samples_done):
        self.preview.update(stats, samples_done)
        now = time.time()
        if now - self._last >= self.every_s:
            self._last = now
            img = self.preview.frame(self.layer, self.mode)
            if img is not None:
                from raytracer_odin_tpu_torch.io import writers

                writers.save_image(self.path, img)
