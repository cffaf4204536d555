"""Interactive viewer of the PyTorch port -- the live analogue of the
reference's GLFW/ImGui app shell (``maverick-app``: include/app.h:33-37,
src/app.cpp:25-152), after the JAX package's ``utils/viewer.py``.

The reference GUI displays the double-buffered out image
(``outImages[currentIndex]``, flip at src/vk_processing.cpp:2109/2564,
frame advance src/app.cpp:133) plus the GPU-rendered noise-histogram and
gradation-curve textures registered as ImGui textures
(include/vk_processing.h:31-32, src/app.cpp:52-59), and exposes a
``debugProcess()`` button (src/app.cpp:97-99).  On a headless host the
window system is a browser: ``cli view`` serves the same surface over HTTP
from in-memory state.  The pipeline runs on the state's device under its
lock; the handler threads serve host copies of its results.  Images are
encoded with ``utils.io.bmp_bytes`` (the JAX package's viewer uses Pillow,
which the machines with the card lack).

Endpoints:
  GET  /            the viewer page (out image, render panels, stats)
  GET  /img/<name>  current BMP bytes from memory (no disk round trip)
  POST /execute     re-read the input raw and run the pipeline (the raw can
                    be replaced on disk between executes -- the analogue of
                    feeding a new exposure), flipping the double buffer
  POST /flip        show the other buffer (currentIndex flip)
  POST /debug       full intermediate dump to the report directory
                    (``debugProcess()``)
"""

from __future__ import annotations

import html
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..config import MusicaConfig
from ..models import musica
from . import render as rsh
from .debug import _to_u8, numpy_tree
from .io import bmp_bytes, load_raw


class ViewerState:
    """Pipeline state behind the HTTP surface.  One lock: the device runs
    one execute at a time (the reference likewise serializes on its compute
    queue)."""

    def __init__(self, raw_path: str, cfg: MusicaConfig, transpose: bool,
                 report_dir: str = "viewer_report", device="cuda"):
        self.raw_path = raw_path
        self.cfg = cfg
        self.transpose = transpose
        self.report_dir = report_dir
        self.device = device
        self.lock = threading.Lock()
        self.outputs: list[np.ndarray] = []   # double buffer, newest last
        self.current = 0                      # currentIndex analogue
        self.panels: dict[str, bytes] = {}    # rendered hist/curve BMPs
        self.stats: list[tuple[str, str]] = []
        self.n_executes = 0

    def execute(self) -> None:
        """One full pipeline pass (VulkanProcessing::execute analogue):
        re-reads the raw, processes, flips the double buffer, refreshes the
        render panels."""
        raw = load_raw(self.raw_path, self.cfg.image_size,
                       transpose=self.transpose)
        with self.lock:
            res = musica.musica_forward(musica.to_device(raw, self.device), self.cfg,
                                        want_intermediates=True)
            out = numpy_tree(res["out_u8"])
            inter = {k: numpy_tree(v) for k, v in res["intermediates"].items()}
            self.outputs = (self.outputs + [out])[-2:]
            self.current = len(self.outputs) - 1
            self._refresh_panels(numpy_tree(res["cnr"]), inter)
            self.n_executes += 1

    def _refresh_panels(self, cnr: np.ndarray, inter) -> None:
        cfg = self.cfg
        panels = {}
        for i in cfg.analysis_levels:
            hist = inter[f"noise_hist_{i}"]
            mb = int(inter[f"noise_max_bin_{i}"])
            panels[f"noise_hist_{i}"] = bmp_bytes(rsh.render_noise_hist(
                hist, int(hist[mb]), mb))
        gpx, gpy, tvals = inter["grad_curve"]
        ghist = inter["grad_hist"]
        gmb = int(np.argmax(ghist))
        t0, ta, t1 = (float(t) for t in tvals)
        panels["grad_curve"] = bmp_bytes(
            rsh.render_gradation_curve(gpx, gpy, t0, ta, t1))
        panels["grad_curve_debug"] = bmp_bytes(
            rsh.render_gradation_curve_debug(
                ghist, int(ghist[gmb]), gmb, gpx, gpy, t0, ta, t1))
        # guard scale > offset: a constant cnr map (any value, not just 0)
        # would otherwise normalize 0/0 -> NaN -> undefined u8
        cmn = float(cnr.min())
        cmx = max(float(cnr.max()), cmn + 1e-6)
        panels["cnr"] = bmp_bytes(_to_u8(cnr, cmx, cmn))
        self.panels = panels
        self.stats = [
            ("input", self.raw_path),
            ("image size", f"{cfg.image_size} x {cfg.image_size}"),
            ("executes", str(self.n_executes + 1)),
            ("buffer shown", f"{self.current + 1}/{len(self.outputs)}"),
            ("sqrt max / min", f"{float(inter['sqrt_max']):.1f} / "
                               f"{float(inter['sqrt_min']):.1f}"),
            ("gradation t0/ta/t1", f"{t0:.4f} / {ta:.4f} / {t1:.4f}"),
        ] + [(f"noise peak bin L{i}", str(int(inter[f"noise_max_bin_{i}"])))
             for i in cfg.analysis_levels]

    def debug_dump(self) -> str:
        """debugProcess() analogue: full intermediate gallery on disk."""
        from .report import write_report

        raw = load_raw(self.raw_path, self.cfg.image_size,
                       transpose=self.transpose)
        with self.lock:
            index = write_report(raw, self.report_dir, self.cfg,
                                 title=f"debugProcess: {self.raw_path}",
                                 device=self.device)
        return str(index)

    def page(self) -> str:
        rows = "".join(
            f"<tr><td>{html.escape(k)}</td><td>{html.escape(v)}</td></tr>"
            for k, v in self.stats)
        panels = "".join(
            f"<figure style='display:inline-block'><img src='/img/{n}'/>"
            f"<figcaption>{n}</figcaption></figure>"
            for n in self.panels)
        return f"""<html><head><title>MUSICA viewer</title>
<style>body{{font-family:sans-serif;background:#111;color:#eee}}
img{{image-rendering:pixelated;border:1px solid #444;margin:4px}}
#out{{max-width:720px}}td{{padding:2px 12px}}
button{{margin:4px;padding:6px 14px}}</style></head><body>
<h1>MUSICA viewer</h1>
<form method="post" action="/execute" style="display:inline">
<button>execute()</button></form>
<form method="post" action="/flip" style="display:inline">
<button>flip buffer</button></form>
<form method="post" action="/debug" style="display:inline">
<button>debugProcess()</button></form>
<table>{rows}</table>
<h2>out image (buffer {self.current + 1}/{max(len(self.outputs), 1)})</h2>
<img id="out" src="/img/out"/>
<h2>render panels</h2>{panels}
</body></html>"""


def make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, state.page().encode(), "text/html")
            elif self.path == "/img/out" and state.outputs:
                self._send(200, bmp_bytes(state.outputs[state.current]),
                           "image/bmp")
            elif self.path.startswith("/img/"):
                name = self.path[len("/img/"):]
                blob = state.panels.get(name)
                if blob is None:
                    self._send(404, b"not found", "text/plain")
                else:
                    self._send(200, blob, "image/bmp")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            # a failing execute/debug (e.g. the input raw replaced by a
            # truncated file mid-copy) must surface as a 500 with the
            # message, not a dropped connection
            try:
                if self.path == "/execute":
                    state.execute()
                elif self.path == "/flip":
                    with state.lock:
                        if state.outputs:
                            state.current = (
                                state.current + 1) % len(state.outputs)
                elif self.path == "/debug":
                    index = state.debug_dump()
                    self._send(200, json.dumps({"report": index}).encode(),
                               "application/json")
                    return
                else:
                    self._send(404, b"not found", "text/plain")
                    return
            except Exception as e:  # noqa: BLE001
                self._send(500, f"{type(e).__name__}: {e}".encode(),
                           "text/plain")
                return
            self.send_response(303)
            self.send_header("Location", "/")
            self.end_headers()

    return Handler


def serve(raw_path: str, cfg: MusicaConfig, transpose: bool = True,
          host: str = "127.0.0.1", port: int = 8000,
          report_dir: str = "viewer_report", block: bool = True, device="cuda"):
    """Start the viewer on ``device`` (processes once before serving, like
    App::init's VulkanProcessing::init + first state).  Returns (server,
    state) when ``block`` is False (tests); otherwise serves forever."""
    state = ViewerState(raw_path, cfg, transpose, report_dir, device)
    state.execute()
    server = ThreadingHTTPServer((host, port), make_handler(state))
    print(f"viewer: http://{host}:{server.server_address[1]}/  "
          f"(input {raw_path}, {cfg.image_size}^2, device {device})")
    if not block:
        threading.Thread(target=server.serve_forever, daemon=True).start()
        return server, state
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return None
