"""HTTP layer: the request handler around a query engine.

The JAX package's HTTP contract (its ``engine.py``), kept in the port's own
copy: ``POST /similar_images`` takes a multipart image upload and answers
``{"prediction": [[distance, base64_thumbnail, path], ...]}``; ``GET
/healthz`` reports the corpus size, ``GET /stats`` the serving counters
(with a ``micro_batch`` block of the routing when ``--micro-batch`` is
not off) and ``GET /`` the packaged upload page (``frontend/index.html``). An empty
POST or an undecodable upload answers 400, a failed query 500.
"""

from __future__ import annotations

import email
import email.policy
import json
import logging
from http.server import BaseHTTPRequestHandler
from typing import Optional

import numpy as np

from image_search_engine_tpu_torch.utils.imageio import decode_image_bytes

log = logging.getLogger(__name__)

# file-missing fallback only: the real page is the packaged
# frontend/index.html; this minimal copy keeps GET / alive if package data
# was stripped.
_UI_FALLBACK_HTML = """<!doctype html>
<html><head><title>image search</title><style>
body{font-family:sans-serif;margin:2rem;background:#fafafa}
#grid{display:grid;grid-template-columns:repeat(5,1fr);gap:12px;margin-top:1rem}
.card{background:#fff;border-radius:8px;padding:8px;box-shadow:0 1px 3px #0002}
.card img{width:100%;border-radius:4px}.d{color:#555;font-size:12px}
</style></head><body>
<h2>Image search</h2>
<input type="file" id="f" accept="image/*">
<div id="grid"></div>
<script>
document.getElementById('f').onchange = async (e) => {
  const fd = new FormData(); fd.append('image', e.target.files[0]);
  const r = await fetch('/similar_images', {method:'POST', body: fd});
  const js = await r.json();
  document.getElementById('grid').innerHTML = js.prediction.map(p =>
    `<div class="card"><img src="data:image/jpeg;base64,${p[1]}">
     <div class="d">${Number(p[0]).toFixed(3)}<br>${p[2]}</div></div>`).join('');
};
</script></body></html>"""


def _ui_html() -> str:
    """The GET / page: the packaged frontend/index.html, or the inline
    fallback when the package data is missing."""
    from importlib import resources

    try:
        return (resources.files("image_search_engine_tpu_torch.frontend")
                .joinpath("index.html").read_text(encoding="utf-8"))
    except (OSError, ModuleNotFoundError) as e:  # a stripped install still serves
        log.warning("packaged frontend/index.html unavailable (%s); "
                    "serving the minimal fallback page", e)
        return _UI_FALLBACK_HTML


def _resize_host(image: np.ndarray, size: int) -> np.ndarray:
    """Host-side PIL bilinear resize to the index-build resolution, with the
    resampler the indexer's loader used, so a corpus image queried against
    itself matches its stored embedding."""
    if image.shape[:2] == (size, size):
        return np.asarray(image, np.float32)
    from PIL import Image

    im = Image.fromarray((np.clip(image, 0.0, 1.0) * 255).astype(np.uint8))
    im = im.resize((size, size), Image.BILINEAR)
    return np.asarray(im, np.float32) / 255.0


def _parse_multipart(headers, body: bytes) -> Optional[bytes]:
    """The first file part of a multipart/form-data body, or None."""
    ctype = headers.get("Content-Type", "")
    if "multipart/form-data" not in ctype:
        return None
    msg = email.message_from_bytes(
        f"Content-Type: {ctype}\r\n\r\n".encode() + body, policy=email.policy.HTTP)
    for part in msg.iter_parts():
        payload = part.get_payload(decode=True)
        if payload:
            return payload
    return None


def make_handler(engine):
    """A ``BaseHTTPRequestHandler`` class serving ``engine`` (anything with
    ``paths``, ``stats``, ``cfg`` and ``query(image)``)."""

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload) -> None:
            blob = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "corpus": len(engine.paths)})
                return
            if self.path == "/stats":
                snap = engine.stats.snapshot()
                mb = engine.cfg.micro_batch_mode()
                if mb != "off":
                    # the (possibly auto-calibrated) routing, so an operator
                    # sees which path requests take, including "auto" whose
                    # calibration never ran (--no-prewarm: unbatched)
                    snap["micro_batch"] = {
                        "mode": mb,
                        "active": bool(getattr(engine, "_use_batcher", False)),
                    }
                    if mb == "auto":
                        snap["micro_batch"]["calibrated"] = bool(
                            getattr(engine, "_mb_calibrated", False))
                self._json(200, snap)
                return
            if self.path not in ("/", "/index.html"):
                self._json(404, {"error": "unknown endpoint"})
                return
            page = _ui_html().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(page)))
            self.end_headers()
            self.wfile.write(page)

        def do_OPTIONS(self):  # noqa: N802
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods", "POST, GET, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "*")
            self.end_headers()

        def do_POST(self):  # noqa: N802
            if self.path != "/similar_images":
                self._json(404, {"error": "unknown endpoint"})
                return
            length = int(self.headers.get("Content-Length", 0))
            data = _parse_multipart(self.headers, self.rfile.read(length))
            if data is None:
                self._json(400, {"error": "no image uploaded"})
                return
            try:
                image = decode_image_bytes(data)
            except Exception as e:  # noqa: BLE001 — PIL raises many types on bad bytes
                self._json(400, {"error": f"undecodable image: {e}"})
                return
            try:
                prediction = engine.query(image)
            except Exception as e:  # noqa: BLE001 — a failed query answers 500
                log.exception("query failed")
                self._json(500, {"error": f"query failed: {e}"})
                return
            self._json(200, {"prediction": prediction})

        def log_message(self, fmt, *args):
            log.debug("%s - %s", self.address_string(), fmt % args)

    return Handler
