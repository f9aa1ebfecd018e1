"""Training UI web server (a copy of ``deeplearning4j_tpu/ui/server.py`` over
the port's ``obs`` metrics, Prometheus renderer and tracer: the same routes
and JSON).

Reference: deeplearning4j-ui's Vert.x dashboard (`UIServer.getInstance();
uiServer.attach(statsStorage)` — SURVEY.md §2.2 "Training UI"). Same
contract here on the stdlib http.server: attach a
:class:`~..ui.stats.StatsStorage`, browse http://localhost:9000 for live
loss curves, update:param ratios, and per-layer histograms; the JSON
endpoints (`/train/sessions`, `/train/stats?sessionId=`) serve machine
readers. No external web framework — the dashboard is one self-contained
HTML page with inline canvas charts, polling the JSON.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..obs.metrics import MetricsRegistry, get_registry
from ..obs.prom import CONTENT_TYPE as _PROM_CONTENT_TYPE
from ..obs.prom import render_prometheus
from ..obs.tracing import Tracer, get_tracer
from .stats import StatsStorage

_PAGE = """<!DOCTYPE html>
<html><head><title>dl4j-tpu training UI</title>
<style>
 body { font-family: sans-serif; margin: 1.5em; background: #fafafa; }
 h1 { font-size: 1.2em; } h2 { font-size: 1.0em; color: #444; }
 canvas { background: #fff; border: 1px solid #ccc; margin: 4px 12px 12px 0; }
 .row { display: flex; flex-wrap: wrap; }
</style></head>
<body>
<h1>dl4j-tpu training UI</h1>
<div>session: <select id="session"></select></div>
<div class="row">
 <div><h2>score (loss)</h2><canvas id="score" width="460" height="220"></canvas></div>
 <div><h2>log10 update:param ratios</h2><canvas id="ratios" width="460" height="220"></canvas></div>
</div>
<script>
function drawSeries(id, series, logY) {
  const c = document.getElementById(id), g = c.getContext('2d');
  g.clearRect(0, 0, c.width, c.height);
  const names = Object.keys(series);
  if (!names.length) return;
  let lo = Infinity, hi = -Infinity, n = 0;
  for (const k of names) for (const v of series[k]) {
    if (isFinite(v)) { lo = Math.min(lo, v); hi = Math.max(hi, v); }
    n = Math.max(n, series[k].length);
  }
  if (!isFinite(lo)) return;
  if (hi === lo) { hi = lo + 1; }
  const colors = ['#06c', '#c33', '#090', '#960', '#909', '#099'];
  names.forEach((k, ci) => {
    g.strokeStyle = colors[ci % colors.length];
    g.beginPath();
    series[k].forEach((v, i) => {
      const x = 30 + (c.width - 40) * i / Math.max(n - 1, 1);
      const y = c.height - 20 - (c.height - 40) * (v - lo) / (hi - lo);
      i ? g.lineTo(x, y) : g.moveTo(x, y);
    });
    g.stroke();
    g.fillStyle = g.strokeStyle;
    g.fillText(k, 34, 14 + 12 * ci);
  });
  g.fillStyle = '#000';
  g.fillText(hi.toPrecision(4), 2, 12);
  g.fillText(lo.toPrecision(4), 2, c.height - 8);
}
async function refresh() {
  const sess = document.getElementById('session').value || '';
  const r = await fetch('/train/stats?sessionId=' + sess);
  const d = await r.json();
  drawSeries('score', {score: d.scores});
  drawSeries('ratios', d.update_ratios);
}
async function init() {
  const r = await fetch('/train/sessions');
  const sessions = await r.json();
  const sel = document.getElementById('session');
  sel.textContent = '';
  for (const s of sessions) {
    const o = document.createElement('option');
    o.textContent = s;
    sel.appendChild(o);
  }
  sel.onchange = refresh;
  await refresh();
  setInterval(refresh, 2000);
}
init();
</script></body></html>
"""


class UIServer:
    """``UIServer.get_instance().attach(storage)`` + ``start()`` — the
    reference's spelling, minus the JVM."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000, host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None) -> None:
        # loopback by default: the dashboard has no auth; pass
        # host="0.0.0.0" explicitly to expose it beyond the machine
        self.port = port
        self.host = host
        self.storage: Optional[StatsStorage] = None
        # /metrics source; None = the process-global registry at scrape
        # time, so the training dashboard process is scrapeable alongside
        # any serving endpoints it hosts
        self.registry = registry
        # /v1/traces source; None = the process-global tracer's store
        self.tracer = tracer
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def get_instance(cls, port: Optional[int] = None) -> "UIServer":
        """``port=None`` means "no preference" — it never overrides a port
        an earlier caller configured explicitly."""
        if cls._instance is None:
            cls._instance = cls(port if port is not None else 9000)
        elif port is not None and port != cls._instance.port:
            if cls._instance._httpd is not None:
                raise ValueError(
                    f"UIServer already running on port {cls._instance.port}; "
                    "stop() it before requesting a different port")
            # not yet started: honour the newly requested explicit port
            cls._instance.port = port
        return cls._instance

    getInstance = get_instance

    def attach(self, storage: StatsStorage) -> "UIServer":
        self.storage = storage
        return self

    # ---- payload builders (shared by HTTP + tests) ------------------------
    def sessions_payload(self):
        return self.storage.session_ids() if self.storage else []

    def stats_payload(self, session_id: Optional[str]) -> Dict[str, Any]:
        if self.storage is None:
            return {"scores": [], "update_ratios": {}, "iterations": []}
        sid = session_id or None
        records = self.storage.records(sid)
        scores = [float(r["score"]) for r in records if "score" in r]
        ratios: Dict[str, list] = {}
        for r in records:
            for pname, ratio in (r.get("update_ratios") or {}).items():
                val = float(ratio)
                ratios.setdefault(pname, []).append(
                    float(np.log10(max(val, 1e-12))))
        return {
            "scores": scores,
            "update_ratios": ratios,
            "iterations": [int(r.get("iteration", i))
                           for i, r in enumerate(records)],
        }

    def traces_payload(self, query: str = "") -> Dict[str, Any]:
        """``GET /v1/traces`` — same query surface as ``JsonModelServer``
        (``min_ms``, ``route``, ``limit``), so the training process's
        deploy/step traces are browsable next to its metrics."""
        q = parse_qs(query or "")

        def first(key, cast, default=None):
            vals = q.get(key)
            if not vals:
                return default
            try:
                return cast(vals[0])
            except (TypeError, ValueError):
                return default

        tracer = self.tracer if self.tracer is not None else get_tracer()
        return {
            "enabled": tracer.enabled,
            "trace_count": len(tracer.store),
            "traces": tracer.store.traces(
                min_duration_ms=first("min_ms", float),
                route=first("route", str),
                limit=first("limit", int, 50)),
        }

    # ---- server lifecycle -------------------------------------------------
    def start(self, block: bool = False) -> "UIServer":
        ui = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path in ("/", "/train", "/train/overview"):
                    self._send(_PAGE.encode(), "text/html")
                elif url.path == "/train/sessions":
                    self._send(json.dumps(ui.sessions_payload()).encode(),
                               "application/json")
                elif url.path == "/train/stats":
                    q = parse_qs(url.query)
                    sid = (q.get("sessionId") or [None])[0]
                    self._send(json.dumps(ui.stats_payload(sid)).encode(),
                               "application/json")
                elif url.path == "/metrics":
                    reg = ui.registry if ui.registry is not None \
                        else get_registry()
                    self._send(render_prometheus(reg).encode(),
                               _PROM_CONTENT_TYPE)
                elif url.path == "/v1/traces":
                    self._send(json.dumps(
                        ui.traces_payload(url.query)).encode(),
                        "application/json")
                else:
                    self.send_response(404)
                    self.end_headers()

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        if block:
            self._httpd.serve_forever()
            return self
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if UIServer._instance is self:
            UIServer._instance = None
