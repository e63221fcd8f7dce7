"""Stdlib HTTP endpoint for the Prometheus text exposition.

Copy of ``repro/obs/httpd.py`` over the port's registry.

``repro_torch.launch.serve --metrics-port N`` starts this on a daemon
thread; a scraper (or curl) reads ``GET /metrics``.  Port 0 binds an ephemeral
port — the actual port is on the returned server (``server_port``),
which tests use to avoid collisions.
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from .metrics import MetricsRegistry, REGISTRY

__all__ = ["start_metrics_server"]


def start_metrics_server(port: int = 0,
                         registry: Optional[MetricsRegistry] = None,
                         host: str = "127.0.0.1",
                         ) -> Tuple[ThreadingHTTPServer, threading.Thread]:
    """Serve ``registry.render_text()`` at ``/metrics`` (and ``/``) on a
    daemon thread; returns ``(server, thread)`` — call
    ``server.shutdown()`` to stop it."""
    reg = registry if registry is not None else REGISTRY

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):                              # noqa: N802 (stdlib)
            if self.path.split("?")[0] not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = reg.render_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):                     # quiet by default
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="sme-metrics-http", daemon=True)
    thread.start()
    return server, thread
