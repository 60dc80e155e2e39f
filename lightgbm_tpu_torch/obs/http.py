"""Metrics over HTTP: an opt-in stdlib endpoint serving the process
registry for live scraping of training and serving processes
(counterpart of ``lightgbm_tpu/obs/http.py``).

Endpoints:

- ``GET /metrics``: Prometheus text exposition (version 0.0.4);
- ``GET /metrics.json``: the ``to_dict()`` JSON snapshot;
- ``GET /healthz``: ``ok`` (200) while the global watchdog has no
  un-recovered SLO breach; 503 with a JSON breach list otherwise.

Opt-in only: ``LIGHTGBM_TPU_METRICS_PORT=<port>`` makes ``train`` and
every ``Server`` call ``maybe_start_from_env`` (idempotent, one server
per process); port ``0`` binds an ephemeral port.  The server is a
daemon ``ThreadingHTTPServer`` bound to localhost by default
(``LIGHTGBM_TPU_METRICS_HOST`` overrides); ``stop()`` shuts it down and
joins its thread.  A scrape never touches a torch tensor or the card:
both renderers only read instrument values under the registry lock.
Stdlib only.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..utils import envflags

_PORT_ENV = "LIGHTGBM_TPU_METRICS_PORT"
_HOST_ENV = "LIGHTGBM_TPU_METRICS_HOST"

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsHTTPServer:
    """One registry on one port; ``start()`` returns the bound port."""

    def __init__(self, registry=None, port: int = 0,
                 host: Optional[str] = None):
        if registry is None:
            from .metrics import global_registry as registry
        self.registry = registry
        self.host = host or envflags.get(_HOST_ENV)
        self.port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        if self._httpd is not None:
            return self.port
        registry = self.registry

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                try:
                    if path == "/metrics":
                        self._send(200,
                                   registry.to_prometheus().encode(),
                                   PROM_CONTENT_TYPE)
                    elif path == "/metrics.json":
                        self._send(200,
                                   json.dumps(registry.to_dict(),
                                              sort_keys=True).encode(),
                                   "application/json")
                    elif path == "/healthz":
                        from .watchdog import global_watchdog
                        breaches = global_watchdog.active_breaches()
                        if breaches:
                            self._send(503, json.dumps(
                                {"status": "degraded",
                                 "breaches": breaches},
                                sort_keys=True).encode(),
                                "application/json")
                        else:
                            self._send(200, b"ok\n", "text/plain")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # noqa: BLE001 — scrape never kills
                    try:
                        self._send(500, repr(e).encode(), "text/plain")
                    except Exception:  # noqa: BLE001
                        pass

            def log_message(self, *a):     # no stderr chatter per scrape
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="lgbt-metrics-http")
        self._thread.start()
        from ..utils.log import log_info
        log_info(f"metrics HTTP exposition on "
                 f"http://{self.host}:{self.port}/metrics")
        return self.port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


_lock = threading.Lock()
_server: Optional[MetricsHTTPServer] = None


def maybe_start_from_env() -> Optional[MetricsHTTPServer]:
    """Start the process metrics endpoint when
    ``LIGHTGBM_TPU_METRICS_PORT`` is set (idempotent; "" disables, "0"
    binds ephemeral).  Returns the live server or None."""
    global _server
    v = envflags.get(_PORT_ENV).strip()
    if not v:
        return _server
    with _lock:
        if _server is None:
            try:
                srv = MetricsHTTPServer(port=int(v))
                srv.start()
                _server = srv
            except (ValueError, OSError) as e:
                from ..utils.log import log_warning
                log_warning(
                    f"metrics HTTP endpoint failed to start on "
                    f"{_PORT_ENV}={v!r}: {e}")
                return None
        return _server


def stop_process_server() -> None:
    """Tear down the env-started endpoint (tests)."""
    global _server
    with _lock:
        if _server is not None:
            _server.stop()
            _server = None
