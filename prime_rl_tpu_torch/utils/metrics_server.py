"""Prometheus metrics endpoint and health probe (the port of the JAX
package's ``utils/metrics_server.py``, standard library only): a threaded
HTTP server with ``/metrics`` (the Prometheus text format 0.0.4) and
``/health`` (200, or 503 after ``set_healthy(False)``); any other path is a
404. Gauges are set from the train loop's metric records.

The body is the one the JAX package's ``prometheus_client`` registry writes
for the same records, byte for byte: per gauge, in the order of its first
``update``, ``# HELP`` (the record's key, backslashes and newlines escaped),
``# TYPE ... gauge`` and the value in Go's float format
(``prometheus_client.utils.floatToGoString``)."""

from __future__ import annotations

import math
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any

from prime_rl_tpu_torch.utils.logger import get_logger

_LEGACY_NAME_CHAR = re.compile(r"[^a-zA-Z0-9_:]")


class _Server(ThreadingHTTPServer):
    daemon_threads = False  # server_close() joins the request threads


def float_to_go_string(d: float) -> str:
    """prometheus_client's ``floatToGoString``: ``+Inf``, ``-Inf``, ``NaN``,
    Python's repr otherwise, and Go's exponent form for positive values of
    more than six integer digits."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def gauge_name(prefix: str, key: str) -> str:
    """The JAX package's gauge name for a record key: ``/`` -> ``:``, ``@`` ->
    ``_at_``, ``^`` -> ``_hat_``, every other character that is not
    alphanumeric or ``_`` -> ``_``, after ``{prefix}_``."""
    key = key.replace("/", ":").replace("@", "_at_").replace("^", "_hat_")
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in key)
    return f"{prefix}_{safe}"


class MetricsServer:
    def __init__(self, host: str = "0.0.0.0", port: int = 9100, prefix: str = "prime_rl"):
        self.prefix = prefix
        self._gauges: dict[str, tuple[str, float]] = {}  # name -> (help, value)
        self._lock = threading.Lock()
        self._healthy = True
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                if self.path.startswith("/metrics"):
                    body = server.render()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/health"):
                    self.send_response(200 if server._healthy else 503)
                    self.end_headers()
                    self.wfile.write(b"ok" if server._healthy else b"unhealthy")
                else:
                    self.send_response(404)
                    self.end_headers()

            def log_message(self, *args):  # silence
                pass

        self.httpd = _Server((host, port), Handler)
        self.port = self.httpd.server_port
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def set_healthy(self, healthy: bool) -> None:
        self._healthy = healthy

    def update(self, metrics: dict[str, Any]) -> None:
        """Set gauges from a flat metric dict; values that ``float`` refuses
        (None, strings that are not numbers) are skipped."""
        for name, value in metrics.items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            gname = gauge_name(self.prefix, name)
            with self._lock:
                help_text = self._gauges.get(gname, (name, 0.0))[0]
                self._gauges[gname] = (help_text, value)

    def render(self) -> bytes:
        """The ``/metrics`` body."""
        with self._lock:
            gauges = list(self._gauges.items())
        out = []
        for name, (help_text, value) in gauges:
            name = _LEGACY_NAME_CHAR.sub("_", name)
            help_text = help_text.replace("\\", r"\\").replace("\n", r"\n")
            out.append(f"# HELP {name} {help_text}\n# TYPE {name} gauge\n"
                       f"{name} {float_to_go_string(value)}\n")
        return "".join(out).encode("utf-8")

    def stop(self) -> None:
        """Stop serving, close the socket and wait for the serving thread and
        any request in flight."""
        if self._thread.is_alive():
            self.httpd.shutdown()
            self._thread.join()
        self.httpd.server_close()


def maybe_start_metrics_server(config) -> MetricsServer | None:
    """From a ``MetricsServerConfig``: the started server, or None when it is
    disabled or cannot bind (logged as a warning)."""
    if not config.enable:
        return None
    try:
        server = MetricsServer(config.host, config.port)
    except OSError as e:
        get_logger().warning(f"metrics server on {config.host}:{config.port} not started: {e}")
        return None
    get_logger().info(f"metrics server on {config.host}:{server.port}")
    return server.start()
