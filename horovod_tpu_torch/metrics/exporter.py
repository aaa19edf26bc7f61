"""Per-rank Prometheus scrape endpoint on a stdlib http.server (the
port's own copy of the JAX package's ``metrics/exporter.py``).

``HOROVOD_METRICS_PORT=<base>`` gives every rank its own endpoint at
``base + rank`` (same-host ranks must not fight over one port; the
launcher prints the resolved URLs at startup). The server runs on a
daemon thread and serves:

* ``GET /metrics`` — Prometheus text exposition of this rank's registry;
  on rank 0 it also includes every worker's piggybacked snapshot with a
  per-rank ``rank`` label (the cluster view).
* any extra ``routes`` the caller installs — rank 0 serves the cluster
  doctor's JSON report at ``GET /doctor`` (``horovod_tpu_torch.doctor``).

When the requested port is already bound (two jobs sharing a host both
computing ``base + rank``), :func:`start_exporter` walks forward to the
next free port — in steps of the caller's ``stride`` (the job size for
per-rank ranges, so a displaced rank never steals a sibling's slot) —
logging ONE WARNING naming the port actually bound, and falls back to
an ephemeral port before ever giving up: a port collision must cost an
operator a surprising URL, not the endpoint.

No dependency beyond the stdlib — the scrape path must work in the same
hermetic environment the tests run in.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from ..common import hvd_logging as logging

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# How many consecutive ports to try past the requested one before falling
# back to an ephemeral port. Covers a whole colliding job's rank range.
PORT_SCAN_LIMIT = 32


class MetricsExporter:
    """Serve ``render()``'s output at /metrics (plus any extra routes)
    until ``close()``."""

    def __init__(self, port: int, render: Callable[[], str],
                 host: str = "",
                 routes: Optional[Dict[str, Callable[[], Tuple[str, str]]]]
                 = None):
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                path, _, query = self.path.partition("?")
                try:
                    if path == "/metrics":
                        # Query-aware renders (``?window=recent`` — the
                        # windowed-telemetry view) only
                        # for callables that declare a parameter; legacy
                        # zero-arg renders keep their exact contract.
                        if query and exporter._render_takes_query:
                            body = exporter._render(query)
                        else:
                            body = exporter._render()
                        ctype = CONTENT_TYPE
                    elif path in exporter._routes:
                        ctype, body = exporter._routes[path]()
                    else:
                        known = ["/metrics"] + sorted(exporter._routes)
                        self.send_error(404, f"try {' or '.join(known)}")
                        return
                except Exception as exc:  # render must never kill the server
                    self.send_error(500, f"render failed: {exc}")
                    return
                payload = body.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, fmt, *args):  # scrapes are not log news
                pass

        self._render = render
        try:
            import inspect

            self._render_takes_query = bool(
                inspect.signature(render).parameters)
        except (TypeError, ValueError):
            self._render_takes_query = False
        self._routes = dict(routes or {})
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_port
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="hvd-metrics-exporter",
            daemon=True)
        self._thread.start()
        logging.debug("metrics exporter listening on :%d/metrics", self.port)

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=2.0)


def start_exporter(port: int, render: Callable[[], str],
                   host: str = "",
                   routes: Optional[Dict[str, Callable[[], Tuple[str, str]]]]
                   = None, stride: int = 1) -> Optional[MetricsExporter]:
    """Best-effort start with port-collision hardening: a busy port walks
    forward to the next free one (then an ephemeral one), with a single
    WARNING naming the port actually serving — telemetry must never take
    down, or silently drop out of, the job it observes.

    ``stride`` is the walk step: callers owning one slot of a per-rank
    range (``base + rank``) pass the job size, so a displaced rank jumps
    PAST its siblings' slots instead of stealing the next rank's port
    (which would cascade the shift down the whole job and leave scrape
    targets pointing at the wrong rank's registry)."""
    stride = max(1, int(stride))
    last_exc: Optional[OSError] = None
    tried = 0
    for attempt in range(PORT_SCAN_LIMIT):
        candidate = port + attempt * stride
        if candidate > 65535:
            break
        tried += 1
        try:
            exporter = MetricsExporter(candidate, render, host=host,
                                       routes=routes)
        except OSError as exc:
            last_exc = exc
            continue
        if candidate != port:
            logging.warning(
                "metrics exporter: port %d already bound (%s); serving on "
                "port %d instead — scrape THAT port", port, last_exc,
                exporter.port)
        return exporter
    try:
        # Whole scan range bound: let the kernel pick any free port
        # rather than giving up.
        exporter = MetricsExporter(0, render, host=host, routes=routes)
    except OSError as exc:
        logging.error(
            "metrics exporter: cannot bind port %d (or any fallback: %s); "
            "endpoint disabled for this rank — adjust HOROVOD_METRICS_PORT",
            port, exc)
        return None
    # The walk can break early at the 65535 ceiling: report only what
    # was actually probed, not the nominal scan width (a base port past
    # the ceiling would otherwise claim 32 nonexistent squatters).
    if tried:
        reason = (f"{tried} stride-{stride} candidate(s) from {port} "
                  f"all bound (last: {last_exc})")
    else:
        reason = f"port {port} is above the 65535 port ceiling"
    logging.warning(
        "metrics exporter: %s; serving on ephemeral port %d instead — "
        "scrape THAT port", reason, exporter.port)
    return exporter
