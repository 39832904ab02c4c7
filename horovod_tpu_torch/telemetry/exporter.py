"""HTTP exporter: a route registry serving ``/metrics`` and ``/healthz``
plus the routes other subsystems register (serving's ``/generate``).  A
copy of horovod_tpu/telemetry/exporter.py, which imports no JAX.

There is one process-global :class:`RouteRegistry` (:func:`routes`);
every exporter serves it unless given a private one.  Endpoints:
``GET /metrics`` (Prometheus text, ``hvd_`` prefix; ``?format=json`` the
raw snapshot), ``GET /healthz`` (``{"status": "ok"|"NOT_READY", ...}``,
200 when every registered health contributor is ready, 503 otherwise:
the load-balancer contract).  :func:`start_exporter` with port 0 picks
a free port (``exporter.port``).

``hvd.init()`` starts one when ``HVD_TPU_METRICS_PORT`` is set
(``core/state.py``); a client gone at the reply is flight-recorded.
The route registry's lock is the lock-order checker's named lock, its
guarded fields carry the race checker, and the serving thread is
stamped ``exporter`` (reference :121-137, :300-301).  The hvd-chaos
site ``serving.disconnect`` answers in :class:`ClientProbe`.
"""

from __future__ import annotations

import json
import select
import socket as _socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from . import flight as _flight
from ..analysis import lockorder as _lockorder
from ..analysis import races as _races
from ..analysis import threads as _athreads
from .registry import MetricsRegistry

_PROM_HELP_TYPES = {"counter": "counter", "gauge": "gauge",
                    "histogram": "histogram"}

# A route handler: (query_string, request_body) -> (status, body, ctype).
# Routes registered with pass_client=True receive a third argument, a
# :class:`ClientProbe`, so a long-blocking handler (serving's
# /generate) can notice its client vanished and abort the work instead
# of generating tokens nobody will read (hvd-chaos hardening).
RouteHandler = Callable[..., Tuple[int, bytes, str]]
# A health contributor: () -> (ready, payload_dict) — payload is merged
# into the /healthz JSON under the contributor's name.
HealthContributor = Callable[[], Tuple[bool, dict]]


class ClientProbe:
    """Liveness probe for one HTTP client connection.

    ``disconnected()`` is a zero-timeout ``select`` + ``MSG_PEEK``: a
    readable socket returning EOF means the client closed mid-request
    (an HTTP/1.1 client sends nothing after its request, so readable
    data that is NOT EOF — a pipelined request — reads as still
    connected).  The hvd-chaos ``serving.disconnect`` site injects a
    positive answer here, which is exactly where a real disconnect is
    observed (reference :60-89)."""

    def __init__(self, sock: Optional[_socket.socket]) -> None:
        self._sock = sock

    def disconnected(self) -> bool:
        from .. import chaos as _chaos

        if _chaos.active() and _chaos.fire("serving.disconnect") \
                is not None:
            return True
        if self._sock is None:
            return False
        try:
            readable, _, _ = select.select([self._sock], [], [], 0)
            if not readable:
                return False
            return self._sock.recv(1, _socket.MSG_PEEK) == b""
        except (OSError, ValueError):
            return True


def prometheus_name(name: str) -> str:
    return "hvd_" + "".join(
        c if (c.isalnum() or c == "_") else "_" for c in name)


def prometheus_text(snapshot: dict) -> str:
    """Render one registry snapshot in the Prometheus text exposition
    format (v0.0.4): counters/gauges as single samples, histograms as
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``."""
    lines = []
    for name, m in snapshot.items():
        pname = prometheus_name(name)
        mtype = _PROM_HELP_TYPES.get(m.get("type"), "untyped")
        lines.append(f"# TYPE {pname} {mtype}")
        if m.get("type") == "histogram":
            cum = 0
            for edge, n in m.get("buckets", []):
                cum += n
                lines.append(f'{pname}_bucket{{le="{edge:g}"}} {cum}')
            cum += m.get("overflow", 0)
            lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{pname}_sum {m.get('sum', 0)}")
            lines.append(f"{pname}_count {m.get('count', 0)}")
        else:
            lines.append(f"{pname} {m.get('value', 0)}")
    return "\n".join(lines) + "\n"


@_races.race_checked
class RouteRegistry:
    """Path → handler table shared by every exporter instance.

    ``register``/``unregister`` may run from any thread at any time
    relative to the server; dispatch takes a locked snapshot per
    request.  The lock is a leaf on the hvd-analyze lock-order graph —
    handlers run OUTSIDE it, so a slow handler (serving's blocking
    ``/generate``) never wedges registration or other routes."""

    def __init__(self) -> None:
        self._lock = _lockorder.make_lock("exporter.RouteRegistry._lock")
        # (method, path) -> (handler, pass_client)
        self._routes: Dict[Tuple[str, str],
                           Tuple[RouteHandler, bool]] = {}
        # guarded_by: _lock
        self._health: Dict[str, HealthContributor] = {}  # guarded_by: _lock

    def register(self, path: str, handler: RouteHandler,
                 methods: Tuple[str, ...] = ("GET",),
                 pass_client: bool = False) -> None:
        """Bind ``handler`` to ``path`` for ``methods`` (replaces any
        previous binding — re-init idempotency).  ``pass_client=True``
        hands the handler a :class:`ClientProbe` third argument so it
        can watch for a mid-request client disconnect."""
        with self._lock:
            for m in methods:
                self._routes[(m.upper(), path)] = (handler, pass_client)

    def unregister(self, path: str) -> None:
        with self._lock:
            for key in [k for k in self._routes if k[1] == path]:
                del self._routes[key]

    def register_health(self, name: str,
                        contributor: HealthContributor) -> None:
        """Add a readiness contributor to ``/healthz`` (keyed — a
        re-registration replaces the previous instance)."""
        with self._lock:
            self._health[name] = contributor

    def unregister_health(self, name: str) -> None:
        with self._lock:
            self._health.pop(name, None)

    def lookup(self, method: str,
               path: str) -> Optional[Tuple[RouteHandler, bool]]:
        """(handler, pass_client) for a bound route, else None."""
        with self._lock:
            return self._routes.get((method.upper(), path))

    def paths(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted({p for _, p in self._routes}))

    def health_payload(self) -> Tuple[int, dict]:
        """(status_code, payload): 200/"ok" when every contributor is
        ready, 503/"NOT_READY" otherwise — the load-balancer contract."""
        from ..core import state as _state

        initialized = _state.is_initialized()
        rank = _state.rank() if initialized else None
        with self._lock:
            contributors = dict(self._health)
        payload = {"rank": rank, "initialized": initialized}
        ready = True
        for name, fn in contributors.items():
            try:
                ok, detail = fn()
            except Exception as e:  # noqa: BLE001 — a broken
                ok, detail = False, {"error": str(e)}  # contributor is
                # a NOT_READY, not a 500
            ready = ready and bool(ok)
            payload[name] = detail
        payload["status"] = "ok" if ready else "NOT_READY"
        return (200 if ready else 503), payload


_routes = RouteRegistry()


def routes() -> RouteRegistry:
    """The process-global route registry every exporter serves."""
    return _routes


class MetricsExporter:
    """A daemon-threaded HTTP server bound to one metrics registry and
    the process-global route registry."""

    def __init__(self, registry: MetricsRegistry, port: int,
                 host: str = "0.0.0.0",
                 routes: Optional[RouteRegistry] = None) -> None:
        self.registry = registry
        # Default is the process-global registry (subsystems register
        # into it without holding an exporter reference); a private
        # RouteRegistry lets a second tier — hvd-route's front door —
        # serve its own /generate in the same process without fighting
        # a colocated replica over the path.
        self.routes = _routes if routes is None else routes
        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:
                pass  # no per-request stderr chatter

            def _reply(self, code: int, body: bytes,
                       ctype: str) -> None:
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError) as e:
                    # The client vanished between the handler finishing
                    # and the response write (hvd-chaos hardening):
                    # nothing to deliver to, and one gone client must
                    # never take the server thread down with a
                    # traceback.  The handler-side ClientProbe catches
                    # MID-request disconnects; this catches the
                    # at-reply race.
                    _flight.record("client_gone_at_reply", self.path,
                                   f"{type(e).__name__}")

            def _dispatch(self, method: str, body: bytes) -> None:
                path, _, query = self.path.partition("?")
                if path == "/healthz":
                    code, payload = exporter.routes.health_payload()
                    self._reply(code, json.dumps(payload).encode(),
                                "application/json")
                    return
                if method == "GET" and path in ("/metrics",
                                                "/metrics.json"):
                    snap = exporter.registry.snapshot()
                    if path.endswith(".json") or "format=json" in query:
                        self._reply(200, json.dumps(snap).encode(),
                                    "application/json")
                    else:
                        self._reply(
                            200, prometheus_text(snap).encode(),
                            "text/plain; version=0.0.4")
                    return
                bound = exporter.routes.lookup(method, path)
                if bound is None:
                    self._reply(404, b"not found\n", "text/plain")
                    return
                handler, pass_client = bound
                try:
                    if pass_client:
                        code, out, ctype = handler(
                            query, body, ClientProbe(self.connection))
                    else:
                        code, out, ctype = handler(query, body)
                except Exception as e:  # noqa: BLE001 — one bad request
                    # must not kill the server thread
                    self._reply(500, json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode(),
                        "application/json")
                    return
                self._reply(code, out, ctype)

            def do_GET(self) -> None:  # noqa: N802 — http.server API
                self._dispatch("GET", b"")

            def do_POST(self) -> None:  # noqa: N802 — http.server API
                n = int(self.headers.get("Content-Length") or 0)
                self._dispatch("POST", self.rfile.read(n) if n else b"")

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        server = self._server

        def _serve() -> None:  # thread: exporter
            _athreads.set_role("exporter")
            server.serve_forever()

        self._thread = threading.Thread(
            target=_serve,
            name="hvd-metrics-exporter", daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2.0)


def start_exporter(registry: MetricsRegistry, port: int,
                   host: str = "0.0.0.0",
                   routes: Optional[RouteRegistry] = None
                   ) -> MetricsExporter:
    return MetricsExporter(registry, port, host=host, routes=routes)
