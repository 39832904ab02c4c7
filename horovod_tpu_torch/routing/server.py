"""The router's own HTTP front door (a copy of horovod_tpu/routing/
server.py, which imports no JAX; the exporter is the port's).

A :class:`RouterServer` binds a PRIVATE
:class:`~horovod_tpu_torch.telemetry.exporter.RouteRegistry` (the exporter's
``routes=`` escape hatch) — the process-global registry belongs to a
colocated serving replica's ``/generate``, and the router tier must be
able to front one on the same box without fighting it for the path.
The server exposes:

  POST /generate   the fleet front door — same request JSON as a
                   replica's (``tokens`` or ``text``), answered with
                   the replica's completion plus a ``router`` stamp
                   (which replica, affinity pages, failovers)
  GET  /healthz    the exporter contract, with a ``routing``
                   contributor: ready iff at least one replica is
                   dispatchable, payload carries the per-replica fleet
                   snapshot
  GET  /metrics    the usual registry exposition (``routing.*``
                   counters live next to everything else)

A poll thread refreshes replica health every ``poll_interval`` seconds
and, when an autoscaler is attached, gives it one ``observe()`` tick
per cycle — autoscaling shares the poll cadence by construction, so
its hysteresis counts are in units an operator can reason about.
"""

from __future__ import annotations

import json
import threading
from typing import Optional, Tuple

from .. import telemetry as _telemetry
from ..analysis import threads as _athreads
from ..telemetry import exporter as _exporter

HEALTH_KEY = "routing"
GENERATE_PATH = "/generate"


class RouterServer:
    """HTTP front door + poll loop over a
    :class:`~horovod_tpu_torch.routing.router.Router`."""

    def __init__(self, router, port: int = 0,
                 host: str = "127.0.0.1",
                 poll_interval: float = 0.5,
                 autoscaler=None) -> None:
        self.router = router
        self.autoscaler = autoscaler
        self._poll_interval = float(poll_interval)
        self._routes = _exporter.RouteRegistry()
        self._routes.register_health(HEALTH_KEY, self._health)
        self._routes.register(GENERATE_PATH, self._handle_generate,
                              methods=("POST",))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._exporter = _exporter.start_exporter(
            _telemetry.registry(), port, host=host,
            routes=self._routes)

    @property
    def port(self) -> int:
        return self._exporter.port

    def start(self) -> "RouterServer":
        self.router.poll()
        self._thread = threading.Thread(
            target=self._poll_loop, name="hvd-route-poll", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self._exporter.close()

    def __enter__(self) -> "RouterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _poll_loop(self) -> None:  # thread: route-poll
        _athreads.set_role("route-poll")
        while not self._stop.wait(self._poll_interval):
            try:
                self.router.poll()
                if self.autoscaler is not None:
                    self.autoscaler.observe()
            except Exception as e:  # noqa: BLE001 — one bad poll
                # cycle (a replica mid-death, a raced removal) must
                # not kill the thread that notices recoveries
                _telemetry.exception_event(
                    "route-poll", f"{type(e).__name__}: {e}")

    def _health(self) -> Tuple[bool, dict]:
        status = self.router.replica_status()
        ready = sum(1 for s in status.values()
                    if s["status"] == "ready")
        return ready > 0, {"ready_replicas": ready,
                           "replicas": status}

    def _handle_generate(self, query: str,
                         body: bytes) -> Tuple[int, bytes, str]:
        try:
            payload = json.loads(body.decode() or "{}")
        except ValueError:
            return (400, b'{"error": "invalid JSON"}\n',
                    "application/json")
        if not payload.get("tokens") and "text" in payload:
            # The byte tokenizer, replica-compatible by construction
            # (UTF-8 bytes as ids < 256): the router tier knows no
            # vocab, so a model that cannot serve bytes rejects the
            # ids itself with its usual 400.
            payload = dict(payload)
            payload["tokens"] = list(
                str(payload.pop("text")).encode("utf-8"))
        timeout = payload.get("timeout")
        status, resp = self.router.dispatch(
            payload, timeout=None if timeout is None
            else float(timeout))
        return (status, (json.dumps(resp) + "\n").encode(),
                "application/json")
