"""Telemetry: the always-on metrics registry and the HTTP exporter (port of
horovod_tpu/telemetry, its registry and exporter halves).

:mod:`.registry` is the lock-free-hot-path registry every layer publishes
into (the serving path's ``serving.*`` series); :func:`metrics` is the
local snapshot.  :mod:`.exporter` serves ``/metrics``, ``/healthz`` and
the routes subsystems register (serving's ``/generate``).

:func:`error_event` and :func:`exception_event` keep the reference's
signatures: each is printed to stderr and kept in a bounded list of
recent events (:func:`recent_events`).  Waiting for ROADMAP.md A.5: the
flight recorder (the reference records and dumps these events there),
``cluster_metrics``, the runtime collector and ``MetricsLogger``.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Dict, List

from .registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    aggregate,
    bucket_edges,
    metrics_enabled,
)

# Process-global default registry: every layer asks it for its metric
# handles at import time.
_default = MetricsRegistry()

_EVENTS_KEPT = 256
_events: "collections.deque" = collections.deque(maxlen=_EVENTS_KEPT)
_events_lock = threading.Lock()


def registry() -> MetricsRegistry:
    return _default


def counter(name: str, help: str = "") -> Counter:
    return _default.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _default.gauge(name, help)


def histogram(name: str, kind: str = "seconds", help: str = "") -> Histogram:
    return _default.histogram(name, kind, help)


def metrics() -> Dict[str, dict]:
    """This process's metrics snapshot (collectors included)."""
    return _default.snapshot()


_M_ERRORS = counter("events.errors",
                    "error and exception events (error_event, "
                    "exception_event)")


def _event(kind: str, where: str, text: str) -> None:
    _M_ERRORS.inc()
    with _events_lock:
        _events.append({"time": time.time(), "kind": kind, "where": where,
                        "text": text})
    print(f"[hvd-telemetry] {kind} {where}: {text}", file=sys.stderr)


def error_event(message: str) -> None:
    _event("error", "", message)


def exception_event(where: str, text: str) -> None:
    _event("exception", where, text)


def recent_events() -> List[dict]:
    """The last error and exception events, oldest first."""
    with _events_lock:
        return list(_events)
