"""Telemetry: the always-on metrics registry, cluster aggregation, the
flight recorder and the HTTP exporter (port of horovod_tpu/telemetry,
:61-327 of its ``__init__``).

* :mod:`.registry` is the lock-free-hot-path registry every layer
  publishes into; :func:`metrics` is the local snapshot.
* :func:`cluster_metrics` pulls every rank's snapshot to rank 0 and
  merges them (min/max/mean/per-rank for scalars, merged buckets and
  p50/p90/p99 for histograms).  The reference's workers answer a
  ``FRAME_METRICS`` pull from a receive thread; the port's control plane
  is a lockstep gloo exchange, so the pull rides the coordinator's cycle
  (``ops/transport.py`` ``PAYLOAD_PULL_METRICS`` / ``KIND_METRICS``) and
  each worker's background thread answers it.
* :mod:`.flight` keeps a per-rank ring of control-plane events and dumps
  it to ``HVD_TPU_FLIGHT_DIR`` on stalls, mismatches, dead peers and
  exceptions.
* :mod:`.exporter` serves ``/metrics``, ``/healthz`` and the routes
  subsystems register (serving's ``/generate``); ``init()`` starts it when
  ``HVD_TPU_METRICS_PORT`` is set.

:func:`error_event` and :func:`exception_event` keep the reference's
signatures: each is flight-recorded and dumped as there, and also printed
to stderr and kept in a bounded list of recent events
(:func:`recent_events`).  The ``analysis`` collector publishes the
run-time checkers' counts (reference :96-118, without the donation
sanitizer's, which has no counterpart).
"""

from __future__ import annotations

import collections
import sys
import threading
import time
from typing import Dict, List

from . import flight  # noqa: F401  (stdlib-only; safe to import first)
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

# Metric-name prefixes carried in a flight dump's compact tail (the
# reference's list).
_FLIGHT_TAIL_PREFIXES = ("collective.", "transport.", "host.",
                         "events.", "input.", "trace.", "chaos.",
                         "serving.", "pipeline.", "overlap.",
                         "checkpoint.", "handles.", "memory.",
                         "analysis.", "tuning.")

# Extra tail providers (keyed, replace-on-reregister): subsystems whose
# dump-time truth lives outside the registry merge a flat name -> value
# dict into every tail.  Providers must be cheap and take only leaf locks.
_extra_tails: Dict[str, object] = {}

_EVENTS_KEPT = 256
_events: "collections.deque" = collections.deque(maxlen=_EVENTS_KEPT)
_events_lock = threading.Lock()


def register_flight_tail(key: str, fn) -> None:
    _extra_tails[key] = fn


def unregister_flight_tail(key: str) -> None:
    _extra_tails.pop(key, None)


def _flight_metrics_tail() -> Dict[str, object]:
    """The compact snapshot appended to every flight dump: counters and
    gauges as bare values, histograms as count + sum.  Collectors are
    skipped (a dump may fire from under runtime locks)."""
    out: Dict[str, object] = {}
    for name, m in _default.snapshot(run_collectors=False).items():
        if not name.startswith(_FLIGHT_TAIL_PREFIXES):
            continue
        if m.get("type") == "histogram":
            out[name] = {"count": m.get("count", 0),
                         "sum": m.get("sum", 0)}
        else:
            out[name] = m.get("value", 0)
    for fn in list(_extra_tails.values()):
        try:
            out.update(fn())
        except Exception:  # noqa: BLE001 — the dump must not mask
            pass           # the original failure
    return out


flight.set_metrics_provider(_flight_metrics_tail)


def _collect_analysis(reg: MetricsRegistry) -> None:
    """Pull the hvd-analyze run-time checkers' counts.  Pull-side by
    design: the checkers run under arbitrary runtime locks (the race
    check fires inside registry methods holding ``MetricsRegistry._lock``),
    so they keep plain ints and this collector, which runs at snapshot
    time outside the registry lock, publishes them as gauges."""
    from ..analysis import races as _races
    from ..analysis import threads as _threads

    reg.gauge("analysis.race_checks",
              "lockset verifications by the data-race detector").set(
        _races.check_count())
    reg.gauge("analysis.thread_role_asserts",
              "dynamic thread-role contract verifications").set(
        _threads.assert_count())


_default.register_collector("analysis", _collect_analysis)


def registry() -> MetricsRegistry:
    return _default


def counter(name: str, help: str = "") -> Counter:
    return _default.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _default.gauge(name, help)


def histogram(name: str, kind: str = "seconds", help: str = "") -> Histogram:
    return _default.histogram(name, kind, help)


def enabled() -> bool:
    return _default.enabled


def set_enabled(v: bool) -> None:
    """Master switch for the registry and the flight recorder together.
    Re-enabling restores the flight recorder's own env gate
    (``HVD_TPU_FLIGHT``)."""
    _default.set_enabled(v)
    flight.recorder.enabled = bool(v) and flight.flight_enabled_env()


def metrics() -> Dict[str, dict]:
    """This rank's local metrics snapshot (collectors included)."""
    return _default.snapshot()


def cluster_metrics(timeout: float = 10.0) -> Dict[str, dict]:
    """Fleet-level aggregation on rank 0: every rank's snapshot, pulled
    through the coordinator's cycle, merged by :func:`aggregate`.  With
    one rank it aggregates the local snapshot.  Other ranks raise: their
    background thread answers rank 0's pull, and :func:`metrics` is their
    local view."""
    from ..core import state as _state

    _state._check_initialized()
    local = metrics()
    if _state.size() == 1:
        return aggregate({0: local})
    if _state.rank() != 0:
        raise RuntimeError(
            "cluster_metrics() aggregates on the rank-0 controller; this "
            "rank answers the controller's metrics pull automatically — "
            "use hvd.metrics() for its local snapshot.")
    return aggregate(_state._state.runtime.collect_metrics(local, timeout))


# -- events -----------------------------------------------------------------

_M_ERRORS = counter("events.errors",
                    "error and exception events (error_event, "
                    "exception_event)")
_M_STALLS = counter(
    "events.stall_warnings",
    "stall-watch warnings (tensors pending past the threshold)")
_M_DEAD_PEERS = counter(
    "events.dead_peers", "peer processes that died without a handshake")
_M_DUMPS = counter("flight.dumps", "flight-recorder dumps written")


def _dump(reason: str, extra: dict) -> None:
    if flight.dump(reason, extra=extra) is not None:
        _M_DUMPS.inc()


def _event(kind: str, where: str, text: str) -> None:
    _M_ERRORS.inc()
    with _events_lock:
        _events.append({"time": time.time(), "kind": kind, "where": where,
                        "text": text})
    print(f"[hvd-telemetry] {kind} {where}: {text}", file=sys.stderr)


def stall_event(warnings) -> None:
    """One stall-watch firing: count it, append each warning (which names
    the tensor and the ranks not ready) to the flight ring, and dump."""
    ws = list(warnings)
    if not ws:
        return
    _M_STALLS.inc(len(ws))
    for w in ws:
        flight.record("stall", w)
    _dump("stall", {"warnings": ws})


def dead_peer_event(detail: str) -> None:
    _M_DEAD_PEERS.inc()
    flight.record("dead_peer", detail)
    _dump("dead-peer", {"detail": detail})


def error_event(message: str) -> None:
    flight.record("error", message)
    _dump("error", {"message": message})
    _event("error", "", message)


def transport_fault_event(reason: str, detail: str) -> None:
    """A control-plane fault boundary fired: recorded and dumped."""
    flight.record("transport_fault", reason, detail)
    _dump(reason, {"detail": detail})


def exception_event(where: str, text: str) -> None:
    flight.record("exception", where, text)
    _dump(f"exception-{where}", {"where": where, "traceback": text})
    _event("exception", where, text)


def recent_events() -> List[dict]:
    """The last error and exception events, oldest first."""
    with _events_lock:
        return list(_events)


_M_PREFETCH_ERRORS = counter(
    "input.prefetch_errors", "loader exceptions captured by prefetchers")
_M_CKPT_ERRORS = counter(
    "checkpoint.errors", "background checkpoint writes that failed")


def prefetch_error_event(detail: str) -> None:
    """A prefetch loader raised on the stager thread (the exception
    re-raises at the consuming step; this is the forensic record)."""
    _M_PREFETCH_ERRORS.inc()
    flight.record("prefetch_error", detail)
    _dump("prefetch-error", {"detail": detail})


def checkpoint_error_event(path: str, detail: str) -> None:
    """A background checkpoint write failed (recorded even for callers
    that never wait on the handle)."""
    _M_CKPT_ERRORS.inc()
    flight.record("checkpoint_error", path, detail)
    _dump("checkpoint-error", {"path": path, "detail": detail})


def overlap_fallback_event(reason: str, detail: str) -> None:
    """The overlapped step fell back to the monolithic one: recorded
    under its named reason, not dumped (a degraded mode, not a
    failure)."""
    flight.record("overlap_fallback", reason, detail)


def install_runtime_collector() -> None:
    """Register the pull-side collector over the runtime's stats: the
    executor's counts (``collective.stats()``), the response cache, the
    handles, the megakernel's accounting and every kernel's launch
    counters.  Keyed, so a re-init replaces it.  Runs at snapshot time
    only."""

    def collect(reg: MetricsRegistry) -> None:
        from ..core import state as _state
        from ..ops import flash_attention as _fa
        from ..ops import megakernel as _mk
        from ..ops import quant as _quant
        from ..ops import serving as _serving

        rt = _state._state.runtime
        if rt is not None:
            for k, v in dict(rt.stats).items():
                reg.gauge(f"runtime.{k}").set(v)
            cache = rt.cache
            if cache is not None:
                s = cache.stats
                for k in ("hits", "misses", "flushes", "downgrades",
                          "inserts", "replayed_tensors", "plan_hits",
                          "plan_misses"):
                    reg.gauge(f"cache.{k}").set(getattr(s, k))
                reg.gauge("cache.entries").set(cache.live_entries())
                reg.gauge("cache.epoch").set(cache.epoch)
            reg.gauge("handles.live").set(rt.handles.live_count())
        ms = _mk.stats
        for k in ("launches", "hier_launches", "quant_launches",
                  "logical_bytes", "wire_bytes", "flushes"):
            reg.gauge(f"megakernel.{k}").set(getattr(ms, k))
        reg.gauge("megakernel.residual_tensors").set(_mk.residual_count())
        reg.gauge("compression.ratio").set(
            round(ms.logical_bytes / ms.wire_bytes, 4)
            if ms.wire_bytes else 1.0)
        for mod in (_fa, _quant, _serving):
            for name, n in mod.launches.items():
                reg.gauge(f"kernels.{name}.launches").set(n)

    _default.register_collector("runtime", collect)
