"""Crash/stall flight recorder: a per-rank ring of control-plane events
(a copy of horovod_tpu/telemetry/flight.py, which imports nothing of JAX;
only :func:`_rank_of` differs, reading this package's ``core/state``).

Today's failure story for a distributed stall is a one-line warning on
rank 0 ("Tensor X has been pending for 60s...").  The flight recorder
turns that into a replayable forensic record: every rank keeps a
fixed-size in-memory ring of recent control-plane events (negotiation
submits, broadcast responses, coalesced frames, cache epoch
transitions, withdrawals) and, when something goes
wrong — a stall warning, a cross-rank mismatch diagnostic, a dead-peer
poison, an unhandled exception on the drain/receive threads — dumps the
ring to ``HVD_TPU_FLIGHT_DIR`` as structured JSON whose tail names the
exact divergence point (docs/metrics.md documents the format).

Hot-path budget: ``record`` is one ``time.monotonic`` read plus one
``deque.append`` (atomic in CPython — no lock).  Recording is on by
default (``HVD_TPU_FLIGHT=0`` opts out; ``telemetry.set_enabled(False)``
silences it together with the metrics registry); *dumping* additionally
requires ``HVD_TPU_FLIGHT_DIR`` to be set.

This module is intentionally stdlib-only (no imports from the rest of
the package at load time) so low-level modules can feed it without
cycles.

Env contract:
  HVD_TPU_FLIGHT=0          disable recording (default on)
  HVD_TPU_FLIGHT_DIR        directory for dump files (unset = no dumps)
  HVD_TPU_FLIGHT_EVENTS     ring capacity (default 2000)
"""

from __future__ import annotations

import collections
import json
import os
import re
import threading
import time
from typing import Dict, List, Optional

DEFAULT_CAPACITY = 2000

# Dumps are rate-limited per reason and capped per process: a stall
# that warns every tick must not fill the disk with identical rings.
MIN_DUMP_INTERVAL_SECONDS = 5.0
MAX_DUMPS_PER_PROCESS = 50

_SAN_RE = re.compile(r"[^A-Za-z0-9_.-]+")


def flight_enabled_env() -> bool:
    return os.environ.get("HVD_TPU_FLIGHT", "1") != "0"


def flight_dir() -> Optional[str]:
    return os.environ.get("HVD_TPU_FLIGHT_DIR") or None


# Compact metrics tail appended to every dump: a stall/dead-peer dump
# then carries the collective/transport/host counters at dump time, so
# the forensic record is self-contained — no separate hvd.metrics()
# call to correlate by hand.  Injected (set_metrics_provider, from
# telemetry/__init__.py) so this module stays stdlib-only.
_metrics_provider = None


def set_metrics_provider(fn) -> None:
    """Install the callable whose dict becomes each dump's ``metrics``
    tail (None clears it).  The provider must be cheap and lock-free —
    dumps fire from failure paths that may hold runtime locks."""
    global _metrics_provider
    _metrics_provider = fn


def _metrics_tail() -> Optional[dict]:
    if _metrics_provider is None:
        return None
    try:
        return _metrics_provider()
    except Exception:  # noqa: BLE001 — the dump must not mask failures
        return None


def _rank_of() -> int:
    """Best-effort rank for dump filenames; resolved lazily so this
    module never imports runtime state at load time."""
    try:
        from ..core import state as _state

        if _state.is_initialized():
            return _state.rank()
    except Exception:  # noqa: BLE001 — dumping must never raise
        pass
    for var in ("HVD_TPU_RANK", "JAX_PROCESS_INDEX", "RANK"):
        v = os.environ.get(var)
        if v and v.isdigit():
            return int(v)
    return 0


class FlightRecorder:
    """Fixed-size ring of (monotonic, kind, args) event tuples."""

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None) -> None:
        self.capacity = capacity if capacity is not None else int(
            os.environ.get("HVD_TPU_FLIGHT_EVENTS", str(DEFAULT_CAPACITY)))
        self.enabled = (flight_enabled_env() if enabled is None
                        else bool(enabled))
        # deque.append/popleft are atomic under the GIL: the hot path
        # takes no lock.  The plain (unchecked) lock below guards ONLY
        # the cold dump bookkeeping; it nests inside no other lock and
        # no runtime lock is acquired while holding it.
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._dump_lock = threading.Lock()
        self._last_dump: Dict[str, float] = {}
        self._dump_count = 0

    # -- hot path ----------------------------------------------------------
    def record(self, kind: str, *args) -> None:
        """Append one event.  ``args`` should be small scalars/strings
        already formatted — the recorder stores them as-is and only
        stringifies at dump time."""
        if self.enabled:
            self._events.append((time.monotonic(), kind, args))

    # -- cold paths --------------------------------------------------------
    def snapshot(self) -> List[tuple]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()

    def dump(self, reason: str, extra: Optional[dict] = None,
             directory: Optional[str] = None) -> Optional[str]:
        """Write the ring to ``<dir>/hvd_flight_rank<r>_<seq>_<reason>.json``.

        Returns the path, or None when dumping is disabled, the
        per-reason rate limit applies, or the per-process cap is
        reached.  Never raises: the recorder is a diagnostic of last
        resort and must not mask the original failure."""
        d = directory or flight_dir()
        if d is None or not self.enabled:
            return None
        now = time.monotonic()
        with self._dump_lock:
            last = self._last_dump.get(reason)
            if last is not None and now - last < MIN_DUMP_INTERVAL_SECONDS:
                return None
            if self._dump_count >= MAX_DUMPS_PER_PROCESS:
                return None
            self._last_dump[reason] = now
            self._dump_count += 1
            seq = self._dump_count
        try:
            rank = _rank_of()
            events = [
                {"t": round(t, 6), "kind": kind,
                 "args": [a if isinstance(a, (int, float)) else str(a)
                          for a in args]}
                for t, kind, args in self.snapshot()
            ]
            payload = {
                "format": "hvd-flight-v1",
                "reason": reason,
                "rank": rank,
                "pid": os.getpid(),
                "wall_time": time.time(),
                "monotonic": now,
                "capacity": self.capacity,
                "extra": extra or {},
                "events": events,
            }
            tail = _metrics_tail()
            if tail is not None:
                payload["metrics"] = tail
            os.makedirs(d, exist_ok=True)
            slug = _SAN_RE.sub("-", reason)[:48] or "event"
            path = os.path.join(
                d, f"hvd_flight_rank{rank}_{seq:03d}_{slug}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)  # readers never see a partial file
            return path
        except Exception:  # noqa: BLE001 — see docstring
            return None


# Process-global recorder every runtime layer feeds.
recorder = FlightRecorder()


def record(kind: str, *args) -> None:
    recorder.record(kind, *args)


def dump(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    return recorder.dump(reason, extra=extra)


def snapshot() -> List[tuple]:
    return recorder.snapshot()
