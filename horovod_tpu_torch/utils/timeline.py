"""Chrome-tracing timeline of the negotiated collectives (port of
horovod_tpu/utils/timeline.py, the Python ``Timeline``; ≙ Horovod's
common/timeline.{h,cc}).

A ``chrome://tracing``-loadable JSON array, written on rank 0 only, when
``HOROVOD_TIMELINE=<path>`` is set at ``init`` or between
``start_timeline(path)`` and ``stop_timeline()``.  Each tensor is a trace
"process" (its own row, named after the tensor); its life is
NEGOTIATE_<OP> (begin at rank 0's enqueue, an instant per rank whose
request rank 0 took in, end when every rank has asked or its cached
response replays), then the top-level <OP> span (args: ``phase``
EXECUTE and ``cache`` hit or miss) holding the activities.

Activity names, mapped to what the port does (the reference's XLA_*
names would be false here):

  QUEUE                    — the response waits in its cycle behind the
                             responses executed before it
  WAIT_FOR_DATA            — (GPU) the executor's stream is made to wait
                             for the tensor's ReadyEvent, recorded on the
                             producer's stream at enqueue
  MEMCPY_IN_FUSION_BUFFER  — the ``torch.cat`` pack into the flat buffer
  NCCL_<OP> / GLOO_<OP>    — the ``torch.distributed`` call(s) on the data
                             group (ALLREDUCE, ALLGATHER, BCAST, ALLTOALL,
                             REDUCESCATTER, ADASUM), Average's divide
                             included
  MEMCPY_OUT_FUSION_BUFFER — the views or copies out of the flat buffer

On the GPU the spans are the host's enqueue of that work, not the
device's execution of it (the device runs it later, in stream order).
Response-cache markers: a CACHE_HIT / CACHE_MISS instant on the tensor's
row and a ``response_cache`` counter track of cumulative hits and misses.

When the native library is active (``HVD_TPU_DISABLE_NATIVE`` unset),
events are formatted and flushed by its C++ writer, ``native/timeline.cc``
(reference utils/timeline.py:67-180): the same events, names and rows.
It has no counter phase, so the ``response_cache`` counter becomes an
instant on a ``response_cache`` row with the same args, as in the
reference.  Opening and closing a timeline go into the flight ring
(reference :86, :221).  The trace layer (``trace/__init__.py``) installs a
context provider (reference :51-58, :126-128): begin and instant events
carry the propagated ``(step, cycle)`` in their args, so rank 0's
timeline joins against fleet-trace spans on the same keys.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from ..analysis import lockorder as _lockorder
from ..native import lib as _native
from ..telemetry import flight as _flight

# Flush cadence, seconds (≙ TIMELINE_FLUSH_TIME, timeline.h:32).
_FLUSH_SECONDS = 1.0

# Event phase chars of the Chrome trace format.
_PH_METADATA = "M"
_PH_BEGIN = "B"
_PH_END = "E"
_PH_INSTANT = "i"
# Their codes in native/timeline.cc's hvd_timeline_event.
_NATIVE_PH = {_PH_BEGIN: 0, _PH_END: 1, _PH_INSTANT: 2, _PH_METADATA: 3}

# hvd-trace context mirror: when set (trace/__init__.py), begin and
# instant events' args carry the propagated (step, cycle).  A late-bound
# module global, so this module stays importable without the trace layer.
_context_provider = None


def set_context_provider(fn) -> None:
    """Install (or clear, with None) the callable whose dict is merged
    into every begin and instant event's args (hvd-trace's
    ``current_args``)."""
    global _context_provider
    _context_provider = fn


class Timeline:
    def __init__(self, path: str):
        self._path = path
        self._lock = _lockorder.make_lock("Timeline._lock")
        self._tensor_pids = {}
        self._next_pid = 1
        self._start = time.monotonic()
        self._last_flush = self._start
        # Events are written with a LEADING ",\n" after the first, so the
        # file is one valid JSON array as soon as close() writes "]".
        self._fresh = True
        self._file = None
        self._lib = _native.active()
        self._native = None
        if self._lib is not None:
            self._native = self._lib.hvd_timeline_create(path.encode())
        else:
            self._file = open(path, "w")
            self._file.write("[\n")
        # A dump that shows a timeline was live names the file.
        _flight.record("timeline_open", path)

    # -- low-level ---------------------------------------------------------
    def _ts_us(self) -> float:
        return (time.monotonic() - self._start) * 1e6

    def _pid_locked(self, tensor: str) -> int:
        pid = self._tensor_pids.get(tensor)
        if pid is None:
            pid = self._next_pid
            self._next_pid += 1
            self._tensor_pids[tensor] = pid
            # Name the "process" row after the tensor (timeline.cc:59-76).
            self._emit_locked({"name": "process_name", "ph": _PH_METADATA,
                               "pid": pid, "args": {"name": tensor}})
            self._emit_locked({"name": "process_sort_index",
                               "ph": _PH_METADATA, "pid": pid,
                               "args": {"sort_index": pid}})
        return pid

    def _emit_locked(self, ev: dict) -> None:
        if self._file is None:
            return
        self._file.write(("" if self._fresh else ",\n") + json.dumps(ev))
        self._fresh = False
        now = time.monotonic()
        if now - self._last_flush > _FLUSH_SECONDS:
            self._file.flush()
            self._last_flush = now

    def _event(self, ph: str, tensor: str, name: str = "",
               args: Optional[dict] = None) -> None:
        # Writers run on the cycle's thread and on callers' threads while
        # stop_timeline() may close the file: the whole event holds the
        # lock, and an event after close is a silent no-op.  Begin and
        # instant events carry the trace context; explicit args win.
        if _context_provider is not None and ph in (_PH_BEGIN,
                                                    _PH_INSTANT):
            ctx = _context_provider()
            if ctx:
                args = {**ctx, **(args or {})}
        with self._lock:
            if self._native is not None:
                self._lib.hvd_timeline_event(
                    self._native, _NATIVE_PH[ph], tensor.encode(),
                    name.encode(), json.dumps(args or {}).encode(), 0.0)
                return
            ev = {"ph": ph, "ts": self._ts_us(),
                  "pid": self._pid_locked(tensor)}
            if name:
                ev["name"] = name
            if args:
                ev["args"] = args
            self._emit_locked(ev)

    # -- negotiation phase (timeline.cc:106-134) ---------------------------
    def negotiate_start(self, tensor: str, op_name: str) -> None:
        self._event(_PH_BEGIN, tensor, f"NEGOTIATE_{op_name.upper()}",
                    args={"phase": "NEGOTIATE"})

    def negotiate_rank_ready(self, tensor: str, rank: int,
                             first: bool = False) -> None:
        self._event(_PH_INSTANT, tensor, str(rank))

    def negotiate_end(self, tensor: str) -> None:
        self._event(_PH_END, tensor)

    # -- response cache (ops/cache.py) -------------------------------------
    def cache_event(self, tensor: str, hit: bool) -> None:
        """Instant on the tensor's row: its negotiation was served from
        (CACHE_HIT) or missed (CACHE_MISS) the response cache."""
        self._event(_PH_INSTANT, tensor,
                    "CACHE_HIT" if hit else "CACHE_MISS",
                    args={"cache": "hit" if hit else "miss"})

    def cache_counter(self, hits: int, misses: int) -> None:
        """Counter track of cumulative response-cache hits and misses
        (ph "C", a stacked area in the trace viewer)."""
        with self._lock:
            if self._native is not None:
                self._lib.hvd_timeline_event(
                    self._native, _NATIVE_PH[_PH_INSTANT], b"response_cache",
                    b"response_cache",
                    json.dumps({"hit": hits, "miss": misses}).encode(), 0.0)
                return
            self._emit_locked({"ph": "C", "ts": self._ts_us(), "pid": 0,
                               "name": "response_cache",
                               "args": {"hit": hits, "miss": misses}})

    # -- top-level + activities (timeline.cc:136-182) ----------------------
    def start(self, tensor: str, op_name: str, args: Optional[dict] = None
              ) -> None:
        self._event(_PH_BEGIN, tensor, op_name.upper(), args)

    def activity_start(self, tensor: str, activity: str) -> None:
        self._event(_PH_BEGIN, tensor, activity)

    def instant(self, tensor: str, name: str,
                args: Optional[dict] = None) -> None:
        self._event(_PH_INSTANT, tensor, name, args)

    def activity_end(self, tensor: str) -> None:
        self._event(_PH_END, tensor)

    def end(self, tensor: str, dtype: str = "", shape: str = "") -> None:
        args = {}
        if dtype:
            args["dtype"] = dtype
        if shape:
            args["shape"] = shape
        self._event(_PH_END, tensor, args=args or None)

    def close(self) -> None:
        """Finish the file (a valid JSON array).  Idempotent; an event
        after it is a no-op."""
        _flight.record("timeline_close", self._path)
        with self._lock:
            if self._native is not None:
                self._lib.hvd_timeline_close(self._native)  # frees it
                self._native = None
            if self._file is not None:
                self._emit_locked(
                    {"ph": _PH_INSTANT, "ts": self._ts_us(), "pid": 0,
                     "name": "shutdown"})
                self._file.write("\n]\n")
                self._file.close()
                self._file = None
