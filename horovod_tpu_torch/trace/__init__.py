"""hvd-trace: fleet-wide distributed tracing over the runtime (port of
horovod_tpu/trace/__init__.py:1-308).

The timeline (utils/timeline.py) answers "what happened on rank 0"; the
metrics registry answers "is the fleet healthy".  Neither explains a slow
step.  hvd-trace has three pieces:

1. **Span propagation** (this module) -- every rank keeps a bounded
   in-memory buffer of *spans* (Chrome complete events on the rank's own
   monotonic clock).  A ``(step, cycle, trace_id)`` context travels with
   the control traffic: the reference appends it as a trailer to its TCP
   request batches and response broadcasts; the port's lockstep gloo
   exchange carries it as a ``KIND_TRACE_CTX`` message in a worker's
   non-empty batch and a ``PAYLOAD_CTX`` prefix on rank 0's non-empty
   broadcast (ops/transport.py), in the same :data:`CTX_STRUCT` bytes.
   The same context is mirrored into rank 0's Chrome timeline
   (utils/timeline.set_context_provider).

2. **Clock alignment** (:mod:`.clock`) -- the reference's NTP-style
   min-RTT offset estimator, fed by probes that ride the exchange: rank 0
   stamps ``t0`` into a broadcast, each worker stamps its arrival and
   answers in its next batch (ops/collective.py ``Runtime``), and
   :func:`dump_fleet_trace` (:mod:`.merge`) merges every rank's buffer
   into ONE ``chrome://tracing`` / Perfetto file.

3. **Analysis** (:mod:`.analyze`) -- ``python -m horovod_tpu_torch.trace
   <file>`` computes per-step critical-path attribution and names the
   straggler per cycle; :class:`.watch.StragglerWatch` warns live.

Hot-path budget: recording a span is one flag check, two
``time.monotonic`` reads (taken by the caller) and one ``deque.append``
(atomic in CPython -- no lock).  ``HVD_TPU_TRACE=0`` opts out;
``set_enabled(False)`` is the run-time switch.

Env contract (the reference's):
  HVD_TPU_TRACE=0           disable span recording (default on)
  HVD_TPU_TRACE_EVENTS      span buffer capacity per rank (default 20000)
  HVD_TPU_TRACE_PING        rank 0's clock-probe cadence seconds (default
                            1, 0 disables the periodic probes)
"""

from __future__ import annotations

import collections
import os
import struct
import time
from typing import Dict, List, Optional

from .. import telemetry as _telemetry

DEFAULT_CAPACITY = 20000

_M_SPANS = _telemetry.counter(
    "trace.spans", "hvd-trace spans recorded into the local buffer")

# Wire layout of the propagated context: <u32 step><u32 cycle>
# <u64 trace_id> (the reference's trailer bytes; the port sends them as
# a message of the batch and a prefix of the broadcast,
# ops/transport.py).
CTX_STRUCT = struct.Struct("<IIQ")


def trace_enabled_env() -> bool:
    return os.environ.get("HVD_TPU_TRACE", "1") != "0"


def _capacity() -> int:
    return int(os.environ.get("HVD_TPU_TRACE_EVENTS",
                              str(DEFAULT_CAPACITY)))


def ping_interval() -> float:
    return float(os.environ.get("HVD_TPU_TRACE_PING", "1"))


class TraceState:
    """Per-process span buffer + the propagated (step, cycle, trace_id)
    context.

    The context fields are plain ints mutated by single writers (step:
    the training thread; cycle: the drain tick / receive thread) and
    read racily by span recorders — a span that lands on the previous
    cycle's id is fine (the analyzer groups per cycle, and cycle
    boundaries ARE the drain tick), so no lock is taken anywhere on the
    record path."""

    def __init__(self) -> None:
        self.enabled = trace_enabled_env()
        self.step = 0
        self.cycle = 0
        self.trace_id = 0
        self._events: collections.deque = collections.deque(
            maxlen=_capacity())

    # -- hot path ----------------------------------------------------------
    def record(self, ev: dict) -> None:
        """The one append path every event kind funnels through (the
        event-shape and accounting stay in one place)."""
        self._events.append(ev)
        _M_SPANS.inc()

    def span(self, name: str, cat: str, t0: float, t1: float,
             args: Optional[dict] = None) -> None:
        """Record one complete span.  ``t0``/``t1`` are
        ``time.monotonic()`` seconds (the clock the offset estimator
        aligns); stored as Chrome-trace microseconds."""
        if not self.enabled:
            return
        self.record({"name": name, "cat": cat, "ph": "X",
                     "ts": t0 * 1e6, "dur": max(0.0, (t1 - t0)) * 1e6,
                     "args": {"step": self.step, "cycle": self.cycle,
                              **(args or {})}})

    def instant(self, name: str, cat: str,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self.record({"name": name, "cat": cat, "ph": "i", "s": "t",
                     "ts": time.monotonic() * 1e6,
                     "args": {"step": self.step, "cycle": self.cycle,
                              **(args or {})}})

    # -- cold paths --------------------------------------------------------
    def export(self) -> List[dict]:
        return list(self._events)

    def clear(self) -> None:
        self._events.clear()


_state = TraceState()


def state() -> TraceState:
    return _state


def enabled() -> bool:
    return _state.enabled


def set_enabled(v: bool) -> None:
    """Runtime switch for span recording (the bench overhead A/B flips
    this exactly like ``telemetry.set_enabled``).  Re-enabling restores
    the env gate."""
    _state.enabled = bool(v) and trace_enabled_env()


def span(name: str, cat: str, t0: float, t1: float,
         args: Optional[dict] = None) -> None:
    _state.span(name, cat, t0, t1, args)


def instant(name: str, cat: str, args: Optional[dict] = None) -> None:
    _state.instant(name, cat, args)


def export_events() -> List[dict]:
    """This rank's local span buffer (Chrome complete events, local
    monotonic microseconds, no pid — the merge assigns ranks)."""
    return _state.export()


def clear() -> None:
    _state.clear()


# -- propagated context ----------------------------------------------------

def set_step(n: int) -> None:
    """Stamp the training step every subsequent span carries.  Called
    by the train-step wrapper (parallel/training.py) once per step;
    explicit calls override (serving loops, tests)."""
    _state.step = int(n)


def on_step() -> int:
    """Advance the step counter by one (the train-step wrapper's
    per-call hook); returns the new step."""
    _state.step += 1
    return _state.step


def current_step() -> int:
    return _state.step


def next_cycle() -> tuple:
    """Advance the negotiation-cycle counter (rank 0 / single-process
    only: one increment per response broadcast — the fleet-wide cycle
    id every rank's spans then share).  Returns the new context."""
    _state.cycle += 1
    return (_state.step, _state.cycle, _state.trace_id)


def observe_ctx(step: int, cycle: int, trace_id: int) -> None:
    """Adopt rank 0's broadcast context (worker side).  The STEP is
    deliberately not adopted: steps are a local training-loop notion
    each rank stamps itself (ranks run the same loop), while the cycle
    id must be the controller's so cross-rank spans line up."""
    _state.cycle = int(cycle)
    _state.trace_id = int(trace_id)


def current_ctx() -> tuple:
    return (_state.step, _state.cycle, _state.trace_id)


def current_args() -> Dict[str, int]:
    """The context dict mirrored into timeline event args
    (utils/timeline.set_context_provider)."""
    if not _state.enabled:
        return {}
    return {"step": _state.step, "cycle": _state.cycle}


def pack_ctx() -> bytes:
    """The 16-byte wire trailer (see CTX_STRUCT)."""
    return CTX_STRUCT.pack(_state.step & 0xFFFFFFFF,
                           _state.cycle & 0xFFFFFFFF, _state.trace_id)


def unpack_ctx(buf: bytes, off: int) -> Optional[tuple]:
    """Parse a context trailer at ``off`` when present (None when the
    payload predates the trace layer — old peer / tests poking raw
    frames)."""
    if len(buf) - off < CTX_STRUCT.size:
        return None
    return CTX_STRUCT.unpack_from(buf, off)


def reset_run(rank: int = 0, trace_id: Optional[int] = None) -> None:
    """Fresh trace for a (re-)init: new trace id on rank 0 (workers
    adopt it from the first broadcast), counters to zero, buffer
    cleared."""
    _state.step = 0
    _state.cycle = 0
    _state.enabled = trace_enabled_env()
    if trace_id is not None:
        _state.trace_id = int(trace_id)
    elif rank == 0:
        _state.trace_id = int.from_bytes(os.urandom(8), "little") or 1
    _state.clear()
    # The arrival tracker restarts with the counters: the new run
    # reuses the same (step, cycle) keys, and stale stamps would both
    # dedup away the new run's arrivals and poison its skew baseline.
    from . import watch as _watch

    _watch.tracker.clear()


def note_batch_arrival(rank: int, step: int, cycle: int,
                       t: Optional[float] = None) -> None:
    """Controller-side: one rank's negotiation traffic for a cycle
    arrived — a worker's non-empty batch (with its trace context), or
    rank 0's own first local submit of the cycle.  ``t`` is the arrival
    on rank 0's monotonic clock (default now): the port's lockstep
    exchange delivers every batch at the same instant, so a worker's
    context carries its first post's stamp, mapped through the clock
    offset (ops/collective.py).  Feeds
    the live skew tracker (:mod:`.watch`) and
    records an arrival instant — the analyzer's per-cycle straggler
    signal.  Deduplicated per (rank, step, cycle): rank 0 submits once
    per tensor but only the cycle's FIRST stamp is an arrival."""
    if not _state.enabled:
        return
    now = time.monotonic() if t is None else float(t)
    from . import watch as _watch

    if not _watch.tracker.note(rank, step, cycle, now):
        return  # duplicate stamp for this (rank, step, cycle)
    _state.record({"name": "BATCH_ARRIVAL", "cat": "negotiate",
                   "ph": "i", "s": "t", "ts": now * 1e6,
                   "args": {"step": int(step), "cycle": int(cycle),
                            "rank": int(rank)}})


# Mirror the propagated context into rank 0's Chrome timeline events.
from ..utils import timeline as _timeline  # noqa: E402

_timeline.set_context_provider(current_args)


def __getattr__(name):
    # Lazy resolution for cycle safety: this package is imported by
    # low-level modules (ops/collective) while merge imports back into
    # core state, so those submodules must not load at trace-import
    # time.  horovod_tpu_torch/__init__ re-exports both at the END of
    # the package import, when every layer exists.
    if name == "dump_fleet_trace":
        from .merge import dump_fleet_trace

        return dump_fleet_trace
    if name == "StragglerWatch":
        from .watch import StragglerWatch

        return StragglerWatch
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
