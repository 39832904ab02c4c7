"""Continuous-batching scheduler: iteration-level admission and eviction
(a copy of horovod_tpu/serving/scheduler.py, which imports no JAX).

A request queue plus a fixed array of decode *slots*.  Every engine
iteration asks :meth:`ContinuousBatchingScheduler.admit` for newly
admissible requests (FIFO over arrival order, lowest free slot first:
deterministic batch composition given a trace) and reports each slot's
sampled token through :meth:`feed`; a sequence that hits EOS, its
``max_new_tokens`` or the KV capacity evicts at once and its slot can be
taken on the very next iteration, with no batch-boundary barrier.
Admission is strictly FIFO, so with a full batch the head of the queue
waits at most ``min(max_new_tokens, capacity)`` iterations.  An
``arrival`` stamp gates admission on a logical clock (``admit(now=i)``),
so a seeded trace replays with no wall clock in the loop.  Admission may
be gated by the KV page budget (``page_budget``/``pages_needed``): a
head-of-queue request that does not fit stops admission for the
iteration (``serving.admission_deferred``).

Telemetry: ``serving.queue_depth`` / ``serving.batch_occupancy`` gauges,
``serving.requests`` / ``serving.completed`` counters.  The lock is the
lock-order checker's named lock and the guarded fields carry the race
checker (reference :114-131).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from .. import telemetry as _telemetry
from ..analysis import lockorder as _lockorder
from ..analysis import races as _races

_M_REQUESTS = _telemetry.counter(
    "serving.requests", "requests submitted to the serving scheduler")
_M_COMPLETED = _telemetry.counter(
    "serving.completed", "sequences finished (EOS/max-len/capacity)")
_M_QUEUE = _telemetry.gauge(
    "serving.queue_depth", "requests waiting for a decode slot")
_M_OCCUPANCY = _telemetry.gauge(
    "serving.batch_occupancy", "decode slots currently generating")
_M_DEFERRED = _telemetry.counter(
    "serving.admission_deferred",
    "admit() calls that held the head-of-queue back because the KV "
    "page budget could not cover its prefill (the slot is NOT burned; "
    "admission retries next iteration)")


class FinishReason:
    EOS = "eos"
    MAX_NEW_TOKENS = "max_new_tokens"
    CAPACITY = "capacity"
    DRAINED = "drained"
    ERROR = "error"
    # The /generate client vanished mid-generation (hvd-chaos
    # hardening): its slot is released cleanly instead of decoding
    # tokens nobody will read.
    CLIENT_DISCONNECT = "client_disconnect"


@dataclass
class Request:
    """One generation request, from submission to completion.

    ``prompt`` is token ids (the server's byte tokenizer or the
    caller's own).  ``done`` is set at eviction; ``generated`` then
    holds the sampled tokens and ``finish_reason`` why it stopped.
    ``arrival`` is a logical admission gate for trace replay (see
    module docstring); ``t_submit``/``t_first_token``/``t_done`` are
    wall stamps the engine fills for the TTFT / per-token histograms.
    """

    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0     # 0 = greedy (deterministic)
    seed: int = 0                # temperature-sampling determinism
    arrival: int = 0
    rid: int = -1                # assigned by submit()
    generated: List[int] = field(default_factory=list)
    # Tokens generated by a PREVIOUS incarnation (elastic relaunch
    # continuations): result() returns prefix + generated, so callers
    # see the uninterrupted completion.
    prefix: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None
    # Set by cancel() while the request holds a slot: the serve loop
    # evicts it at its next iteration boundary (evict_cancelled) — the
    # only thread that may free KV slots, so follower cache mirrors
    # stay identical under multiprocess.
    cancel_reason: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)
    t_submit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until eviction; returns the generated tokens (with any
        pre-relaunch prefix)."""
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.rid} still in flight")
        return list(self.prefix) + list(self.generated)


@_races.race_checked
class ContinuousBatchingScheduler:
    """Queue + slots; all methods thread-safe (the HTTP front door
    submits from handler threads while the engine loop admits/feeds).
    The lock is a leaf: nothing blocking and no tensor work runs under
    it."""

    def __init__(self, max_slots: int, capacity: int) -> None:
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        self.max_slots = max_slots
        self.capacity = capacity  # max prompt+generated per sequence
        self._lock = _lockorder.make_lock(
            "serving.ContinuousBatchingScheduler._lock")
        self._queue: List[Request] = []       # guarded_by: _lock
        self._slots: List[Optional[Request]] = [None] * max_slots
        # guarded_by: _lock
        self._rid = itertools.count()         # guarded_by: _lock
        self._drained = False                 # guarded_by: _lock

    # -- submission --------------------------------------------------------
    def submit(self, request: Request) -> Request:
        if len(request.prompt) < 1:
            raise ValueError("empty prompt")
        if len(request.prompt) >= self.capacity:
            raise ValueError(
                f"prompt length {len(request.prompt)} must leave room to "
                f"generate within the KV capacity {self.capacity}")
        with self._lock:
            if self._drained:
                raise RuntimeError("scheduler is draining; no admission")
            request.rid = next(self._rid)
            self._queue.append(request)
            _M_REQUESTS.inc()
            _M_QUEUE.set(len(self._queue))
        return request

    # -- the per-iteration contract ---------------------------------------
    def admit(self, now: Optional[int] = None,
              page_budget: Optional[int] = None,
              pages_needed: Optional[Callable[[Request], int]] = None,
              ) -> List[Tuple[int, Request]]:
        """Fill free slots from the queue: FIFO over submission order,
        lowest free slot index first, only requests whose ``arrival``
        stamp has passed (``now=None`` admits regardless).  Returns the
        newly admitted ``(slot, request)`` pairs — the engine prefills
        exactly these.

        ``page_budget``/``pages_needed`` gate admission on KV headroom
        (hvd-spec satellite): before a request takes a slot, its
        prefill's fresh-page demand (``pages_needed(req)`` — net of
        any shared prefix pages) is charged against the budget.  A
        head-of-queue request that does not fit STOPS admission for
        this iteration — strictly FIFO, so deferral cannot reorder
        completions — and counts ``serving.admission_deferred``; the
        slot is never burned only to fail page allocation
        mid-iteration."""
        admitted: List[Tuple[int, Request]] = []
        deferred = False
        with self._lock:
            if self._drained:
                return []
            free = [i for i, r in enumerate(self._slots) if r is None]
            keep: List[Request] = []
            budget = page_budget
            for i, req in enumerate(self._queue):
                if deferred:
                    keep.append(req)
                    continue
                if free and (now is None or req.arrival <= now):
                    if budget is not None and pages_needed is not None:
                        need = pages_needed(req)
                        if need > budget:
                            deferred = True
                            keep.append(req)
                            continue
                        budget -= need
                    slot = free.pop(0)
                    self._slots[slot] = req
                    admitted.append((slot, req))
                else:
                    keep.append(req)
            self._queue = keep
            _M_QUEUE.set(len(self._queue))
            _M_OCCUPANCY.set(self.max_slots - len(free))
        if deferred:
            _M_DEFERRED.inc()
        return admitted

    def feed(self, slot: int, token: int,
             expect: Optional[Request] = None) -> Optional[str]:
        """Record one sampled token for ``slot``.  Returns None while
        the sequence continues, or the :class:`FinishReason` when this
        token finished it (the slot is then already free — iteration-
        level eviction).

        ``expect`` makes the call safe against a concurrent drain: if
        the slot no longer holds that request (evicted mid-iteration
        by the elastic thread), the token is discarded and the
        request's already-set finish reason is returned instead of
        raising — the engine's iteration completes cleanly and the
        exported continuation reproduces the discarded token."""
        with self._lock:
            req = self._slots[slot]
            if req is None or (expect is not None and req is not expect):
                if expect is not None:
                    return expect.finish_reason or FinishReason.DRAINED
                raise ValueError(f"slot {slot} is not active")
            req.generated.append(token)
            reason = None
            if req.eos_id is not None and token == req.eos_id:
                reason = FinishReason.EOS
            elif len(req.generated) >= req.max_new_tokens:
                reason = FinishReason.MAX_NEW_TOKENS
            elif len(req.prompt) + len(req.generated) >= self.capacity:
                reason = FinishReason.CAPACITY
            if reason is not None:
                self._finish_locked(slot, req, reason)
            return reason

    def _finish_locked(self, slot: int, req: Request, reason: str,
                       notify: bool = True) -> None:
        self._slots[slot] = None
        req.finish_reason = reason
        _M_COMPLETED.inc()
        _M_OCCUPANCY.set(sum(r is not None for r in self._slots))
        if notify:
            req.done.set()

    # -- per-request abort (hvd-chaos: client disconnect) ------------------
    def cancel(self, req: Request, reason: str) -> str:
        """Abort ONE request: a still-queued request finishes
        immediately with ``reason``; an active one is only MARKED —
        the serve loop evicts it at its next iteration boundary via
        :meth:`evict_cancelled` (KV slots are serve-loop property).
        Returns "queued" / "active" / "gone" (already finished)."""
        with self._lock:
            if req in self._queue:
                self._queue.remove(req)
                _M_QUEUE.set(len(self._queue))
                req.finish_reason = reason
                _M_COMPLETED.inc()
                req.done.set()
                return "queued"
            if any(r is req for r in self._slots):
                req.cancel_reason = reason
                return "active"
            return "gone"

    def evict_cancelled(self) -> List[int]:
        """Serve-loop iteration boundary: finish + free every slot
        whose request was cancelled; returns the freed slot indices so
        the engine releases the KV pages (and, under multiprocess,
        rides them on the step broadcast's evict list)."""
        freed: List[int] = []
        with self._lock:
            for slot, req in enumerate(self._slots):
                if req is not None and req.cancel_reason is not None:
                    self._finish_locked(slot, req, req.cancel_reason)
                    freed.append(slot)
        return freed

    # -- introspection -----------------------------------------------------
    def active(self) -> List[Tuple[int, Request]]:
        """Active ``(slot, request)`` pairs, slot-ordered (the decode
        batch composition — deterministic)."""
        with self._lock:
            return [(i, r) for i, r in enumerate(self._slots)
                    if r is not None]

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def pending(self) -> List[Request]:
        """Snapshot of the queued-but-unadmitted requests (FIFO)."""
        with self._lock:
            return list(self._queue)

    def snapshot(self) -> Tuple[List[Tuple[int, Request]], List[Request]]:
        """``(active, pending)`` under ONE lock hold — the export
        path's view.  Two separate :meth:`active`/:meth:`pending` calls
        can miss a request admitted between them (the elastic
        drain_commit runs concurrently with the serve loop)."""
        with self._lock:
            return ([(i, r) for i, r in enumerate(self._slots)
                     if r is not None],
                    list(self._queue))

    def occupancy(self) -> int:
        with self._lock:
            return sum(r is not None for r in self._slots)

    def idle(self) -> bool:
        with self._lock:
            return (not self._queue
                    and all(r is None for r in self._slots))

    # -- elastic drain -----------------------------------------------------
    def drain(self, reason: str = FinishReason.DRAINED, notify: bool = True,
              ) -> Tuple[List[Request], List[Request]]:
        """Stop admission and evict every in-flight sequence with
        ``reason`` (its partial ``generated`` is preserved on the
        request).  Returns ``(drained, pending)`` — the evicted
        in-flight requests and the queued-but-never-admitted ones, both
        captured under the SAME lock hold that empties the queue, so a
        submission racing the drain is either in ``pending`` or was
        rejected; it cannot be silently dropped.  The elastic relaunch
        path requeues ``pending`` plus continuations of ``drained``
        (``elastic.ServingState``); the error-recovery path fails both
        (``InferenceEngine.abort_all``).  ``notify=False`` leaves the
        evicted requests' ``done`` unset, for a caller that sets it once
        its recovery is over."""
        with self._lock:
            self._drained = True
            pending = list(self._queue)
            self._queue = []
            drained = []
            for slot, req in enumerate(self._slots):
                if req is not None:
                    drained.append(req)
                    self._finish_locked(slot, req, reason, notify)
            _M_QUEUE.set(0)
        return drained, pending

    def resume(self) -> None:
        """Re-open admission after a drain (same process; a relaunch
        constructs a fresh scheduler instead)."""
        with self._lock:
            self._drained = False
