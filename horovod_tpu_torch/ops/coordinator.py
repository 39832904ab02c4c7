"""Negotiation: name-keyed readiness, cross-rank validation, fusion, stall
watch (copied from horovod_tpu/ops/coordinator.py:51-486, ``PyCoordinator``),
and the ``Coordinator`` facade that puts the response cache and the
timeline's marks above it (:565-803).

Rank 0 runs one coordinator per process set.  Every rank's requests reach
it through the control exchange (:mod:`.transport`); a tensor is ready
once every rank of its set asked for it (or joined), and the ready
tensors of one cycle become responses, fused under the threshold, that
every rank executes in the same order:

* name-keyed request table with readiness counting
  (≙ ``IncrementTensorCount``, operations.cc:222-247),
* cross-rank type/dtype/shape/root/device validation with the reference's
  messages (≙ ``ConstructMPIResponse``, operations.cc:255-461),
* response fusion (≙ operations.cc:1328-1374, :func:`.cache.plan_fusion`),
* stall detection (≙ ``CheckForStalledTensors``, operations.cc:1072-1115;
  ``HOROVOD_STALL_WARNING_SECONDS``, default 60).

The copy leaves out the reference's lock-order and race instrumentation
(the flight records are in the ``Coordinator`` facade); responses are
byte for byte the reference's.  One repair: a request for a tensor that a JOIN has already
made ready is not listed twice (the reference's next poll raises
``KeyError`` there, ROADMAP.md C.1).

:class:`NativeCoordinator` (reference :488-562) drives the C++ twin,
``native/coordinator.cc`` (built by :mod:`..native.lib`, with the same
repair), through the wire format; the ``Coordinator`` facade takes it
unless ``HVD_TPU_DISABLE_NATIVE`` is set.  Its stall watch runs on its
own clock and prints whole seconds.
"""

from __future__ import annotations

import ctypes
import os
import struct
import time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..analysis import lockorder as _lockorder
from ..analysis import program as _program
from ..analysis import races as _races
from ..native import lib as _native
from ..telemetry import flight as _flight
from . import cache as _cache
from . import megakernel as _megakernel
from . import wire
from .wire import DataType, Request, RequestType, Response, ResponseType


def stall_warning_seconds() -> float:
    """Seconds a tensor may sit in negotiation before a stall warning
    (≙ STALL_WARNING_TIME, operations.cc:208)."""
    return float(os.environ.get("HOROVOD_STALL_WARNING_SECONDS", "60"))


@dataclass
class _PendingTensor:
    requests: List[Request] = field(default_factory=list)
    ranks: set = field(default_factory=set)
    first_seen: float = 0.0
    # Payload bytes of one rank's tensor, from the first request.
    nbytes: int = 0


def _withdraw_message(name: str, rank: int) -> str:
    return (f"Collective {name} was abandoned: rank {rank} timed out "
            f"waiting for the remaining ranks; the operation fails on "
            f"all ranks.")


@_races.race_checked
class PyCoordinator:
    """The coordinator of one process set (``size`` ranks, set-local
    numbering).  Lock-guarded, like the reference's single mutex
    (operations.cc:113)."""

    def __init__(self, size: int, fusion_threshold: int):
        self.size = size
        self.fusion_threshold = fusion_threshold
        self._lock = _lockorder.make_lock("PyCoordinator._lock")
        self.table: Dict[str, _PendingTensor] = {}  # guarded_by: _lock
        self.ready: List[str] = []  # guarded_by: _lock
        # dtype and submit-time bytes per constructed response, for the
        # fusion loop.
        self._resp_dtype: Dict[str, DataType] = {}  # guarded_by: _lock
        self._resp_nbytes: Dict[str, int] = {}  # guarded_by: _lock
        # ERROR responses queued by withdraw(); drained first.
        self._withdrawn: List[Response] = []  # guarded_by: _lock
        # Ranks that called join(): ready for every tensor, zeros at
        # execution.  When all joined, a JOIN response carries the last.
        self.joined: set = set()  # guarded_by: _lock
        self._last_joined: int = -1  # guarded_by: _lock
        self._join_release: List[Response] = []  # guarded_by: _lock

    def withdraw(self, name: str, rank: int) -> None:
        """A rank abandoned ``name`` (synchronize timeout): drop the
        pending entry and queue an ERROR response for every rank.  No-op
        when negotiation already completed."""
        with self._lock:
            if name in self.ready:
                return
            self.table.pop(name, None)
            self._withdrawn.append(Response(
                ResponseType.ERROR, [name],
                error_message=_withdraw_message(name, rank)))

    def submit(self, req: Request, now: Optional[float] = None) -> bool:
        """Record one rank's request; True when every rank has reported
        the tensor.  Joined ranks count as ready for every tensor; a JOIN
        request may itself complete pending tensors (and, from the last
        rank, the join barrier)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if req.request_type == RequestType.JOIN:
                self.joined.add(req.request_rank)
                self._last_joined = req.request_rank
                for name, entry in list(self.table.items()):
                    if len(entry.ranks | self.joined) == self.size \
                            and name not in self.ready:
                        self.ready.append(name)
                if len(self.joined) == self.size:
                    # Released after the data responses of the same poll:
                    # a joined rank still contributes zeros to those.
                    self._join_release.append(Response(
                        ResponseType.JOIN,
                        tensor_sizes=[self._last_joined]))
                    self.joined = set()
                    return True
                return False
            entry = self.table.get(req.tensor_name)
            if entry is None:
                entry = _PendingTensor(first_seen=now)
                n = 1
                for d in req.tensor_shape:
                    n *= int(d)
                entry.nbytes = n * wire.dtype_size(req.tensor_type)
                self.table[req.tensor_name] = entry
            if req.request_rank in entry.ranks:
                raise ValueError(
                    f"Duplicate request for tensor {req.tensor_name} from "
                    f"replica {req.request_rank}; a name may be used by at "
                    f"most one pending collective per replica.")
            entry.requests.append(req)
            entry.ranks.add(req.request_rank)
            if len(entry.ranks | self.joined) == self.size:
                # A JOIN may already have made it ready; a second entry
                # would make the next poll construct it twice (the
                # reference's KeyError, ROADMAP.md C.1).
                if req.tensor_name not in self.ready:
                    self.ready.append(req.tensor_name)
                return True
            return False

    def construct_response(self, name: str) -> Response:
        with self._lock:
            return self._construct_response_locked(name)

    def _construct_response_locked(self, name: str) -> Response:
        entry = self.table.pop(name)
        reqs = sorted(entry.requests, key=lambda r: r.request_rank)
        first = reqs[0]
        error = None

        # Data-type agreement (operations.cc:266-279).
        for r in reqs[1:]:
            if r.tensor_type != first.tensor_type:
                error = (f"Mismatched data types: One rank had type "
                         f"{wire.dtype_name(first.tensor_type)}, but another "
                         f"rank had type {wire.dtype_name(r.tensor_type)}.")
                break
        # Operation agreement (operations.cc:283-296).
        if error is None:
            for r in reqs[1:]:
                if r.request_type != first.request_type:
                    error = (f"Mismatched collective operations: One rank did "
                             f"an {first.request_type.name.lower()}, but "
                             f"another rank did an "
                             f"{r.request_type.name.lower()}.")
                    break
        op = first.request_type
        # Allreduce: full shape agreement (operations.cc:299-330).
        if error is None and op == RequestType.ALLREDUCE:
            for r in reqs[1:]:
                if r.tensor_shape != first.tensor_shape:
                    error = (f"Mismatched allreduce tensor shapes: One rank "
                             f"sent a tensor of shape "
                             f"{list(first.tensor_shape)}, but another rank "
                             f"sent a tensor of shape "
                             f"{list(r.tensor_shape)}.")
                    break
        # Reducescatter: shape agreement, and never completes via joins.
        if error is None and op == RequestType.REDUCESCATTER:
            for r in reqs[1:]:
                if r.tensor_shape != first.tensor_shape:
                    error = (f"Mismatched reducescatter tensor shapes: One "
                             f"rank sent a tensor of shape "
                             f"{list(first.tensor_shape)}, but another rank "
                             f"sent a tensor of shape "
                             f"{list(r.tensor_shape)}.")
                    break
            if error is None and len(reqs) < self.size:
                error = ("Reducescatter cannot complete after a rank has "
                         "joined: every rank must participate to receive "
                         "its chunk of the result.")
        # Allreduce/reducescatter: reduce-op agreement.
        if error is None and op in (RequestType.ALLREDUCE,
                                    RequestType.REDUCESCATTER):
            for r in reqs[1:]:
                if r.reduce_op != first.reduce_op:
                    error = (f"Mismatched reduce operations: One rank "
                             f"specified reduce op "
                             f"{wire.reduce_op_name(first.reduce_op)}, but "
                             f"another rank specified reduce op "
                             f"{wire.reduce_op_name(r.reduce_op)}.")
                    break
            if error is None and op == RequestType.ALLREDUCE \
                    and len(reqs) < self.size and \
                    first.reduce_op not in (wire.ReduceOp.SUM,
                                            wire.ReduceOp.AVERAGE):
                error = (f"Allreduce with reduce op "
                         f"{wire.reduce_op_name(first.reduce_op)} cannot "
                         f"complete after a rank has joined: a joined "
                         f"rank's zero contribution is only an identity "
                         f"for sum/average.")
        # Allgather: same ndim, same non-first dims (operations.cc:334-392).
        tensor_sizes: List[int] = []
        if error is None and op == RequestType.ALLGATHER:
            if len(first.tensor_shape) == 0:
                error = "Rank zero tried to gather a rank-zero tensor."
            else:
                for r in reqs[1:]:
                    if len(r.tensor_shape) != len(first.tensor_shape):
                        error = (
                            f"Mismatched allgather tensor shapes: One rank "
                            f"sent a tensor of rank {len(first.tensor_shape)},"
                            f" but another rank sent a tensor of rank "
                            f"{len(r.tensor_shape)}.")
                        break
                    for dim in range(1, len(first.tensor_shape)):
                        if r.tensor_shape[dim] != first.tensor_shape[dim]:
                            error = (
                                f"Mismatched allgather tensor shapes: One "
                                f"rank sent a tensor with dimension {dim} "
                                f"equal to {first.tensor_shape[dim]}, but "
                                f"another rank sent a tensor with dimension "
                                f"{dim} equal to {r.tensor_shape[dim]}.")
                            break
                    if error:
                        break
            if error is None:
                # Rank-indexed extents; joined ranks contribute 0 rows.
                by_rank = {r.request_rank: r.tensor_shape[0] for r in reqs}
                tensor_sizes = [by_rank.get(r, 0) for r in range(self.size)]
        # Alltoall: trailing-dim agreement, splits covering dim 0, never
        # via joins; tensor_sizes carries the split matrix by sender.
        alltoall_sizes: List[int] = []
        if error is None and op == RequestType.ALLTOALL:
            if len(first.tensor_shape) == 0:
                error = "An alltoall tensor needs at least one dimension."
            for r in reqs[1:]:
                if error:
                    break
                if len(r.tensor_shape) != len(first.tensor_shape) or \
                        r.tensor_shape[1:] != first.tensor_shape[1:]:
                    error = (f"Mismatched alltoall tensor shapes: One rank "
                             f"sent a tensor of shape "
                             f"{list(first.tensor_shape)}, but another "
                             f"rank sent a tensor of shape "
                             f"{list(r.tensor_shape)}.")
            if error is None and len(reqs) < self.size:
                error = ("Alltoall cannot complete after a rank has "
                         "joined: every rank must both send and receive.")
            if error is None:
                for r in reqs:
                    d0 = r.tensor_shape[0]
                    if not r.splits:
                        if d0 % self.size != 0:
                            error = (f"Alltoall without splits needs dim 0 "
                                     f"divisible by the rank count "
                                     f"({self.size}); rank "
                                     f"{r.request_rank} sent {d0} rows.")
                            break
                        row = [d0 // self.size] * self.size
                    elif len(r.splits) != self.size or \
                            sum(r.splits) != d0 or \
                            any(s < 0 for s in r.splits):
                        error = (f"Invalid alltoall splits from rank "
                                 f"{r.request_rank}: {list(r.splits)} "
                                 f"must have one non-negative entry per "
                                 f"rank ({self.size}) summing to its dim "
                                 f"0 ({d0}).")
                        break
                    else:
                        row = list(r.splits)
                    alltoall_sizes.extend(row)
        # Broadcast: root and shape agreement (operations.cc:396-431).
        if error is None and op == RequestType.BROADCAST:
            for r in reqs[1:]:
                if r.root_rank != first.root_rank:
                    error = (f"Mismatched broadcast root ranks: One rank "
                             f"specified root rank {first.root_rank}, but "
                             f"another rank specified root rank "
                             f"{r.root_rank}.")
                    break
            if error is None:
                for r in reqs[1:]:
                    if r.tensor_shape != first.tensor_shape:
                        error = (f"Mismatched broadcast tensor shapes: One "
                                 f"rank sent a tensor of shape "
                                 f"{list(first.tensor_shape)}, but another "
                                 f"rank sent a tensor of shape "
                                 f"{list(r.tensor_shape)}.")
                        break
            if error is None and len(reqs) < self.size \
                    and first.root_rank not in {r.request_rank
                                                for r in reqs}:
                error = (f"Broadcast root rank {first.root_rank} has "
                         f"joined; a joined rank cannot be the source "
                         f"of a broadcast.")
        # Device agreement (operations.cc:418-440).
        if error is None:
            for r in reqs[1:]:
                if (r.device == wire.CPU_DEVICE_ID) != (
                        first.device == wire.CPU_DEVICE_ID):
                    error = (f"Mismatched host/device selection: One rank "
                             f"specified device {first.device}, but another "
                             f"rank specified device {r.device}.")
                    break

        if error is not None:
            return Response(ResponseType.ERROR, [name], error_message=error,
                            process_set_id=first.process_set_id)
        self._resp_dtype[name] = first.tensor_type
        self._resp_nbytes[name] = entry.nbytes
        devices = [r.device for r in reqs]
        common = dict(devices=devices, tensor_type=first.tensor_type,
                      tensor_shapes=[tuple(first.tensor_shape)],
                      process_set_id=first.process_set_id)
        if op == RequestType.ALLREDUCE:
            return Response(ResponseType.ALLREDUCE, [name],
                            reduce_op=first.reduce_op, **common)
        if op == RequestType.REDUCESCATTER:
            return Response(ResponseType.REDUCESCATTER, [name],
                            reduce_op=first.reduce_op, **common)
        if op == RequestType.ALLTOALL:
            return Response(ResponseType.ALLTOALL, [name],
                            tensor_sizes=alltoall_sizes, **common)
        if op == RequestType.ALLGATHER:
            return Response(ResponseType.ALLGATHER, [name],
                            tensor_sizes=tensor_sizes, **common)
        return Response(ResponseType.BROADCAST, [name],
                        tensor_sizes=[first.root_rank], **common)

    def poll_responses(self, sizes_bytes: Dict[str, int]) -> List[Response]:
        """Drain ready tensors into (possibly fused) responses: withdrawn
        ERRORs first, the JOIN release last.  ``sizes_bytes`` maps tensor
        name to payload bytes (rank 0's queue); a name not in it falls
        back to the submit-time size."""
        with self._lock:
            withdrawn, self._withdrawn = self._withdrawn, []
            release, self._join_release = self._join_release, []
            ready, self.ready = self.ready, []
            responses = [self._construct_response_locked(n) for n in ready]
            dtypes = dict(self._resp_dtype)
            nbytes_map = dict(self._resp_nbytes)

        metas = [_cache._FusionMeta(
            response_type=r.response_type, devices=tuple(r.devices),
            reduce_op=r.reduce_op, process_set_id=r.process_set_id,
            dtype=dtypes.get(r.tensor_names[0]),
            nbytes=sizes_bytes.get(r.tensor_names[0],
                                   nbytes_map.get(r.tensor_names[0], 0)))
            for r in responses]
        fused: List[Response] = list(withdrawn)
        for group in _cache.plan_fusion(metas,
                                        lambda _psid: self.fusion_threshold):
            r = responses[group[0]]
            for j in group[1:]:
                nxt = responses[j]
                r.tensor_names.extend(nxt.tensor_names)
                r.tensor_shapes.extend(nxt.tensor_shapes)
            fused.append(r)
        with self._lock:
            for r in fused:
                for n in r.tensor_names:
                    self._resp_dtype.pop(n, None)
                    self._resp_nbytes.pop(n, None)
        fused.extend(release)
        return fused

    def check_stalled(self, now: Optional[float] = None,
                      threshold: Optional[float] = None) -> List[str]:
        now = time.monotonic() if now is None else now
        threshold = stall_warning_seconds() if threshold is None \
            else threshold
        warnings = []
        with self._lock:
            items = [(name, entry.first_seen, set(entry.ranks))
                     for name, entry in self.table.items()]
        for name, first_seen, ranks in items:
            if now - first_seen > threshold:
                ready = sorted(ranks)
                missing = sorted(set(range(self.size)) - ranks)
                warnings.append(
                    f"Tensor {name} has been pending for "
                    f"{now - first_seen:.0f}s; ready replicas: {ready}; "
                    f"waiting on replicas: {missing}. One or more replicas "
                    f"submitted this collective and are waiting for the "
                    f"remaining replicas to do the same.")
        return warnings

    def set_fusion_threshold(self, v: int) -> None:
        with self._lock:
            self.fusion_threshold = v

    def close(self) -> None:
        with self._lock:
            self.table.clear()
            self.ready.clear()


class NativeCoordinator:
    """ctypes facade over ``native/coordinator.cc``: the same requests in,
    the same packed responses out, as :class:`PyCoordinator` (reference
    horovod_tpu/ops/coordinator.py:488-562)."""

    def __init__(self, size: int, fusion_threshold: int, lib=None):
        self._lib = lib if lib is not None else _native.load()
        self._ptr = self._lib.hvd_coord_create(size, fusion_threshold)
        self._finalize = weakref.finalize(
            self, self._lib.hvd_coord_destroy, self._ptr)
        self.size = size
        self.fusion_threshold = fusion_threshold
        # Response buffer, reused across polls (only the cycle polls) and
        # grown when a response list does not fit.
        self._out = ctypes.create_string_buffer(1 << 20)

    def submit(self, req: Request, now: Optional[float] = None) -> bool:
        buf = req.pack()
        rc = self._lib.hvd_coord_submit(self._ptr, buf, len(buf))
        if rc == -1:
            raise ValueError(
                f"Duplicate request for tensor {req.tensor_name} from "
                f"replica {req.request_rank}; a name may be used by at "
                f"most one pending collective per replica.")
        if rc < 0:
            raise RuntimeError(
                f"the native coordinator rejected the request for "
                f"{req.tensor_name} as malformed (ops/wire.py and "
                f"native/wire.cc disagree)")
        return bool(rc)

    def withdraw(self, name: str, rank: int) -> None:
        nb = name.encode("utf-8")
        self._lib.hvd_coord_withdraw(self._ptr, nb, len(nb), rank)

    def poll_responses(self, sizes_bytes: Dict[str, int]) -> List[Response]:
        # The payload sizes go as a side table: u16 count, then
        # (u16 key length, key, i64 bytes) each.
        parts = [struct.pack("<H", len(sizes_bytes))]
        for k, v in sizes_bytes.items():
            kb = k.encode("utf-8")
            parts.append(struct.pack("<H", len(kb)) + kb
                         + struct.pack("<q", v))
        side = b"".join(parts)
        if self._lib.hvd_coord_poll_responses(self._ptr, side, len(side),
                                              0.0) < 0:
            raise RuntimeError("the native coordinator could not parse "
                               "the size table")
        while True:
            n = self._lib.hvd_coord_fetch_responses(
                self._ptr, self._out, len(self._out))
            if n >= 0:
                return wire.unpack_response_list(self._out.raw[:n])
            self._out = ctypes.create_string_buffer(2 * len(self._out))

    def check_stalled(self, now: Optional[float] = None,
                      threshold: Optional[float] = None) -> List[str]:
        """Stall warnings on the library's own monotonic clock (``now``
        is not used)."""
        threshold = stall_warning_seconds() if threshold is None \
            else threshold
        cap = 1 << 16
        while True:
            out = ctypes.create_string_buffer(cap)
            n = self._lib.hvd_coord_check_stalled(self._ptr, threshold,
                                                  out, cap)
            if n >= 0:
                break
            cap *= 2
        return [w for w in out.raw[:n].decode("utf-8").split("\n") if w]

    def set_fusion_threshold(self, v: int) -> None:
        self.fusion_threshold = v
        self._lib.hvd_coord_set_fusion_threshold(self._ptr, v)

    def close(self) -> None:
        self._finalize()


_DATA_RESPONSE_TYPES = (ResponseType.ALLREDUCE, ResponseType.ALLGATHER,
                        ResponseType.BROADCAST, ResponseType.REDUCESCATTER,
                        ResponseType.ALLTOALL)


@_races.race_checked
class Coordinator:
    """A :class:`PyCoordinator` with the timeline's negotiation marks and
    the response cache's fast path above it (port of
    horovod_tpu/ops/coordinator.py:565-803, ``Coordinator``).

    With a :class:`~.cache.ResponseCache` attached, a submitted request
    equal to a cached negotiation's is accounted as a hit instead of
    entering the request table, and fully-hit cycles replay from the
    cache (``cache.take_ready`` in the cycle): ``submit`` and
    ``construct_response`` never run for them.  Negotiated requests are
    kept per rank (``_inflight``) and staged into the cache at poll time,
    so the insertion that follows in the response stream stores each
    rank's exact request.  Below it runs :class:`NativeCoordinator`, or
    :class:`PyCoordinator` when ``HVD_TPU_DISABLE_NATIVE`` is set
    (reference :593-597); a process set has a coordinator of its own.
    Submissions that are not cache hits and withdrawals go into the
    flight ring (reference :692, :725); the runtime's cycle turns
    :meth:`check_stalled`'s warnings into a ``stall_event`` (reference
    :766).  With ``HVD_TPU_VERIFY_PROGRAM=1`` the program tracker
    (``analysis/program.py``, reference :623-646) watches the request
    streams: a rank-divergent program ORDER, which the name-keyed table
    below can only stall on, becomes an ERROR response naming the first
    divergent entry at the next poll (the cache is off then,
    ``cache.cache_enabled``)."""

    def __init__(self, size: int, fusion_threshold: int, timeline=None,
                 cache=None, ranks=None):
        self.timeline = timeline
        lib = _native.active()
        self._impl = (NativeCoordinator(size, fusion_threshold, lib)
                      if lib is not None
                      else PyCoordinator(size, fusion_threshold))
        self.size = size
        self.cache = cache
        # Global rank per set-local index (identity for the global set):
        # cache entries count readiness in global ranks, so hits from the
        # wire and full requests of a process set share one table.
        self._ranks = tuple(ranks) if ranks is not None \
            else tuple(range(size))
        self._inflight_lock = _lockorder.make_lock("Coordinator._inflight")
        # name -> {global rank -> Request} of requests in negotiation,
        # kept for cache insertion once the response is broadcast.
        self._inflight: Dict[str, Dict[int, Request]] = {}  # guarded_by: _inflight_lock
        # True when the impl has seen a submit or withdraw since the last
        # poll; in the steady state every request is a hit and polling an
        # untouched impl is pure overhead.  Set AFTER the impl call and
        # cleared BEFORE the poll (the reference's ordering contract).
        self._impl_dirty = True
        self._tracker = (_program.ProgramTracker(size)
                         if _program.program_check_enabled() else None)
        self._tracker_lock = _lockorder.make_lock("Coordinator._tracker")
        # guarded_by: _tracker_lock
        self._program_errors: List[Response] = []

    @property
    def fusion_threshold(self) -> int:
        return self._impl.fusion_threshold

    def submit(self, req: Request) -> bool:
        done, _ = self.submit_ex(req)
        return done

    def submit_ex(self, req: Request) -> "tuple[bool, bool]":
        """Submit one request; returns (negotiation complete, served
        from the cache)."""
        if self.timeline is not None:
            self.timeline.negotiate_rank_ready(req.tensor_name,
                                               req.request_rank,
                                               first=req.request_rank == 0)
        if self._tracker is not None:
            # JOIN disables the tracker (join legalizes rank-divergent
            # programs); the cache is off while it runs, so every request
            # reaches this feed.
            diag = self._tracker.feed(req)
            if diag is not None:
                # Fail the divergent op on every rank at the next poll.
                with self._tracker_lock:
                    self._program_errors.append(Response(
                        ResponseType.ERROR, [req.tensor_name],
                        error_message=diag,
                        process_set_id=req.process_set_id))
        if self.cache is not None:
            if req.request_type == RequestType.JOIN:
                # Joined ranks complete tensors they never requested:
                # such negotiations must not become entries.
                self._resubmit(self.cache.disarm("hvd.join()"))
            else:
                kind, info = self.cache.lookup_and_hit(req)
                if self.timeline is not None:
                    self.timeline.cache_event(req.tensor_name,
                                              hit=kind == "hit")
                    st = self.cache.stats
                    self.timeline.cache_counter(st.hits, st.misses)
                if kind == "hit":
                    # The NEGOTIATE span of a cache-served tensor closes
                    # at replay, in the cycle.
                    return bool(info), True
                if kind == "conflict":
                    # The program changed: the cache flushed; the peers'
                    # cached submissions go through the real path, and
                    # so does this one (the usual mismatch messages).
                    self._resubmit(info)
                self._retain(req)
        # Flight ring: the negotiation traffic that is not a cache hit
        # (the hit path returned above).
        _flight.record("submit", req.tensor_name, req.request_rank,
                       req.request_type)
        try:
            done = self._impl.submit(req)
        finally:
            self._impl_dirty = True
        if done and self.timeline is not None:
            self.timeline.negotiate_end(req.tensor_name)
        return done, False

    def _retain(self, req: Request) -> None:
        local = req.request_rank
        grank = self._ranks[local] if 0 <= local < len(self._ranks) \
            else local
        with self._inflight_lock:
            self._inflight.setdefault(req.tensor_name, {})[grank] = req

    def _resubmit(self, orphans: List[Request]) -> None:
        """Feed cached submissions back through the real negotiation
        (flush, conflict and withdraw downgrades)."""
        for req in orphans:
            try:
                self._retain(req)
                self._impl.submit(req)
            except ValueError:
                pass  # duplicate: the rank submitted it again meanwhile
            finally:
                self._impl_dirty = True

    def withdraw(self, name: str, rank: int) -> None:
        _flight.record("withdraw", name, rank)
        if self.cache is not None:
            # A withdrawal means the ranks' programs diverged: invalidate,
            # downgrading cached submissions so the impl's withdraw fails
            # the op group-wide with the usual message.
            self._resubmit(self.cache.flush(
                f"withdraw of {name!r} by rank {rank}", broadcast=True))
        try:
            self._impl.withdraw(name, rank)
        finally:
            self._impl_dirty = True

    def set_fusion_threshold(self, v: int) -> None:
        self._impl.set_fusion_threshold(v)
        if self.cache is not None:
            # Entries stay valid; the memoized packing plans do not.
            self.cache.invalidate_plans(f"fusion threshold -> {v}")
        # The buckets change, and with them the residuals and ticks
        # (reference coordinator.py:751).
        _megakernel.flush(f"fusion threshold -> {v}")

    def poll_responses(self, sizes_bytes: Dict[str, int]) -> List[Response]:
        with self._tracker_lock:
            errors, self._program_errors = self._program_errors, []
        if errors:
            return errors + self._poll(sizes_bytes)
        return self._poll(sizes_bytes)

    def _poll(self, sizes_bytes: Dict[str, int]) -> List[Response]:
        if self.cache is not None and not self._impl_dirty:
            return []  # every request since the last poll was a hit
        self._impl_dirty = False
        resps = self._impl.poll_responses(sizes_bytes)
        if self.cache is not None and resps:
            staged = []
            with self._inflight_lock:
                for r in resps:
                    for n in r.tensor_names:
                        reqs = self._inflight.pop(n, None)
                        if reqs and r.response_type in _DATA_RESPONSE_TYPES:
                            staged.append((n, reqs))
            for n, reqs in staged:
                self.cache.stage_negotiated(n, reqs)
        return resps

    def check_stalled(self, now: Optional[float] = None,
                      threshold: Optional[float] = None) -> List[str]:
        """The stalled tensors' warnings, from the Python or the native
        coordinator alike (the caller prints them and passes them to
        :func:`..telemetry.stall_event`)."""
        return self._impl.check_stalled(now, threshold)

    def close(self) -> None:
        self._impl.close()
