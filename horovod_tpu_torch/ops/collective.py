"""Horovod's eager, named, negotiated collectives on ``torch.distributed``
(port of the eager path of horovod_tpu/ops/collective.py: the op queue
:1221-1297, ``_enqueue`` :2356, the background loop :1299, ``_drain``
:2174, the response executors :1452/:1777, ``join`` :2033 and the public
surface :2429-2913).

A ``*_async`` call queues its op under a name and posts a request; the
background thread of every rank exchanges the cycle's requests with rank
0 (:mod:`.transport`), whose coordinator (:mod:`.coordinator`) answers
with one response list, validated and fused, that every rank executes in
the same order.  Ranks may therefore issue collectives in different
orders (gradient hooks fire in each rank's autograd order): they match
up by name.  ``synchronize`` waits for the handle and returns the result
on the input's device; an ERROR response, a withdrawal, a shutdown or a
failed collective call raises :class:`HorovodError` there.

Execution, per response, on the data group (NCCL on ``cuda``, gloo on
``cpu``; a process set's own group for its ops):

* ALLREDUCE (Sum, Average, Min, Max, Product), fused, and split into
  buckets by each tensor's wire format under the compression policy
  (:mod:`.compression`): per bucket one ``torch.cat`` pack, the
  reduction of :func:`.megakernel.launch` (one collective uncompressed;
  a cast; the int8/int4 two-phase exchange with its kernels; or the
  hierarchy's three legs), Average's divide once on the flat result
  (floor for integers), then a view or copy out per tensor; Adasum, one
  tensor, by pairwise exchanges (below);
* ALLGATHER by the negotiated dim 0 of each rank (padded to the longest);
* BROADCAST from the negotiated root; ALLTOALL by the negotiated split
  matrix (``all_to_all_single``); REDUCESCATTER (Sum, Average);
* ERROR, JOIN (joined ranks contribute zeros), SHUTDOWN.

Streams (GPU): ``_enqueue`` records a CUDA event on the caller's current
stream (Horovod's ReadyEvent) -- a gradient hook runs on the autograd
engine's stream -- and the executor's stream waits on it before it packs.
``synchronize`` makes the caller's current stream wait on the event the
executor recorded after the collective.  Tensors used across the two
streams are ``record_stream``ed, so the caching allocator keeps them
until both are done.

Cycles run on the background thread (async progress, every
``HOROVOD_CYCLE_TIME`` ms) and inline in a caller waiting in
``synchronize``/``join`` (the reference's synchronize drains the same
way), one at a time under ``cycle_lock``: the data groups' calls follow
response order whichever thread makes them.

Callers do not modify an input (or in-place target) between the
``*_async`` call and ``synchronize``, and do not keep negotiated ops in
flight across a monolithic step (:mod:`..parallel.data` reduces on its
own communicator; two communicators whose kernels interleave differently
on two ranks can deadlock).

The response cache (:mod:`.cache`, on unless
``HVD_TPU_RESPONSE_CACHE=0`` on rank 0): a request equal to a cached
negotiation's goes as its entry index, and a cycle whose tensors every
rank hit replays the stored responses on rank 0 -- ``submit``,
``construct_response`` and ``plan_fusion`` do not run -- and, all replay,
goes to the workers as entry indices.  Every rank observes the response
stream in order (insertion, ``CACHE_FLUSH`` markers, the process-set
registration rule); flushes come with ``join``, a withdrawal, a program
change, capacity, ``add_process_set``/``remove_process_set`` and
shutdown.  With one rank there is no exchange, and the replay still
skips the negotiation.  ``Handle.cache_hit`` tells which requests hit.

Rank 0's timeline (:mod:`..utils.timeline`, ``HOROVOD_TIMELINE`` or
``start_timeline``) gets the NEGOTIATE spans at enqueue and negotiation,
then each tensor's QUEUE, WAIT_FOR_DATA (GPU), MEMCPY_IN_FUSION_BUFFER,
``NCCL_``/``GLOO_`` collective and MEMCPY_OUT_FUSION_BUFFER activities.

ALLREDUCE with Adasum (ROADMAP.md A.6; never fused) runs pairwise
exchanges with ``batch_isend_irecv``: the recursive-doubling ladder, or
VHDD when n > 2 and the tensor has at least 2n elements.

Telemetry (reference :160-185, :1395-1420): ``collective.submitted``/
``completed``/``errors`` and ``collective.negotiate_seconds``; an ERROR
response is an ``error_event`` (flight-recorded and dumped), a failed
control exchange or a peer's unexpected SHUTDOWN a ``dead_peer_event``,
a stall warning a ``stall_event``.  Rank 0's :meth:`Runtime.collect_metrics`
pulls every rank's metrics snapshot through the cycle
(:func:`..telemetry.cluster_metrics`).
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .. import chaos as _chaos
from .. import telemetry as _telemetry
from .. import trace as _trace
from ..analysis import lockorder as _lockorder
from ..analysis import program as _program
from ..analysis import races as _races
from ..core import state as _state
from ..trace import clock as _trace_clock
from . import cache as _cache
from . import compression as _compression
from . import megakernel as _megakernel
from . import process_set as _ps
from . import transport as _tp
from . import wire
from .coordinator import Coordinator, stall_warning_seconds
from .handles import Handle, HandleManager, HorovodError
from .wire import ReduceOp, Request, RequestType, Response, ResponseType

Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Adasum = ReduceOp.ADASUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT

# Error-message parity with the reference's SHUT_DOWN_ERROR
# (operations.cc:181-188).
SHUT_DOWN_ERROR_MESSAGE = (
    "Horovod has been shut down. This was caused by an exception on one of "
    "the ranks or an attempt to allreduce, allgather or broadcast a tensor "
    "after one of the ranks finished execution.")

# torch 2.13 renamed reduce_scatter_tensor; older releases have only it.
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)

_M_SUBMITTED = _telemetry.counter(
    "collective.submitted", "collective ops enqueued on this rank")
_M_COMPLETED = _telemetry.counter(
    "collective.completed", "collective ops whose data launch finished")
_M_ERRORS = _telemetry.counter(
    "collective.errors", "collective ops failed by an ERROR response or "
    "a failed launch")
_M_NEGOTIATE_S = _telemetry.histogram(
    "collective.negotiate_seconds", "seconds",
    "enqueue to the start of execution (negotiation + queueing)")

_DATA_RESPONSES = (ResponseType.ALLREDUCE, ResponseType.ALLGATHER,
                   ResponseType.BROADCAST, ResponseType.REDUCESCATTER,
                   ResponseType.ALLTOALL)

# Timeline activity of each unfused data response (utils/timeline.py).
_ACTIVITY = {ResponseType.ALLGATHER: "ALLGATHER",
             ResponseType.BROADCAST: "BCAST",
             ResponseType.ALLTOALL: "ALLTOALL",
             ResponseType.REDUCESCATTER: "REDUCESCATTER"}


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _deliver(o, value: torch.Tensor) -> torch.Tensor:
    """The op's result: ``value``, or copied into its in-place target."""
    if o.out is None:
        return value
    o.out.copy_(value.view(o.out.shape))
    return o.out


# The reduction family of each reduce op (reference :80-84); only psum
# (SUM, AVERAGE) compresses or decomposes hierarchically.
_OP_KERNEL = {ReduceOp.SUM: "psum", ReduceOp.AVERAGE: "psum",
              ReduceOp.MIN: "pmin", ReduceOp.MAX: "pmax",
              ReduceOp.PRODUCT: "pprod"}


def _tensor_wire_format(name: str, psid: int, red_op: ReduceOp, dtype,
                        shape) -> Optional[_compression.WireFormat]:
    """The policy's wire format for one tensor, or None for full
    precision (reference :801): min, max, product and Adasum never
    compress, nor do integers."""
    if _OP_KERNEL.get(red_op) != "psum":
        return None
    return _compression.policy_format_for(name, psid, dtype,
                                          _numel(shape))


def _partition_by_wire(names: Sequence[str], shapes, psid: int,
                       red_op: ReduceOp, dtype):
    """``[(fmt, [positions])]``: one fused response split by per-tensor
    wire format, in first-appearance order (reference :812-829).  Every
    rank splits alike: it depends on negotiated fields and the policy,
    which is uniform across ranks."""
    buckets: Dict[Any, List[int]] = {}
    for pos, (name, shape) in enumerate(zip(names, shapes)):
        fmt = _tensor_wire_format(name, psid, red_op, dtype, shape)
        buckets.setdefault(fmt, []).append(pos)
    return list(buckets.items())


# ---------------------------------------------------------------------------
# Adasum (ROADMAP.md A.6; horovod_tpu/ops/collective.py:445-538)
# ---------------------------------------------------------------------------

def _exchange(send: torch.Tensor, peer: int, group) -> torch.Tensor:
    """Swap ``send`` with the rank ``peer`` (a global rank) of ``group``:
    one send and one receive, batched (NCCL and gloo both take P2P)."""
    recv = torch.empty_like(send)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send.contiguous(), peer, group),
            dist.P2POp(dist.irecv, recv, peer, group)]):
        work.wait()
    return recv


def _adasum_coeffs(dot, na, nb):
    """The pairwise Adasum scales: ``1 - a.b / 2|a|^2`` and
    ``1 - a.b / 2|b|^2`` (0 correction for a zero vector)."""
    zero = torch.zeros_like(dot)
    ca = 1.0 - torch.where(na > 0, dot / (2.0 * na), zero)
    cb = 1.0 - torch.where(nb > 0, dot / (2.0 * nb), zero)
    return ca, cb


def _adasum_ladder(v: torch.Tensor, group, n: int, me: int, glob) -> \
        torch.Tensor:
    """Recursive doubling (≙ ``_adasum_ladder`` :445): log2(n) rounds,
    each swapping the whole vector with the partner at distance 2^r and
    combining ``ca * v + cb * other``.  The formula is symmetric, so
    both partners get the same bits with no agreement round."""
    for r in range(int(math.log2(n))):
        other = _exchange(v, glob(me ^ (1 << r)), group)
        ca, cb = _adasum_coeffs(torch.dot(v, other), torch.dot(v, v),
                                torch.dot(other, other))
        v = ca * v + cb * other
    return v


def _adasum_vhdd(v: torch.Tensor, group, n: int, me: int, glob) -> \
        torch.Tensor:
    """Vector halving, distance doubling (≙ ``_adasum_vhdd`` :473): at
    round r partners swap complementary halves of their fragment,
    combine, and recurse; after log2(n) rounds each rank owns 1/n of the
    combined vector and a mirrored doubling phase gathers it -- about
    2|v| on the wire against the ladder's log2(n)|v|.

    Each round's three dot products span the whole 2^(r+1)-rank block,
    whose members hold disjoint pieces of the block's (a, b) pair.  The
    reference sums them with a grouped ``psum``; ``torch.distributed``
    has no grouped reduce within one group, and a subgroup per block and
    round would be log2(n) sets of communicators, each created by every
    rank.  So every rank all-gathers its three partial sums (3n floats a
    round) and adds its block's rows, in rank order: every member of a
    block computes the same bits."""
    orig = v.numel()
    pad = (-orig) % n
    if pad:
        v = torch.cat([v, v.new_zeros(pad)])
    logn = int(math.log2(n))
    frag = v
    for r in range(logn):
        half = frag.numel() // 2
        lo, hi = frag[:half], frag[half:]
        keep_lo = ((me >> r) & 1) == 0
        mine, send = (lo, hi) if keep_lo else (hi, lo)
        recv = _exchange(send, glob(me ^ (1 << r)), group)
        a, b = (mine, recv) if keep_lo else (recv, mine)  # block-0's: a
        part = torch.stack([torch.dot(a, b), torch.dot(a, a),
                            torch.dot(b, b)])
        parts = [torch.empty_like(part) for _ in range(n)]
        dist.all_gather(parts, part, group=group)
        first = (me >> (r + 1)) << (r + 1)
        dot, na, nb = torch.stack(parts[first:first + (2 << r)]).sum(0)
        ca, cb = _adasum_coeffs(dot, na, nb)
        frag = ca * a + cb * b
    for r in range(logn - 1, -1, -1):
        recv = _exchange(frag, glob(me ^ (1 << r)), group)
        keep_lo = ((me >> r) & 1) == 0
        frag = torch.cat([frag, recv] if keep_lo else [recv, frag])
    return frag[:orig]


def _adasum(x: torch.Tensor, group, n: int, me: int,
            ranks=None) -> torch.Tensor:
    """Adasum of ``x`` over the ``n`` ranks of ``group`` (``me`` is this
    rank's index there; ``ranks`` the set's global ranks, None for the
    world), in ``promote_types(dtype, float32)`` as the reference.  VHDD
    when n > 2 and x has at least 2n elements, else the ladder (:532):
    at n = 2 both move the same bytes and the ladder makes one call a
    round instead of two.  n = 1 returns x (no round)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    v = x.reshape(-1).to(acc, copy=True)

    def glob(i):
        return i if ranks is None else ranks[i]

    if n > 2 and x.numel() >= 2 * n:
        v = _adasum_vhdd(v, group, n, me, glob)
    else:
        v = _adasum_ladder(v, group, n, me, glob)
    return v.to(x.dtype).reshape(x.shape)


@dataclass
class _QueuedOp:
    name: str
    op: RequestType
    tensor: torch.Tensor  # the contribution, on the runtime's device
    red_op: ReduceOp
    handle: Handle
    nbytes: int
    ps: Any = None  # ProcessSet for non-global ops
    out: Optional[torch.Tensor] = None  # in-place target
    ready: Any = None  # CUDA event on the caller's stream
    request: Optional[Request] = None  # for the cache's insertion
    cache_hit: bool = False  # sent as a cache hit, not as the request
    t_submit: float = 0.0  # perf_counter at enqueue
    t_submit_mono: float = 0.0  # monotonic at enqueue, when tracing


@_races.race_checked
class Runtime:
    """The negotiated collectives of one ``init``: op queue, outbox,
    handles, rank 0's coordinator and the background thread (the
    reference's ``OpQueue`` :1246, its drain loop and the transports'
    message flow; its lock names: ``OpQueue._lock`` and
    ``collective._drain_lock``).

    Besides the requests, the exchange carries the analysis and trace
    traffic that the reference sends as frames of their own: each
    worker's program signature (``verify_program``) and rank 0's verdict,
    the trace pulls (``dump_fleet_trace``), the clock probes
    (``trace/clock.py``) and the trace context, all on the thread that
    runs the cycle."""

    def __init__(self, st) -> None:
        self.st = st
        self.rank, self.size = st.rank, st.size
        self.device = st.device
        self.handles = HandleManager()
        self._lock = _lockorder.make_lock("OpQueue._lock")
        self._ops: Dict[str, _QueuedOp] = {}  # guarded_by: _lock
        self._outbox: List[bytes] = []  # guarded_by: _lock
        self._names: Dict[str, int] = {}  # guarded_by: _lock
        # Held for a whole cycle; quiesce() holds it across submissions.
        self.cycle_lock = _lockorder.make_lock("collective._drain_lock")
        self._work = threading.Event()  # posted since the last cycle
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.channel = (_tp.ControlChannel(st.control_group, st.rank,
                                           st.size)
                        if st.size > 1 else None)
        self.cache = (_cache.ResponseCache(rank=st.rank)
                      if self._cache_agreed() else None)
        self._hits: List[Tuple[int, int]] = []  # guarded_by: _lock
        # Rank 0's Chrome trace (utils/timeline.py), or None.
        self.timeline = None
        self.coordinator = (Coordinator(st.size, st.fusion_threshold_bytes,
                                        cache=self.cache)
                            if st.rank == 0 else None)
        self.joining = False
        self._unrouted: List[Request] = []  # rank 0: sets not yet known
        self._last_stall_check = time.monotonic()
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self.peer_shutdown = False
        self.shutdown_message = SHUT_DOWN_ERROR_MESSAGE
        self.join_result: Optional[int] = None
        self._join_done = threading.Event()
        self.stats = self._zero_stats()
        # cluster_metrics: rank 0 asks for the ranks' snapshots in a
        # cycle's broadcast; each worker answers in its next batch.
        self._metrics_ask = False  # rank 0; guarded_by: _lock
        self._metrics_due = False  # workers: answer in the next batch
        self._metrics_replies: Dict[int, dict] = {}  # guarded_by: _lock
        self._metrics_done = threading.Event()
        # verify_program: the workers' signatures (rank 0) and the
        # verdict rank 0 broadcasts next; a worker's verdict.
        self._sig_replies: Dict[int, bytes] = {}  # guarded_by: _lock
        self._sig_all = threading.Event()
        # guarded_by: _lock
        self._sig_verdict: Optional[Tuple[bool, str]] = None
        self._sig_sent = threading.Event()
        self._sig_result: Optional[Tuple[bool, str]] = None
        self._sig_done = threading.Event()
        # dump_fleet_trace: rank 0's pull and the workers' span buffers.
        self._trace_ask = False  # guarded_by: _lock
        self._trace_due = False  # workers: answer in the next batch
        self._trace_replies: Dict[int, list] = {}  # guarded_by: _lock
        self._trace_done = threading.Event()
        # Clock probes (trace/clock.py): rank 0's estimator set and probe
        # cadence; a worker's last probe (t0, its receipt stamp).
        self.clock = _trace_clock.ClockSync()
        self._ping_interval = _trace.ping_interval()
        self._last_ping = 0.0
        self._probe_burst = 0  # guarded_by: _lock
        self._pong: Optional[Tuple[float, float]] = None
        # Monotonic stamp of the first post since the last cycle's batch.
        self._first_post: Optional[float] = None  # guarded_by: _lock

    @staticmethod
    def _zero_stats() -> Dict[str, int]:
        """tensors: tensors executed in data responses; responses: data
        responses executed; collective_calls: torch.distributed calls on
        the data groups; cache_hits / cache_misses: this rank's requests
        sent as a hit on its cache replica / sent whole."""
        return {"tensors": 0, "responses": 0, "collective_calls": 0,
                "cache_hits": 0, "cache_misses": 0}

    def _cache_agreed(self) -> bool:
        """``HVD_TPU_RESPONSE_CACHE`` as rank 0 reads it: every replica
        must exist for entry indices to mean the same tensor, so the job
        follows rank 0."""
        enabled = _cache.cache_enabled()
        if self.channel is not None:
            flag = torch.tensor([int(enabled)], dtype=torch.int64)
            dist.broadcast(flag, src=0, group=self.st.control_group)
            enabled = bool(flag.item())
        return enabled

    def _coordinators(self) -> list:
        """Rank 0: the global set's coordinator, then the sets' by id."""
        return [self.coordinator] + [
            ps.coordinator for _, ps in sorted(_state.process_sets().items())
            if ps.coordinator is not None]

    def set_timeline(self, timeline) -> None:
        """Swap rank 0's timeline (None stops it) between cycles; the old
        file is finished after the cycle in flight."""
        with self.cycle_lock:
            old, self.timeline = self.timeline, timeline
            if self.coordinator is not None:
                for coord in self._coordinators():
                    coord.timeline = timeline
        if old is not None:
            old.close()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="hvd-torch-background")
        self._thread.start()

    def shutdown(self) -> None:
        """Post a SHUTDOWN request and run cycles until the SHUTDOWN
        response comes back (every rank stops with it), then stop the
        thread; whatever is still queued fails."""
        if self._thread is None:
            return
        if not self._stopped.is_set():
            self._post([_tp.encode_shutdown()])
            while not self._stopped.is_set():
                self.run_cycle()
        self._work.set()
        self._thread.join()
        self._poison(self.shutdown_message)
        self.set_timeline(None)

    def _loop(self) -> None:
        """≙ the reference's background loop: a cycle every
        ``HOROVOD_CYCLE_TIME``, so async ops progress while the caller
        computes.  With more than one rank every cycle is an exchange all
        ranks must join, so it ticks even when idle; with one rank it
        sleeps until something is posted, then waits one cycle time to
        gather more before it runs (an idle tick would only take the
        interpreter lock from a host-bound caller)."""
        if self._stream is not None:
            torch.cuda.set_device(self.device)
        while not self._stopped.is_set():
            if self.channel is None:
                self._work.wait()
            if self._stopped.wait(self.st.tick_seconds):
                break
            # hvd-chaos coord.tick_delay: a starved background thread;
            # results must not change (reference :1310-1314).
            if _chaos.active():
                _chaos.sleep_site("coord.tick_delay")
            self.run_cycle()

    def run_cycle(self) -> None:
        """One cycle, on the background thread or inline in a waiting
        caller (serialized by ``cycle_lock``).  If the control exchange
        itself fails (a peer died, the control group broke), nothing more
        can be agreed: every pending op fails and the runtime stops."""
        try:
            self._cycle()
        except Exception as exc:  # noqa: BLE001 — see the docstring
            traceback.print_exc(file=sys.stderr)
            self.peer_shutdown = True
            self.shutdown_message = (
                f"Horovod has been shut down: the control exchange "
                f"failed on rank {self.rank}: {exc!r}")
            _telemetry.dead_peer_event(self.shutdown_message)
            self._stopped.set()
            if self.cache is not None:
                self.cache.flush("control exchange failed")
            self._poison(self.shutdown_message)

    # -- enqueue side (any thread) ----------------------------------------
    def auto_name(self, prefix: str, ps=None) -> str:
        """A unique op name (≙ torch/mpi_ops.cc:35-40
        "prefix.noname.<n>"); process sets get their own namespace."""
        if ps is not None and ps.process_set_id:
            prefix = f"ps{ps.process_set_id}.{prefix}"
        with self._lock:
            n = self._names.get(prefix, 0) + 1
            self._names[prefix] = n
        return f"{prefix}.noname.{n}"

    def _post(self, messages: List[bytes]) -> None:
        with self._lock:
            self._outbox.extend(messages)
        self._work.set()

    def enqueue(self, specs: Sequence[dict]) -> List[int]:
        """Queue ops given as ``_QueuedOp`` fields plus ``root_rank`` and
        ``splits``; all requests enter the same cycle's batch."""
        if self.peer_shutdown:
            raise HorovodError(self.shutdown_message)
        ops, msgs, hits = [], [], []
        cache = self.cache
        tracing = _trace.enabled()
        for spec in specs:
            x, ps = spec["tensor"], spec["ps"]
            home = x.device
            if x.device != self.device:
                x = x.to(self.device)
            ready = None
            if self.device.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            dt = wire.dtype_of(x.dtype)
            out = spec.get("out")
            h = self.handles.allocate(
                spec["name"], home=home if out is None else out.device,
                keep=(x, out))
            req = Request(
                request_rank=self.rank if ps is None else ps.rank(),
                request_type=spec["op"], tensor_type=dt,
                tensor_name=spec["name"], root_rank=spec["root_rank"],
                device=(home.index if home.type == "cuda"
                        else wire.CPU_DEVICE_ID),
                tensor_shape=tuple(x.shape), reduce_op=spec["red_op"],
                process_set_id=0 if ps is None else ps.process_set_id,
                splits=tuple(spec["splits"]))
            # A request equal to a cached negotiation's goes as its entry
            # index (ops/cache.py); rank 0 replays the stored response.
            hit = cache.worker_lookup(req) if cache is not None else None
            if hit is None:
                msgs.append(_tp.encode_request(req))
            else:
                hits.append(hit)
            h.cache_hit = hit is not None
            ops.append(_QueuedOp(
                name=spec["name"], op=spec["op"], tensor=x,
                red_op=spec["red_op"], handle=h,
                nbytes=max(_numel(x.shape), 1) * wire.dtype_size(dt),
                ps=ps, out=out, ready=ready, request=req,
                cache_hit=hit is not None, t_submit=time.perf_counter(),
                t_submit_mono=time.monotonic() if tracing else 0.0))
        with self._lock:
            taken = [o.name for o in ops if o.name in self._ops]
            if taken or len({o.name for o in ops}) < len(ops):
                for o in ops:
                    self.handles.release(o.handle.id)
                raise ValueError(
                    f"A collective named {(taken or [ops[0].name])[0]!r} is "
                    f"already pending; tensor names must be unique among "
                    f"in-flight ops (reference keys its TensorTable the "
                    f"same way, operations.cc:1568-1572).")
            for o in ops:
                self._ops[o.name] = o
            self._outbox.extend(msgs)
            self._hits.extend(hits)
            self.stats["cache_hits"] += len(hits)
            self.stats["cache_misses"] += len(msgs)
            if tracing and self._first_post is None:
                self._first_post = time.monotonic()
        _M_SUBMITTED.inc(len(ops))
        if tracing and self.rank == 0 and self.channel is not None:
            # Rank 0's own arrival for the live skew (the reference's
            # ControllerTransport.submit; the tracker keeps the first).
            step, cycle, _tid = _trace.current_ctx()
            _trace.note_batch_arrival(0, step, cycle)
        tl = self.timeline
        if tl is not None:
            for o in ops:
                tl.negotiate_start(o.name, o.op.name)
                if o.cache_hit:
                    tl.cache_event(o.name, hit=True)
        self._work.set()
        return [o.handle.id for o in ops]

    def pending(self, handle_ids: Sequence[int]) -> bool:
        """Whether any of these handles' ops still waits for its
        response (the executor has not taken it)."""
        with self._lock:
            return any(self.handles.get(h).name in self._ops
                       for h in handle_ids)

    def _take(self, names: Sequence[str]) -> Dict[str, _QueuedOp]:
        with self._lock:
            return {n: self._ops.pop(n) for n in names if n in self._ops}

    def _poison(self, message: str) -> None:
        """Fail every queued op (≙ the SHUT_DOWN_ERROR callback flush,
        operations.cc:1377-1474)."""
        with self._lock:
            ops, self._ops = list(self._ops.values()), {}
        for o in ops:
            o.handle.finish(error=HorovodError(message))
        self._join_done.set()

    def collect_metrics(self, local: dict,
                        timeout: float) -> Dict[int, dict]:
        """Rank 0: every rank's metrics snapshot by rank, ``local`` as
        rank 0's.  The next cycle's broadcast asks; each worker's
        background thread answers in the batch of its cycle after that.
        A rank that has not answered within ``timeout`` seconds is left
        out (the reference's pull behaves the same)."""
        with self._lock:
            self._metrics_replies = {}
            self._metrics_done.clear()
            self._metrics_ask = True
        self._work.set()
        self._metrics_done.wait(timeout)
        with self._lock:
            replies = dict(self._metrics_replies)
        return {0: local, **replies}

    # -- verify_program's exchange (analysis/program.py) -------------------
    def collect_signatures(self, payload: bytes,
                           timeout: float) -> Dict[int, bytes]:
        """Rank 0: every rank's packed signature by rank, ``payload`` as
        rank 0's.  Each worker's arrives in a batch of its own
        ``verify_program`` call; a rank missing after ``timeout`` seconds
        fails the verification (every rank must take part)."""
        self._work.set()
        if not self._sig_all.wait(timeout):
            with self._lock:
                got = sorted(self._sig_replies)
            raise HorovodError(
                f"verify_program timed out after {timeout:.0f}s: ranks "
                f"{sorted(set(range(1, self.size)) - set(got))} did not "
                f"send their program signature (every rank must call "
                f"verify_program).")
        with self._lock:
            replies, self._sig_replies = self._sig_replies, {}
            self._sig_all.clear()
        return {0: payload, **replies}

    def broadcast_signature_result(self, error: Optional[str],
                                   timeout: float) -> None:
        """Rank 0: the verdict goes out in the next cycle's broadcast;
        returns once it has."""
        with self._lock:
            self._sig_sent.clear()
            self._sig_verdict = (error is not None, error or "")
        self._work.set()
        self._sig_sent.wait(timeout)

    def exchange_signature(self, payload: bytes,
                           timeout: float) -> Optional[str]:
        """A worker: send the packed signature in the next batch and wait
        for rank 0's verdict (None when the programs agree)."""
        self._sig_done.clear()
        self._post([_tp.encode_signature(payload)])
        if not self._sig_done.wait(timeout):
            raise HorovodError(
                f"verify_program timed out after {timeout:.0f}s waiting "
                f"for rank 0's verdict (every rank must call "
                f"verify_program).")
        bad, text = self._sig_result
        return text if bad else None

    # -- the fleet trace (trace/merge.py, trace/clock.py) -------------------
    def collect_traces(self, local: list,
                       timeout: float) -> Dict[int, list]:
        """Rank 0: every rank's span buffer by rank, ``local`` as rank
        0's (the ``collect_metrics`` pattern; a rank that has not
        answered within ``timeout`` seconds is left out)."""
        with self._lock:
            self._trace_replies = {}
            self._trace_done.clear()
            self._trace_ask = True
        self._work.set()
        self._trace_done.wait(timeout)
        with self._lock:
            replies = dict(self._trace_replies)
        return {0: local, **replies}

    def measure_clock_offsets(self, timeout: float = 2.0,
                              probes: int = 8) -> Dict[int, float]:
        """Rank 0: ``probes`` clock probes in consecutive cycles, then
        the workers' offsets (seconds, worker clock minus rank 0's)."""
        if self.channel is None or self.rank != 0:
            return {}
        with self._lock:
            self._probe_burst = probes
        self._work.set()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            counts = self.clock.sample_counts()
            with self._lock:
                left = self._probe_burst
            if left == 0 and len(counts) == self.size - 1:
                break
            time.sleep(self.st.tick_seconds)
        return self.clock.offsets()

    def _note_pongs(self, pongs, t2: float) -> None:
        """Rank 0: feed each worker's probe answer to the estimator, its
        hold time between receipt and send taken out (trace/clock.py)."""
        for r, (t0, t1, t1s) in pongs:
            self.clock.on_pong(r, t0, t1, t2 - (t1s - t1))

    def _note_arrivals(self, ctxs, t2: float) -> None:
        """Rank 0: each worker's first post of the batch, on rank 0's
        clock where its offset is known (else the batch's arrival)."""
        offsets = self.clock.offsets()
        for r, (step, cycle, _tid, t_post) in ctxs:
            off = offsets.get(r)
            _trace.note_batch_arrival(
                r, step, cycle, t2 if off is None else t_post - off)

    def _broadcast_prefixes(self, responses: List[Response]
                            ) -> Tuple[bytes, bool]:
        """Rank 0: the cycle's metrics pull, verdict, trace pull, probe
        and context."""
        with self._lock:
            ask, self._metrics_ask = self._metrics_ask, False
            verdict, self._sig_verdict = self._sig_verdict, None
            pull, self._trace_ask = self._trace_ask, False
            burst = self._probe_burst
            if burst:
                self._probe_burst = burst - 1
        tracing = _trace.enabled()
        now = time.monotonic()
        ping = None
        if tracing and (burst or (self._ping_interval > 0 and now
                                  - self._last_ping >= self._ping_interval)):
            self._last_ping = now
            ping = now
        ctx = _trace.pack_ctx() if tracing and responses else None
        return (_tp.encode_prefixes(pull_metrics=ask, signature=verdict,
                                    pull_trace=pull, ping=ping, ctx=ctx),
                verdict is not None)

    # -- one cycle (background thread) -------------------------------------
    def _cycle(self) -> None:
        with self.cycle_lock:
            if self._stopped.is_set():
                return
            self._work.clear()
            with self._lock:
                batch = b"".join(self._outbox) + _tp.encode_hits(self._hits)
                self._outbox, self._hits = [], []
                t_post, self._first_post = self._first_post, None
            if self._metrics_due:
                self._metrics_due = False
                batch += _tp.encode_metrics(_telemetry.metrics())
            if self._trace_due:
                self._trace_due = False
                batch += _tp.encode_trace(_trace.export_events())
            if self.rank != 0 and self.channel is not None:
                if t_post is not None and _trace.enabled():
                    batch += _tp.encode_trace_ctx(_trace.pack_ctx(), t_post)
                if self._pong is not None:
                    (t0, t1), self._pong = self._pong, None
                    batch += _tp.encode_pong(t0, t1, time.monotonic())
            if self.channel is None:
                batches = [batch]
            else:
                batches = self.channel.gather(batch)
            responses: List[Response] = []
            cache = self.cache
            if self.rank == 0:
                tick_t0 = time.monotonic()
                responses, groups, epoch, compact, n_other, replay_ids = \
                    self._negotiate(batches)
                if responses and _trace.enabled():
                    # The fleet-wide cycle id advances before the
                    # broadcast, whose context carries it (reference
                    # ops/collective.py:2208-2217).
                    _trace.next_cycle()
                    _trace.span("negotiate.tick", "negotiate", tick_t0,
                                time.monotonic(),
                                args={"responses": len(responses)})
                # Rank 0 reaches its own stream position before it
                # publishes the stream.
                if cache is not None:
                    for resp in responses:
                        cache.observe_response(
                            resp, replay=id(resp) in replay_ids)
            if self.channel is not None:
                payload = b""
                verdict_sent = False
                if self.rank == 0 and responses:
                    # A cycle that is all replay goes as entry indices.
                    payload = (_tp.encode_replay(groups, epoch)
                               if compact and groups and n_other == 0
                               else _tp.encode_responses(responses))
                if self.rank == 0:
                    prefixes, verdict_sent = \
                        self._broadcast_prefixes(responses)
                    payload = prefixes + payload
                payload = self.channel.broadcast(payload)
                if verdict_sent:
                    self._sig_sent.set()
                if self.rank != 0:
                    payload = self._observe_prefixes(payload)
                if self.rank != 0 and payload:
                    kind, body = _tp.decode_payload(payload)
                    responses = (cache.rebuild_groups(*body)
                                 if kind == _tp.PAYLOAD_REPLAY else body)
                    if cache is not None:
                        for resp in responses:
                            # Insertion keeps this rank's own requests;
                            # replayed responses find their names present.
                            with self._lock:
                                own = {n: self._ops[n].request
                                       for n in resp.tensor_names
                                       if n in self._ops}
                            cache.observe_response(
                                resp, own_requests={self.rank: own})
            tl = self.timeline
            if tl is not None:
                self._timeline_queue(tl, responses)
            for resp in responses:
                if self._stopped.is_set():
                    break
                self._execute(resp, tl)

    def _observe_prefixes(self, payload: bytes) -> bytes:
        """A worker: act on rank 0's broadcast prefixes (transport.py);
        returns the payload after them."""
        t1 = time.monotonic()
        found, rest = _tp.strip_prefixes(payload)
        if found.get(_tp.PAYLOAD_PULL_METRICS):
            self._metrics_due = True
        if found.get(_tp.PAYLOAD_PULL_TRACE):
            self._trace_due = True
        if _tp.PAYLOAD_SIGNATURE in found:
            self._sig_result = found[_tp.PAYLOAD_SIGNATURE]
            self._sig_done.set()
        if _tp.PAYLOAD_PING in found:
            self._pong = (found[_tp.PAYLOAD_PING], t1)
        if _tp.PAYLOAD_CTX in found and _trace.enabled():
            # Adopt rank 0's cycle id before executing, so this rank's
            # spans land under the same fleet-wide cycle.
            _trace.observe_ctx(*found[_tp.PAYLOAD_CTX])
        return rest

    def _coordinator_for(self, psid: int):
        if psid == 0:
            return self.coordinator
        ps = _ps.get(psid)
        return None if ps is None else ps.coordinator

    def _resubmit_orphans(self, orphans: List[Request]) -> None:
        """Cached submissions a flush downgraded go back through the
        real negotiation, each to its set's coordinator."""
        for req in orphans:
            coord = self._coordinator_for(req.process_set_id)
            if coord is None:
                continue  # the set was removed; its submitter times out
            try:
                coord.submit(req)
            except ValueError:
                pass  # duplicate: the rank submitted it again meanwhile

    def _negotiate(self, batches: List[bytes]):
        """Rank 0: account every rank's cache hits, submit its requests,
        poll every coordinator (the global set first, then the sets by
        id), watch for stalls.  Returns the cycle's responses in the
        stream order every replica relies on -- the cache's flush marker,
        the replayed responses, then the freshly negotiated ones -- with
        the replay's entry-index groups and epoch, whether the replay may
        go compact, the number of responses that are not replays, and
        the ids of the replayed ones (never inserted again)."""
        errors: List[Response] = []
        shutdown = False
        pending, self._unrouted = self._unrouted, []
        withdrawals = []
        pongs, ctxs = [], []
        t2 = time.monotonic()  # the batches' arrival (clock probes)
        cache = self.cache
        for r, b in enumerate(batches):
            for kind, body in _tp.decode_batch(b):
                if kind == _tp.KIND_REQUEST:
                    pending.append(body)
                elif kind == _tp.KIND_HITS:
                    epoch, idxs = body
                    for idx in idxs:
                        # A hit that raced a flush comes back as its
                        # stored request: a real submit (downgrade).
                        down = cache.hit_from_wire(idx, r, epoch)
                        if down is not None:
                            pending.append(down)
                elif kind == _tp.KIND_WITHDRAW:
                    withdrawals.append((r, body))
                elif kind == _tp.KIND_METRICS:
                    with self._lock:
                        self._metrics_replies[r] = body
                        if len(self._metrics_replies) == self.size - 1:
                            self._metrics_done.set()
                elif kind == _tp.KIND_SIGNATURE:
                    with self._lock:
                        self._sig_replies[r] = body
                        if len(self._sig_replies) == self.size - 1:
                            self._sig_all.set()
                elif kind == _tp.KIND_TRACE:
                    with self._lock:
                        self._trace_replies[r] = body
                        if len(self._trace_replies) == self.size - 1:
                            self._trace_done.set()
                elif kind == _tp.KIND_PONG:
                    pongs.append((r, body))
                elif kind == _tp.KIND_TRACE_CTX:
                    ctxs.append((r, body))
                else:
                    shutdown = True
        if pongs or ctxs:
            self._note_pongs(pongs, t2)
            self._note_arrivals(ctxs, t2)
        for req in pending:
            coord = self._coordinator_for(req.process_set_id)
            if coord is None:  # the set's registration is not done here yet
                self._unrouted.append(req)
                continue
            try:
                coord.submit(req)
            except ValueError as exc:
                errors.append(Response(ResponseType.ERROR, [req.tensor_name],
                                       error_message=str(exc),
                                       process_set_id=req.process_set_id))
        for r, (psid, name) in withdrawals:
            coord = self._coordinator_for(psid)
            if coord is not None:
                ps = _ps.get(psid)
                coord.withdraw(name, r if ps is None else ps.local_rank_of(r))
        coords = self._coordinators()
        marker, replayed, groups, epoch, compact = None, [], [], 0, True
        if cache is not None:
            self._resubmit_orphans(cache.check_capacity())
            marker = cache.take_flush_marker()
            thresholds = {psid: ps.coordinator.fusion_threshold
                          for psid, ps in _state.process_sets().items()
                          if ps.coordinator is not None}
            thresholds[0] = self.coordinator.fusion_threshold
            replayed, groups, epoch, compact = cache.take_ready(
                lambda psid: thresholds.get(psid, 0))
            tl = self.timeline
            if tl is not None:
                # The NEGOTIATE span of a cache-served tensor closes here.
                for resp in replayed:
                    for n in resp.tensor_names:
                        tl.negotiate_end(n)
        with self._lock:
            meta = {n: o.nbytes for n, o in self._ops.items()}
        negotiated = errors
        for coord in coords:
            negotiated += coord.poll_responses(meta)
        # hvd-chaos coord.reorder: permute only this cycle's freshly
        # negotiated responses, never across the flush marker or the
        # replays, whose order keeps the cache replicas aligned
        # (reference :2155-2166).  Every rank executes the broadcast
        # order, so the results stay bitwise.
        if _chaos.active():
            negotiated = _chaos.maybe_reorder("coord.reorder", negotiated)
        now = time.monotonic()
        stall_s = stall_warning_seconds()
        if now - self._last_stall_check > stall_s:
            self._last_stall_check = now
            for coord in coords:
                warnings = coord.check_stalled(now, stall_s)
                for w in warnings:
                    print(f"WARNING: {w}", file=sys.stderr, flush=True)
                _telemetry.stall_event(warnings)
        if shutdown:
            negotiated.append(Response(ResponseType.SHUTDOWN,
                                       error_message=SHUT_DOWN_ERROR_MESSAGE))
        # The marker first: replicas flush before inserting anything this
        # cycle negotiated.
        head = [marker] if marker is not None else []
        return (head + replayed + negotiated, groups, epoch, compact,
                len(head) + len(negotiated),
                frozenset(id(r) for r in replayed))

    def _timeline_queue(self, tl, responses: List[Response]) -> None:
        """Rank 0: open each held tensor's top-level span and its QUEUE
        activity; the QUEUE ends when its response starts executing."""
        with self._lock:
            held = dict(self._ops)
        for resp in responses:
            if resp.response_type not in _DATA_RESPONSES:
                continue
            for n in resp.tensor_names:
                o = held.get(n)
                if o is not None:
                    tl.start(n, resp.response_type.name,
                             args={"phase": "EXECUTE",
                                   "cache": "hit" if o.cache_hit
                                   else "miss"})
                    tl.activity_start(n, "QUEUE")

    # -- execution (background thread, response order) ---------------------
    def _execute(self, resp: Response, tl=None) -> None:
        rt = resp.response_type
        if rt == ResponseType.ERROR:
            mt0 = time.monotonic()
            err = HorovodError(resp.error_message)
            taken = self._take(resp.tensor_names)
            _M_ERRORS.inc(max(len(taken), 1))
            _telemetry.error_event(resp.error_message or "")
            for o in taken.values():
                o.handle.finish(error=err)
            self._trace_spans(resp, taken, mt0)
            return
        if rt == ResponseType.JOIN:
            self.join_result = resp.tensor_sizes[0] if resp.tensor_sizes \
                else -1
            self._join_done.set()
            return
        if rt == ResponseType.SHUTDOWN:
            if resp.error_message and \
                    resp.error_message != SHUT_DOWN_ERROR_MESSAGE:
                # Not the agreed shutdown: a rank's control exchange
                # failed (worker side of reference :1415).
                _telemetry.dead_peer_event(resp.error_message)
            self.peer_shutdown = True
            self.shutdown_message = resp.error_message \
                or SHUT_DOWN_ERROR_MESSAGE
            self._stopped.set()
            if self.cache is not None:
                # Cached cycles never replay across the teardown.
                self.cache.flush("shutdown")
            self._poison(self.shutdown_message)
            return
        if rt not in _DATA_RESPONSES:
            return  # CACHE_FLUSH: the cache observed it already
        ps = _ps.get(resp.process_set_id) if resp.process_set_id else None
        if resp.process_set_id and (ps is None or not ps.included()):
            return  # not a member: the set's members run it
        ops = self._take(resp.tensor_names)
        mt0 = time.monotonic()
        if _telemetry.enabled():
            t0 = time.perf_counter()
            for o in ops.values():
                _M_NEGOTIATE_S.observe(t0 - o.t_submit)
        if tl is not None:
            for name in ops:
                tl.activity_end(name)  # QUEUE
        try:
            if self._stream is None:
                outs = self._run(resp, ops, ps, tl)
                event = None
            else:
                with torch.cuda.stream(self._stream):
                    for name, o in ops.items():
                        if tl is not None:
                            tl.activity_start(name, "WAIT_FOR_DATA")
                        self._stream.wait_event(o.ready)
                        o.tensor.record_stream(self._stream)
                        if o.out is not None and o.out.is_cuda:
                            o.out.record_stream(self._stream)
                        if tl is not None:
                            tl.activity_end(name)
                    outs = self._run(resp, ops, ps, tl)
                    event = torch.cuda.Event()
                    event.record(self._stream)
        except Exception as exc:  # noqa: BLE001 — the collective failed:
            # every op of the response fails with it, the thread goes on.
            err = HorovodError(
                f"{rt.name.lower()} of {resp.tensor_names} failed on rank "
                f"{self.rank}: {exc!r}")
            err.__cause__ = exc
            _M_ERRORS.inc(len(ops))
            for name, o in ops.items():
                if tl is not None:
                    tl.end(name)
                o.handle.finish(error=err)
            return
        self.stats["responses"] += 1
        self.stats["tensors"] += len(resp.tensor_names)
        for name, o in ops.items():
            if tl is not None:
                tl.end(name, dtype=str(o.tensor.dtype))
            o.handle.finish(result=outs[name], event=event)
        _M_COMPLETED.inc(len(ops))
        self._trace_spans(resp, ops, mt0)

    @staticmethod
    def _trace_spans(resp: Response, ops: Dict[str, _QueuedOp],
                     mt0: float) -> None:
        """hvd-trace (reference ops/collective.py:1427-1449): the
        negotiate.wait span -- this rank's first submit up to execution
        -- and the dispatch span of the response (pack, launch, unpack;
        the launch span inside it, ops/megakernel.py, carves it into
        legs).  ERROR responses trace too."""
        if not ops or not _trace.enabled():
            return
        t_neg = min((o.t_submit_mono for o in ops.values()
                     if o.t_submit_mono > 0.0), default=0.0)
        if t_neg:
            _trace.span("negotiate.wait", "negotiate", t_neg, mt0,
                        args={"tensors": len(resp.tensor_names)})
        _trace.span(
            f"execute/{resp.response_type.name.lower()}", "dispatch",
            mt0, time.monotonic(),
            args={"tensors": len(resp.tensor_names),
                  "first": resp.tensor_names[0]
                  if resp.tensor_names else ""})

    def _run(self, resp: Response, ops: Dict[str, _QueuedOp], ps, tl=None):
        """Launch one data response; returns {name: result} for the ops
        this rank holds.  Tensors this rank does not hold (it joined, or
        withdrew locally) contribute zeros of the negotiated shape.  With
        a timeline (rank 0) each held tensor's activities are marked."""
        group = self.st.data_group if ps is None else ps.group
        n = self.size if ps is None else ps.size()
        me = self.rank if ps is None else ps.rank()
        dtype = wire.torch_dtype_of(resp.tensor_type)
        dev = self.device
        rt = resp.response_type
        backend = "NCCL" if dev.type == "cuda" else "GLOO"
        if rt == ResponseType.ALLREDUCE and \
                resp.reduce_op != ReduceOp.ADASUM:
            return self._allreduce(resp, ops, ps, tl, backend)
        self.stats["collective_calls"] += 1

        def mark(activity=None):
            """End each held tensor's current activity (if any) and start
            ``activity`` (if any)."""
            if tl is None:
                return
            for name in ops:
                if activity is None:
                    tl.activity_end(name)
                else:
                    tl.activity_start(name, activity)

        def zeros(shape):
            return torch.zeros(tuple(shape), dtype=dtype, device=dev)

        if rt == ResponseType.ALLREDUCE and \
                resp.reduce_op == ReduceOp.ADASUM:
            # Never fused (plan_fusion), so one tensor; no pack.
            (nm,) = resp.tensor_names
            o = ops.get(nm)
            x = o.tensor if o is not None else zeros(resp.tensor_shapes[0])
            mark(f"{backend}_ADASUM")
            out = _adasum(x, group, n, me,
                          None if ps is None else ps.ranks)
            mark()
            return {} if o is None else {nm: _deliver(o, out)}
        (nm,) = resp.tensor_names  # the other kinds are never fused
        shape = tuple(resp.tensor_shapes[0])
        o = ops.get(nm)
        mark(f"{backend}_{_ACTIVITY[rt]}")
        if rt == ResponseType.ALLGATHER:
            sizes = resp.tensor_sizes
            rest, longest = shape[1:], max(sizes)
            x = o.tensor if o is not None else zeros((sizes[me],) + rest)
            if x.shape[0] < longest:
                x = torch.cat([x, zeros((longest - x.shape[0],) + rest)])
            parts = [torch.empty((longest,) + rest, dtype=dtype, device=dev)
                     for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=group)
            out = torch.cat([p[:s] for p, s in zip(parts, sizes)])
        elif rt == ResponseType.BROADCAST:
            root = resp.tensor_sizes[0]
            buf = o.tensor.clone(memory_format=torch.contiguous_format) \
                if o is not None else zeros(shape)
            dist.broadcast(buf, src=root if ps is None else ps.ranks[root],
                           group=group)
            out = buf
        elif rt == ResponseType.ALLTOALL:
            matrix = [resp.tensor_sizes[i * n:(i + 1) * n] for i in range(n)]
            send, recv = matrix[me], [row[me] for row in matrix]
            x = o.tensor if o is not None else zeros((sum(send),)
                                                     + shape[1:])
            out = torch.empty((sum(recv),) + shape[1:], dtype=dtype,
                              device=dev)
            dist.all_to_all_single(out, x.contiguous(),
                                   output_split_sizes=recv,
                                   input_split_sizes=send, group=group)
        else:  # REDUCESCATTER
            x = o.tensor if o is not None else zeros(shape)
            out = torch.empty((shape[0] // n,) + shape[1:], dtype=dtype,
                              device=dev)
            _reduce_scatter(out, x.contiguous(), op=dist.ReduceOp.SUM,
                            group=group)
            if resp.reduce_op == ReduceOp.AVERAGE:
                _megakernel.divide(out, n)
        mark()
        return {} if o is None else {nm: _deliver(o, out)}

    def _allreduce(self, resp: Response, ops: Dict[str, _QueuedOp], ps,
                   tl, backend: str) -> Dict[str, torch.Tensor]:
        """ALLREDUCE other than Adasum: the fused response split into
        buckets by per-tensor wire format, in first-appearance order
        (reference ``_launch_mp_megakernel`` :1013-1054), each packed
        with one ``torch.cat`` and reduced by :func:`.megakernel.launch`.
        A hierarchy (``core/topology.py``) serves the global set.  An
        uncompressed flat bucket marks the MEMCPY_IN_FUSION_BUFFER,
        ``<backend>_ALLREDUCE`` and MEMCPY_OUT_FUSION_BUFFER activities; a
        quantized or hierarchical one, the reference's FUSED_KERNEL (and
        a DCN_ALLREDUCE instant when hierarchical)."""
        psid = resp.process_set_id
        dtype = wire.torch_dtype_of(resp.tensor_type)
        st = self.st
        comm = _megakernel.Comm(
            group=st.data_group if ps is None else ps.group,
            size=self.size if ps is None else ps.size(),
            pos=self.rank if ps is None else ps.rank())
        topo = st.hierarchy if ps is None else None
        if topo is not None:
            comm.node_group, comm.cross_group = st.node_group, st.cross_group
        op = _OP_KERNEL[resp.reduce_op]
        names_all = list(resp.tensor_names)
        shapes = [tuple(int(d) for d in s) for s in resp.tensor_shapes]

        def mark(names, activity=None):
            if tl is None:
                return
            for name in names:
                if activity is None:
                    tl.activity_end(name)
                else:
                    tl.activity_start(name, activity)

        outs = {}
        for fmt, idxs in _partition_by_wire(names_all, shapes, psid,
                                            resp.reduce_op, dtype):
            names = [names_all[i] for i in idxs]
            held = [nm for nm in names if nm in ops]
            spec = _megakernel.GroupSpec(
                process_set_id=psid, size=comm.size, op=op,
                average=resp.reduce_op == ReduceOp.AVERAGE,
                denom=comm.size, dtype=str(dtype).replace("torch.", ""),
                shapes=tuple(shapes[i] for i in idxs),
                hier=_megakernel.hierarchy_for(topo, op, dtype, fmt),
                quant=fmt)
            fused = spec.hier is not None or spec.quant is not None
            mark(held, "FUSED_KERNEL" if fused
                 else "MEMCPY_IN_FUSION_BUFFER")
            flat = torch.cat([
                ops[nm].tensor.reshape(-1) if nm in ops
                else torch.zeros(_numel(shapes[i]), dtype=dtype,
                                 device=self.device)
                for nm, i in zip(names, idxs)])
            if not fused:
                mark(held)
                mark(held, f"{backend}_ALLREDUCE")
            red = _megakernel.launch(spec, flat, comm, names)
            if not fused:
                mark(held)
                mark(held, "MEMCPY_OUT_FUSION_BUFFER")
            off = 0
            for nm, i in zip(names, idxs):
                k = _numel(shapes[i])
                if nm in ops:
                    outs[nm] = _deliver(ops[nm],
                                        red[off:off + k].view(shapes[i]))
                off += k
            mark(held)
            if tl is not None and spec.hier is not None:
                for nm in held:
                    tl.instant(nm, "DCN_ALLREDUCE", args={
                        "slices": topo.n_slices, "ici": topo.ici_size,
                        "wire_dtype": spec.hier.wire_dtype or str(dtype)})
        self.stats["collective_calls"] += comm.calls
        return outs

    # -- waiting (caller threads) -------------------------------------------
    def _cycle_until(self, done: threading.Event, seconds: float) -> bool:
        """Run cycles inline until ``done`` is set, the runtime stops or
        ``seconds`` pass.  With one rank one cycle settles everything
        posted before it; with more, each cycle waits in the exchange
        for the other ranks' cycles."""
        deadline = time.monotonic() + seconds
        while not done.is_set() and not self._stopped.is_set() \
                and time.monotonic() < deadline:
            self.run_cycle()
            if self.channel is None:
                break
        return done.is_set()

    def wait(self, h: Handle) -> None:
        """Until the handle's response has been executed here, running
        the cycles inline (≙ the reference's synchronize, which drains
        itself).  After ``HOROVOD_TPU_SYNC_TIMEOUT`` seconds (default
        300) the op is withdrawn group-wide: rank 0 answers with an ERROR
        response that fails it on every rank (``HOROVOD_TPU_WITHDRAW_GRACE``,
        default 10 s, before it fails here alone)."""
        timeout = float(os.environ.get("HOROVOD_TPU_SYNC_TIMEOUT", "300"))
        if self._cycle_until(h.done, timeout):
            return
        if self._stopped.is_set():
            # The runtime stops before it fails the queued ops (a failed
            # exchange, a SHUTDOWN response): an op it has not reached
            # yet fails here, with the same message.
            if not h.done.is_set():
                h.finish(error=HorovodError(self.shutdown_message))
            return
        if self.channel is None:
            h.finish(error=HorovodError(
                f"Collective {h.name} cannot complete: not all replica "
                f"requests were submitted (it would stall)."))
            return
        with self._lock:
            o = self._ops.get(h.name)
        if o is not None:
            self._post([_tp.encode_withdraw(
                h.name, 0 if o.ps is None else o.ps.process_set_id)])
        if self._cycle_until(h.done, float(os.environ.get(
                "HOROVOD_TPU_WITHDRAW_GRACE", "10"))):
            return
        self._take([h.name])
        h.finish(error=HorovodError(
            f"Collective {h.name} timed out after {timeout:.0f}s waiting "
            f"for the remaining processes (see the coordinator's stall "
            f"warnings for which ranks are missing)."))

    def join(self) -> int:
        if self.peer_shutdown:
            raise HorovodError(self.shutdown_message)
        self.join_result = None
        self._join_done.clear()
        self.joining = True
        self._post([_tp.encode_request(Request(
            self.rank, RequestType.JOIN, wire.DataType.UINT8, "hvd.join"))])
        timeout = float(os.environ.get("HOROVOD_TPU_JOIN_TIMEOUT", "600"))
        try:
            self._cycle_until(self._join_done, timeout)
        finally:
            self.joining = False
        if self.peer_shutdown:
            raise HorovodError(self.shutdown_message)
        if self.join_result is None:
            raise HorovodError(
                f"hvd.join() timed out after {timeout:.0f}s waiting for the "
                f"remaining processes to join (HOROVOD_TPU_JOIN_TIMEOUT).")
        return self.join_result


def _runtime() -> Runtime:
    _state._check_initialized()
    return _state._state.runtime


def stats() -> Dict[str, int]:
    """Counts of this ``init`` (see :meth:`Runtime._zero_stats`)."""
    return dict(_runtime().stats)


def reset_stats() -> None:
    rt = _runtime()
    rt.stats = rt._zero_stats()


# ---------------------------------------------------------------------------
# Enqueue
# ---------------------------------------------------------------------------

def _resolve_op(average, op) -> ReduceOp:
    """``op`` and ``average`` are mutually exclusive; neither means
    Average (the reference's default)."""
    if op is not None:
        if average is not None:
            raise ValueError("specify either average= or op=, not both "
                             "(they are mutually exclusive).")
        return ReduceOp(op)
    if average is None or average:
        return ReduceOp.AVERAGE
    return ReduceOp.SUM


def _check_process_set(process_set):
    """None for the global set; raises for a set this rank may not use."""
    if process_set is None or process_set.process_set_id == 0:
        return None
    if _ps.get(process_set.process_set_id) is None:
        raise HorovodError(
            f"process set {process_set.process_set_id} is not registered "
            f"(was it removed, or created before a re-init?).")
    if not process_set.included():
        raise HorovodError(
            f"rank {_state.rank()} is not a member of process set "
            f"{process_set.process_set_id} (ranks "
            f"{list(process_set.ranks)}) and cannot submit collectives "
            f"into it (the post-v0.13 process-set contract).")
    return process_set


def _check_reduce_op(red_op: ReduceOp, dtype, process_set=None) -> None:
    """Adasum's preconditions, with the reference's messages
    (:2337-2353)."""
    if red_op != ReduceOp.ADASUM:
        return
    n = _state.size() if process_set is None else process_set.size()
    if n & (n - 1) != 0:
        raise ValueError(
            f"op=Adasum requires a power-of-two contributor count for "
            f"its recursive-doubling ppermute ladder; got {n}.")
    if not (dtype.is_floating_point or dtype.is_complex):
        raise ValueError(
            f"op=Adasum is defined on floating-point gradients; got "
            f"dtype {str(dtype).replace('torch.', '')}.")
    if _runtime().joining:
        raise HorovodError(
            "op=Adasum cannot run while this rank has joined: a zero "
            "contribution is only an identity for sum/average.")


def _spec(tensor, op: RequestType, name: Optional[str], prefix: str,
          process_set=None, red_op: ReduceOp = ReduceOp.SUM,
          root_rank: int = -1, splits=(), out=None) -> dict:
    rt = _runtime()
    ps = _check_process_set(process_set)
    tensor = torch.as_tensor(tensor)
    if op == RequestType.ALLREDUCE:
        _check_reduce_op(red_op, tensor.dtype, ps)
    return dict(tensor=tensor, op=op, red_op=red_op,
                name=name or rt.auto_name(prefix, ps), ps=ps,
                root_rank=root_rank, splits=splits, out=out)


def _enqueue(specs: List[dict]) -> List[int]:
    """Every collective funnels through here: each op's signature is
    recorded first (``analysis/program.py``, reference :2395-2404), so
    ``verify_program`` can prove cross-rank agreement ahead of the data
    plane."""
    if _program.recording_enabled():
        for sp in specs:
            op, ps = sp["op"], sp["ps"]
            _program.record_collective(
                op.name.lower(), sp["name"],
                wire.dtype_name(wire.dtype_of(sp["tensor"].dtype)),
                tuple(sp["tensor"].shape),
                reduce_op=(wire.reduce_op_name(sp["red_op"])
                           if op in (RequestType.ALLREDUCE,
                                     RequestType.REDUCESCATTER) else ""),
                process_set_id=0 if ps is None else ps.process_set_id)
    return _runtime().enqueue(specs)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def allreduce_async(tensor, average=None, name: Optional[str] = None,
                    op=None, process_set=None, out=None) -> int:
    """Queue an allreduce; returns a handle for poll/synchronize.
    Averages by default; ``op`` takes hvd.Average/Sum/Min/Max/Product and
    is mutually exclusive with ``average``; ``process_set`` restricts the
    collective to a rank subset; ``out`` (same shape) receives the result
    in place, cast to its dtype."""
    return _enqueue([_spec(tensor, RequestType.ALLREDUCE, name, "allreduce",
                           process_set, _resolve_op(average, op), out=out)])[0]


def allreduce(tensor, average=None, name: Optional[str] = None, op=None,
              process_set=None):
    """Synchronous allreduce -- see :func:`allreduce_async`.
    :class:`~.sparse.IndexedSlices` inputs take the sparse path, a
    negotiated allgather of values and indices (≙ the reference's
    :2885-2901, tensorflow/__init__.py:67-78)."""
    from . import sparse as _sparse

    if isinstance(tensor, _sparse.IndexedSlices):
        red = _resolve_op(average, op)
        if red not in (ReduceOp.AVERAGE, ReduceOp.SUM):
            raise ValueError(
                f"sparse (IndexedSlices) allreduce supports only "
                f"sum/average — it is a gather of (values, indices), "
                f"reference tensorflow/__init__.py:67-78; got op="
                f"{wire.reduce_op_name(red)}.")
        return _sparse.allreduce(tensor, average=red == ReduceOp.AVERAGE,
                                 name=name, process_set=process_set)
    return synchronize(allreduce_async(tensor, average, name, op,
                                       process_set))


def grouped_allreduce_async(tensors, average=None,
                            name: Optional[str] = None, op=None,
                            process_set=None, outs=None) -> List[int]:
    """Queue a group of allreduces in one cycle's batch: they negotiate
    together and fuse under the threshold.  One handle per tensor; the
    default base name is unique per call."""
    red = _resolve_op(average, op)
    base = name or _runtime().auto_name("grouped.allreduce", process_set)
    outs = outs or [None] * len(tensors)
    return _enqueue([_spec(t, RequestType.ALLREDUCE, f"{base}.{i}",
                           "allreduce", process_set, red, out=o)
                     for i, (t, o) in enumerate(zip(tensors, outs))])


def grouped_allreduce(tensors, average=None, name: Optional[str] = None,
                      op=None, process_set=None) -> List:
    """Synchronous grouped allreduce, input order preserved."""
    return [synchronize(h) for h in grouped_allreduce_async(
        tensors, average, name, op, process_set)]


def allgather_async(tensor, name: Optional[str] = None,
                    process_set=None) -> int:
    """Queue an allgather along dim 0, in rank order; ranks may send
    different dim-0 sizes (the negotiated ``tensor_sizes``)."""
    return _enqueue([_spec(tensor, RequestType.ALLGATHER, name, "allgather",
                           process_set)])[0]


def allgather(tensor, name: Optional[str] = None, process_set=None):
    """Synchronous allgather along dim 0, rank order."""
    return synchronize(allgather_async(tensor, name, process_set))


def grouped_allgather_async(tensors, name: Optional[str] = None,
                            process_set=None) -> List[int]:
    base = name or _runtime().auto_name("grouped.allgather", process_set)
    return _enqueue([_spec(t, RequestType.ALLGATHER, f"{base}.{i}",
                           "allgather", process_set)
                     for i, t in enumerate(tensors)])


def grouped_allgather(tensors, name: Optional[str] = None,
                      process_set=None) -> List:
    return [synchronize(h)
            for h in grouped_allgather_async(tensors, name, process_set)]


def broadcast_async(tensor, root_rank: int, name: Optional[str] = None,
                    process_set=None, out=None) -> int:
    """Queue a broadcast of ``root_rank``'s tensor (a GLOBAL rank, also
    for a process set)."""
    if process_set is not None and process_set.process_set_id != 0:
        root = process_set.local_rank_of(root_rank)
    else:
        size = _state.size()
        if not 0 <= root_rank < size:
            raise ValueError(f"root_rank {root_rank} outside [0, {size}).")
        root = root_rank
    return _enqueue([_spec(tensor, RequestType.BROADCAST, name, "broadcast",
                           process_set, root_rank=root, out=out)])[0]


def broadcast(tensor, root_rank: int, name: Optional[str] = None,
              process_set=None):
    """Synchronous broadcast from ``root_rank``."""
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def _set_size(process_set) -> int:
    if process_set is None or process_set.process_set_id == 0:
        return _state.size()
    return process_set.size()


def alltoall_async(tensor, splits=None, name: Optional[str] = None,
                   process_set=None) -> int:
    """Queue an alltoall: this rank's dim-0 rows go to each rank by
    ``splits`` (one count per destination; None = even split); the rows
    received from every rank concatenate in rank order."""
    if isinstance(tensor, (list, tuple)):
        raise ValueError("alltoall takes one tensor per rank, not a list.")
    tensor = torch.as_tensor(tensor)
    n = _set_size(process_set)
    shape = tuple(tensor.shape)
    if not shape:
        raise ValueError("An alltoall tensor needs at least one dimension.")
    if splits is None:
        if shape[0] % n != 0:
            raise ValueError(
                f"alltoall without splits needs dim 0 divisible by the "
                f"rank count ({n}); got shape {list(shape)}.")
        splits = ()
    else:
        splits = tuple(int(s) for s in splits)
        if len(splits) != n or any(s < 0 for s in splits) or \
                sum(splits) != shape[0]:
            raise ValueError(
                f"alltoall splits {list(splits)} must have one "
                f"non-negative entry per rank ({n}) summing to dim 0 "
                f"({shape[0]}).")
    return _enqueue([_spec(tensor, RequestType.ALLTOALL, name, "alltoall",
                           process_set, splits=splits)])[0]


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set=None):
    """Synchronous alltoall -- see :func:`alltoall_async`."""
    return synchronize(alltoall_async(tensor, splits, name, process_set))


def _reducescatter_spec(tensor, average, name, op, process_set) -> dict:
    red = _resolve_op(average, op)
    if red not in (ReduceOp.SUM, ReduceOp.AVERAGE):
        raise ValueError(
            f"reducescatter supports op=Average/Sum (Horovod's contract "
            f"for this collective); got {wire.reduce_op_name(red)}.")
    if isinstance(tensor, (list, tuple)):
        raise ValueError(
            "reducescatter takes one tensor (identical shape on every "
            "rank), not a list.")
    tensor = torch.as_tensor(tensor)
    n = _set_size(process_set)
    shape = tuple(tensor.shape)
    if not shape or shape[0] % n != 0 or shape[0] == 0:
        raise ValueError(
            f"reducescatter needs dim 0 divisible by the rank count "
            f"({n}); got shape {list(shape)}.")
    return _spec(tensor, RequestType.REDUCESCATTER, name, "reducescatter",
                 process_set, red)


def reducescatter_async(tensor, average=None, name: Optional[str] = None,
                        op=None, process_set=None) -> int:
    """Queue a reducescatter: reduce across ranks, split dim 0 -- this
    rank receives its chunk (op in {Average, Sum})."""
    return _enqueue([_reducescatter_spec(tensor, average, name, op,
                                         process_set)])[0]


def reducescatter(tensor, average=None, name: Optional[str] = None,
                  op=None, process_set=None):
    return synchronize(reducescatter_async(tensor, average, name, op,
                                           process_set))


def grouped_reducescatter_async(tensors, average=None,
                                name: Optional[str] = None, op=None,
                                process_set=None) -> List[int]:
    base = name or _runtime().auto_name("grouped.reducescatter",
                                        process_set)
    return _enqueue([_reducescatter_spec(t, average, f"{base}.{i}", op,
                                         process_set)
                     for i, t in enumerate(tensors)])


def grouped_reducescatter(tensors, average=None, name: Optional[str] = None,
                          op=None, process_set=None) -> List:
    return [synchronize(h) for h in grouped_reducescatter_async(
        tensors, average, name, op, process_set)]


def barrier(process_set=None) -> None:
    """Block until every rank reaches the barrier: one tiny named
    allreduce through negotiation, so it also surfaces peer failures and
    stalls like any other collective."""
    synchronize(allreduce_async(
        torch.zeros(1), average=False,
        name=_runtime().auto_name("barrier", process_set),
        process_set=process_set))


def join() -> int:
    """Barrier for uneven workloads: a rank out of data calls ``join()``
    and, until every rank has, contributes zeros to the others'
    collectives (allreduce adds zeros and still divides by the full size;
    allgather contributes 0 rows).  Returns the rank that joined last."""
    return _runtime().join()


def add_process_set(ranks):
    """Register a process set of GLOBAL ranks.  Collective: every rank
    calls it with the same ranks, in the same order; a registration that
    differs raises on every rank.  Returns the set for ``process_set=``."""
    from .objects import allgather_object

    rt = _runtime()
    st = _state._state
    ranks = tuple(sorted({int(r) for r in ranks}))
    if not ranks:
        raise ValueError("a process set needs at least one rank")
    bad = [r for r in ranks if not 0 <= r < st.size]
    if bad:
        raise ValueError(f"process-set ranks {bad} outside [0, {st.size}).")
    with st.lock:
        psid = st.next_process_set_id
        st.next_process_set_id = psid + 1
    if st.size > 1:
        regs = allgather_object((psid, ranks),
                                name=f"process_set.register.{psid}")
        if any(reg != (psid, ranks) for reg in regs):
            raise HorovodError(
                f"add_process_set must be called by every process with "
                f"identical ranks in the same order; this process "
                f"registered set {psid} as {list(ranks)} but the job "
                f"registered {regs}.")
    ps = _ps.ProcessSet(psid, ranks, dist.new_group(
        list(ranks), backend="nccl" if rt.device.type == "cuda" else "gloo"))
    if rt.coordinator is not None:
        # The set shares the one cache replica (entry indices span every
        # set) and counts hits in global ranks.
        ps.coordinator = Coordinator(
            ps.size(), st.fusion_threshold_bytes, timeline=rt.timeline,
            cache=rt.cache, ranks=ranks)
    with st.lock:
        st.process_sets[psid] = ps
    _flush_for_membership(rt, f"add_process_set({psid})")
    return ps


def _flush_for_membership(rt: Runtime, reason: str) -> None:
    """With more than one rank every replica flushes on the
    registration allgather (a rule of the response stream); one rank
    has no such allgather and flushes here."""
    if rt.cache is not None and rt.channel is None:
        rt._resubmit_orphans(rt.cache.flush(reason))


def remove_process_set(process_set) -> bool:
    """Deregister a process set (collective, like registration); False
    when it was already removed.  The global set cannot be removed."""
    from .objects import allgather_object

    _runtime()
    st = _state._state
    psid = process_set.process_set_id
    if psid == 0:
        raise ValueError("the global process set cannot be removed")
    if _ps.get(psid) is None:
        return False
    if st.size > 1:
        regs = allgather_object(psid, name=f"process_set.remove.{psid}")
        if any(r != psid for r in regs):
            raise HorovodError(
                f"remove_process_set must be called by every process for "
                f"the same set; this process removed {psid} but the job "
                f"removed {regs}.")
    with st.lock:
        ps = st.process_sets.pop(psid)
    ps.close()
    dist.destroy_process_group(ps.group)
    _flush_for_membership(_runtime(), f"remove_process_set({psid})")
    return True


def global_process_set():
    """The world as a :class:`ProcessSet` (id 0); passing it or None to a
    collective's ``process_set=`` is the same."""
    _state._check_initialized()
    return _ps.ProcessSet(0, tuple(range(_state.size())),
                          _state._state.data_group)


def set_fusion_threshold(nbytes: int) -> None:
    """Set the Tensor Fusion threshold, in bytes, between steps (the
    reference's autotune hook, tuning/actuation.py:169).  Every rank calls
    it with the same value: the bucket plans of the monolithic and the
    overlapped steps use this rank's, rank 0's coordinators fuse with
    theirs (which drops the cache's packing plans and the quantized
    residuals and ticks)."""
    rt = _runtime()
    _state._state.fusion_threshold_bytes = int(nbytes)
    if rt.coordinator is not None:
        with rt.cycle_lock:
            for coord in rt._coordinators():
                coord.set_fusion_threshold(int(nbytes))
    else:  # the coordinators flush rank 0's; the buckets change everywhere
        _megakernel.flush(f"fusion threshold -> {int(nbytes)}")


@contextlib.contextmanager
def quiesce():
    """Hold the cycle across a group of ``*_async`` submissions, so no
    cycle sends part of it, then run one cycle.  The body must only
    submit: waiting on a handle inside it deadlocks."""
    rt = _runtime()
    with rt.cycle_lock:
        yield
    rt.run_cycle()


def poll(handle: int) -> bool:
    """True once the collective behind ``handle`` has completed (its
    response executed, and on a GPU its kernels run)."""
    return _runtime().handles.get(handle).completed()


def synchronize(handle: int):
    """Wait for the collective behind ``handle`` and return its output on
    the input's device (an in-place op returns its target).  Raises
    :class:`HorovodError` if it failed."""
    rt = _runtime()
    h = rt.handles.get(handle)
    if not h.done.is_set():
        rt.wait(h)
    rt.handles.release(handle)
    if h.error is not None:
        raise h.error
    result = h.result
    if h.event is not None:
        stream = torch.cuda.current_stream(rt.device)
        stream.wait_event(h.event)
        if result.is_cuda:
            result.record_stream(stream)
    return result if result.device == h.home else result.to(h.home)
