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

* ALLREDUCE (Sum, Average, Min, Max, Product), fused: one ``torch.cat``
  pack, one collective, Average's divide once on the flat buffer (floor
  for integers), then a view or copy out per tensor -- 1 pack + 1
  collective (+ 1 divide) launches, plus one copy per in-place tensor;
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

Adasum raises ``NotImplementedError`` (ROADMAP.md A.6).  The response
cache, the timeline and the reference's telemetry are later work.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core import state as _state
from . import process_set as _ps
from . import transport as _tp
from . import wire
from .coordinator import PyCoordinator, stall_warning_seconds
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

_DIST_OP = {ReduceOp.SUM: dist.ReduceOp.SUM,
            ReduceOp.AVERAGE: dist.ReduceOp.SUM,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT}

# torch 2.13 renamed reduce_scatter_tensor; older releases have only it.
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)

_DATA_RESPONSES = (ResponseType.ALLREDUCE, ResponseType.ALLGATHER,
                   ResponseType.BROADCAST, ResponseType.REDUCESCATTER,
                   ResponseType.ALLTOALL)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _divide(x: torch.Tensor, denom: int) -> torch.Tensor:
    """Average's division, in place; integer dtypes divide with floor,
    as the reference does (:766)."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return x.div_(denom)
    return x.floor_divide_(denom)


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


class Runtime:
    """The negotiated collectives of one ``init``: op queue, outbox,
    handles, rank 0's coordinator and the background thread."""

    def __init__(self, st) -> None:
        self.st = st
        self.rank, self.size = st.rank, st.size
        self.device = st.device
        self.handles = HandleManager()
        self._lock = threading.Lock()
        self._ops: Dict[str, _QueuedOp] = {}  # guarded by _lock
        self._outbox: List[bytes] = []  # guarded by _lock
        self._names: Dict[str, int] = {}  # guarded by _lock
        # Held for a whole cycle; quiesce() holds it across submissions.
        self.cycle_lock = threading.Lock()
        self._work = threading.Event()  # posted since the last cycle
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.channel = (_tp.ControlChannel(st.control_group, st.rank,
                                           st.size)
                        if st.size > 1 else None)
        self.coordinator = (PyCoordinator(st.size,
                                          st.fusion_threshold_bytes)
                            if st.rank == 0 else None)
        self._unrouted: List[Request] = []  # rank 0: sets not yet known
        self._last_stall_check = time.monotonic()
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        self.peer_shutdown = False
        self.shutdown_message = SHUT_DOWN_ERROR_MESSAGE
        self.join_result: Optional[int] = None
        self._join_done = threading.Event()
        self.stats = self._zero_stats()

    @staticmethod
    def _zero_stats() -> Dict[str, int]:
        """tensors: tensors executed in data responses; responses: data
        responses executed; collective_calls: torch.distributed calls on
        the data groups."""
        return {"tensors": 0, "responses": 0, "collective_calls": 0}

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
            self._stopped.set()
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
        ops, msgs = [], []
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
            ops.append(_QueuedOp(
                name=spec["name"], op=spec["op"], tensor=x,
                red_op=spec["red_op"], handle=h,
                nbytes=max(_numel(x.shape), 1) * wire.dtype_size(dt),
                ps=ps, out=out, ready=ready))
            msgs.append(_tp.encode_request(Request(
                request_rank=self.rank if ps is None else ps.rank(),
                request_type=spec["op"], tensor_type=dt,
                tensor_name=spec["name"], root_rank=spec["root_rank"],
                device=(home.index if home.type == "cuda"
                        else wire.CPU_DEVICE_ID),
                tensor_shape=tuple(x.shape), reduce_op=spec["red_op"],
                process_set_id=0 if ps is None else ps.process_set_id,
                splits=tuple(spec["splits"]))))
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
        self._work.set()
        return [o.handle.id for o in ops]

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

    # -- one cycle (background thread) -------------------------------------
    def _cycle(self) -> None:
        with self.cycle_lock:
            if self._stopped.is_set():
                return
            self._work.clear()
            with self._lock:
                batch, self._outbox = b"".join(self._outbox), []
            if self.channel is None:
                batches = [batch]
            else:
                batches = self.channel.gather(batch)
            responses: List[Response] = []
            if self.rank == 0:
                responses = self._negotiate(batches)
            if self.channel is not None:
                payload = (wire.pack_response_list(responses)
                           if self.rank == 0 and responses else b"")
                payload = self.channel.broadcast(payload)
                if self.rank != 0:
                    responses = (wire.unpack_response_list(payload)
                                 if payload else [])
            for resp in responses:
                if self._stopped.is_set():
                    break
                self._execute(resp)

    def _coordinator_for(self, psid: int):
        if psid == 0:
            return self.coordinator
        ps = _ps.get(psid)
        return None if ps is None else ps.coordinator

    def _negotiate(self, batches: List[bytes]) -> List[Response]:
        """Rank 0: submit every rank's batch, poll every coordinator
        (the global set first, then the sets by id), watch for stalls."""
        errors: List[Response] = []
        shutdown = False
        pending, self._unrouted = self._unrouted, []
        withdrawals = []
        for r, b in enumerate(batches):
            for kind, body in _tp.decode_batch(b):
                if kind == _tp.KIND_REQUEST:
                    pending.append(body)
                elif kind == _tp.KIND_WITHDRAW:
                    withdrawals.append((r, body))
                else:
                    shutdown = True
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
        with self._lock:
            meta = {n: o.nbytes for n, o in self._ops.items()}
        coords = [self.coordinator] + [
            ps.coordinator for _, ps in sorted(_state.process_sets().items())
            if ps.coordinator is not None]
        responses = errors
        for coord in coords:
            responses += coord.poll_responses(meta)
        now = time.monotonic()
        stall_s = stall_warning_seconds()
        if now - self._last_stall_check > stall_s:
            self._last_stall_check = now
            for coord in coords:
                for w in coord.check_stalled(now, stall_s):
                    print(f"WARNING: {w}", file=sys.stderr, flush=True)
        if shutdown:
            responses.append(Response(ResponseType.SHUTDOWN,
                                      error_message=SHUT_DOWN_ERROR_MESSAGE))
        return responses

    # -- execution (background thread, response order) ---------------------
    def _execute(self, resp: Response) -> None:
        rt = resp.response_type
        if rt == ResponseType.ERROR:
            err = HorovodError(resp.error_message)
            for o in self._take(resp.tensor_names).values():
                o.handle.finish(error=err)
            return
        if rt == ResponseType.JOIN:
            self.join_result = resp.tensor_sizes[0] if resp.tensor_sizes \
                else -1
            self._join_done.set()
            return
        if rt == ResponseType.SHUTDOWN:
            self.peer_shutdown = True
            self.shutdown_message = resp.error_message \
                or SHUT_DOWN_ERROR_MESSAGE
            self._stopped.set()
            self._poison(self.shutdown_message)
            return
        if rt not in _DATA_RESPONSES:
            return
        ps = _ps.get(resp.process_set_id) if resp.process_set_id else None
        if resp.process_set_id and (ps is None or not ps.included()):
            return  # not a member: the set's members run it
        ops = self._take(resp.tensor_names)
        try:
            if self._stream is None:
                outs = self._run(resp, ops, ps)
                event = None
            else:
                with torch.cuda.stream(self._stream):
                    for o in ops.values():
                        self._stream.wait_event(o.ready)
                        o.tensor.record_stream(self._stream)
                        if o.out is not None and o.out.is_cuda:
                            o.out.record_stream(self._stream)
                    outs = self._run(resp, ops, ps)
                    event = torch.cuda.Event()
                    event.record(self._stream)
        except Exception as exc:  # noqa: BLE001 — the collective failed:
            # every op of the response fails with it, the thread goes on.
            err = HorovodError(
                f"{rt.name.lower()} of {resp.tensor_names} failed on rank "
                f"{self.rank}: {exc!r}")
            err.__cause__ = exc
            for o in ops.values():
                o.handle.finish(error=err)
            return
        self.stats["responses"] += 1
        self.stats["tensors"] += len(resp.tensor_names)
        for name, o in ops.items():
            o.handle.finish(result=outs[name], event=event)

    def _run(self, resp: Response, ops: Dict[str, _QueuedOp], ps):
        """Launch one data response; returns {name: result} for the ops
        this rank holds.  Tensors this rank does not hold (it joined, or
        withdrew locally) contribute zeros of the negotiated shape."""
        group = self.st.data_group if ps is None else ps.group
        n = self.size if ps is None else ps.size()
        me = self.rank if ps is None else ps.rank()
        dtype = wire.torch_dtype_of(resp.tensor_type)
        dev = self.device
        rt = resp.response_type
        self.stats["collective_calls"] += 1

        def zeros(shape):
            return torch.zeros(tuple(shape), dtype=dtype, device=dev)

        def deliver(o, value):
            if o.out is None:
                return value
            o.out.copy_(value.view(o.out.shape))
            return o.out

        if rt == ResponseType.ALLREDUCE:
            parts = [ops[nm].tensor.reshape(-1) if nm in ops
                     else zeros((_numel(s),))
                     for nm, s in zip(resp.tensor_names, resp.tensor_shapes)]
            flat = torch.cat(parts)
            dist.all_reduce(flat, op=_DIST_OP[resp.reduce_op], group=group)
            if resp.reduce_op == ReduceOp.AVERAGE:
                _divide(flat, n)
            outs, off = {}, 0
            for nm, s in zip(resp.tensor_names, resp.tensor_shapes):
                k = _numel(s)
                if nm in ops:
                    outs[nm] = deliver(ops[nm], flat[off:off + k].view(s))
                off += k
            return outs
        (nm,) = resp.tensor_names  # the other kinds are never fused
        shape = tuple(resp.tensor_shapes[0])
        o = ops.get(nm)
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
                _divide(out, n)
        return {} if o is None else {nm: deliver(o, out)}

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
        if self._cycle_until(h.done, timeout) or self._stopped.is_set():
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
        self._post([_tp.encode_request(Request(
            self.rank, RequestType.JOIN, wire.DataType.UINT8, "hvd.join"))])
        timeout = float(os.environ.get("HOROVOD_TPU_JOIN_TIMEOUT", "600"))
        self._cycle_until(self._join_done, timeout)
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


def _spec(tensor, op: RequestType, name: Optional[str], prefix: str,
          process_set=None, red_op: ReduceOp = ReduceOp.SUM,
          root_rank: int = -1, splits=(), out=None) -> dict:
    rt = _runtime()
    ps = _check_process_set(process_set)
    if op == RequestType.ALLREDUCE and red_op == ReduceOp.ADASUM:
        raise NotImplementedError(
            "op=Adasum is not in this slice of the port (ROADMAP.md A.6)")
    return dict(tensor=torch.as_tensor(tensor), op=op, red_op=red_op,
                name=name or rt.auto_name(prefix, ps), ps=ps,
                root_rank=root_rank, splits=splits, out=out)


def _enqueue(specs: List[dict]) -> List[int]:
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
    """Synchronous allreduce -- see :func:`allreduce_async`."""
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
        ps.coordinator = PyCoordinator(ps.size(), st.fusion_threshold_bytes)
    st.process_sets[psid] = ps
    return ps


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
    ps = st.process_sets.pop(psid)
    ps.close()
    dist.destroy_process_group(ps.group)
    return True


def global_process_set():
    """The world as a :class:`ProcessSet` (id 0); passing it or None to a
    collective's ``process_set=`` is the same."""
    _state._check_initialized()
    return _ps.ProcessSet(0, tuple(range(_state.size())),
                          _state._state.data_group)


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
