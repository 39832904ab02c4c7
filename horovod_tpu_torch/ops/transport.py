"""The control channel of the negotiated collectives: the reference's TCP
control plane (horovod_tpu/ops/transport.py:570-2071, itself v0.13's
background loop, operations.cc:1226-1374: MPI_Gather of the requests,
MPI_Bcast of the responses), with its session resume, frame deadlines
and chaos sites, carrying the port's lockstep cycle.

Rank 0 runs a :class:`ControllerTransport` (one TCP connection a worker,
or a direct child under the tree overlay, :mod:`.tree`); every other rank
a :class:`WorkerTransport` (or :class:`.tree.TreeWorkerTransport`).  The
runtime (:mod:`.collective`) talks to either through two calls a cycle,
in lockstep:

1. ``gather(batch)``: every worker sends its cycle's batch to rank 0,
   which waits for one from every rank (rank order, its own first);
2. ``broadcast(payload)``: rank 0 sends the cycle's payload to every
   worker, which waits for it.

A rank runs one cycle at a time (the background thread, or a caller
waiting in ``synchronize``, under the runtime's cycle lock), and
everything the ranks must agree on (requests, withdrawals, shutdown,
join) travels in the batches and the payload.  With one rank there is
no channel.

Frames (reference :75-197): ``<u32 length><u8 type><payload>``,
little-endian, with the reference's type numbers (:func:`frame_name`).
The handshake and session frames keep the reference's payloads byte for
byte: ``FRAME_HELLO`` (``<i rank><H len><host><H len><env
fingerprint>``), ``FRAME_TOPO`` (``<iiiii>`` local rank and size, cross
rank and size, rank 0's response-cache flag), ``FRAME_SHUTDOWN``
(empty), ``FRAME_RECONNECT`` (``<i rank><I frames received><i cache
epoch><B has cache>``), ``FRAME_RESUME`` (``<I frames received><B
verdict><H len><reason>``; verdict 0 reject, 1 resume with the cache, 2
resume cache-less), ``FRAME_WITHDRAW`` (``<i rank><H len><name><H
process set>``), and the tree's ``FRAME_HELLO_TREE``, ``FRAME_TOPO_TREE``
and ``FRAME_CHILD_LOST``.  The cycle rides three frames of its own:

* ``FRAME_REQUEST_BATCH`` (8), worker to parent: ``<i rank><Q seq>`` and
  the batch below; ``seq`` counts the rank's batches from 1, and rank 0
  drops one it has already taken (a duplicated frame is idempotent);
* ``FRAME_RESPONSES`` (2), rank 0 to workers: ``<Q seq>`` and the
  payload below; a worker drops a payload it has already taken;
* ``FRAME_SUBTREE_BATCH`` (18), an interior to its parent: ``<H n>`` and
  ``n`` sections (:mod:`.tree`, reference tree.py:340-353), the hit
  sections first.  A hit section is the reference's bits section, ``<B
  0><I epoch><H nranks><i*nranks><H nidx><I*nidx>``: every rank it lists
  (two or more) sent a ``KIND_HITS`` record of those entry indices, in
  that order, at that epoch.  A batch section, ``<B 4><i rank><Q seq><I
  cum><B nref><I len>`` and the rank's batch, carries one rank's
  ``FRAME_REQUEST_BATCH`` payload with each of its ``nref`` grouped
  ``KIND_HITS`` records replaced by a ``KIND_HITS_REF`` message, ``<H
  index of its hit section>`` (a record no other rank shares stays in
  place); ``cum`` counts the upward frames of that rank folded in so far
  (the re-parent resume's count; 0 for the sender's own).  Rank 0
  expands the sections back into the payloads the ranks sent, byte for
  byte.

A withdrawal or an exit handshake that cannot wait for the cycle goes
at once as ``FRAME_WITHDRAW`` or ``FRAME_SHUTDOWN``; rank 0 takes it in
place of the rank's batch it still awaits (a withdrawal ends a cycle
whose batch was lost on the wire).  The metrics and trace pulls, the
program signatures and the clock probes ride the cycle (below), so the
reference's ``FRAME_PING``/``PONG``, ``METRICS``, ``TRACE``,
``SIGNATURE``/``SIGRESULT`` and their tree envelopes are never sent.

Session resume (reference :255-273, on by default): every frame after
the handshake is counted and kept in a bounded replay ring each way; a
worker whose connection drops reconnects with capped, jittered backoff
(``BackoffPolicy(base=0.05, cap=2.0)``) and the two sides exchange their
received counts, replaying exactly the frames the other missed.  A
worker whose cache-replica epoch is not the one rank 0 recorded at the
disconnect resumes cache-less, and rank 0 flushes its cache.  Rank 0
holds a disconnected rank for ``HVD_TPU_RECONNECT_GRACE`` seconds
(default 10): only an expired window or a gap the ring no longer holds
makes it a dead peer.  Knobs: ``HVD_TPU_RECONNECT`` (1; 0 makes a lost
connection terminal), ``HVD_TPU_RECONNECT_GRACE`` (10 s),
``HVD_TPU_RECONNECT_DEADLINE`` (10 s, the worker's), ``HVD_TPU_RECONNECT_RING``
(1024 frames), ``HVD_TPU_FRAME_TIMEOUT`` (30 s: a peer that stalls midway
through a frame is named, with the frame type, instead of hanging;
0 disables), ``HVD_TPU_CONNECT_TIMEOUT`` (120 s for every rank to
connect).  Chaos (``HVD_TPU_FAULTS``) hooks the send path:
``transport.drop``, ``.dup``, ``.delay``, ``.trunc``, ``.reset`` and
``.stall``.

A batch is a sequence of messages, each a one-byte kind and a body:
``KIND_REQUEST`` + :meth:`wire.Request.pack`; ``KIND_WITHDRAW`` +
``<HH`` (process set, name length) + name; ``KIND_SHUTDOWN``;
``KIND_HITS`` + ``<II`` (cache epoch, count) + ``count`` × ``<I``
response-cache entry indices: the requests of this rank that hit its
cache replica (:mod:`.cache`), in place of the reference's
``FRAME_REQUEST_BATCH`` bit-vectors (horovod_tpu/ops/transport.py:
101-110,163); ``KIND_METRICS`` + ``<I`` length + this rank's metrics
snapshot as JSON, its answer to rank 0's pull (the reference's
``FRAME_METRICS``); ``KIND_SIGNATURE`` + ``<I`` length + this rank's
packed collective-program signature (``analysis/program.py``
``pack_program``; the reference's ``FRAME_SIGNATURE``); ``KIND_TRACE`` +
``<I`` length + this rank's span buffer as JSON, its answer to rank 0's
trace pull (the reference's ``FRAME_TRACE``); ``KIND_PONG`` + ``<ddd``
(rank 0's probe stamp, this rank's receipt and send stamps, the
reference's ``FRAME_PONG``); ``KIND_TRACE_CTX`` + the 16-byte trace
context (``trace.CTX_STRUCT``) + ``<d`` the monotonic stamp of this
rank's first post of the batch (the reference's request-batch trailer).
:func:`iter_messages` is the one reader of these lengths.

Rank 0's broadcast is one kind byte and a body: ``PAYLOAD_RESPONSES`` +
:func:`wire.pack_response_list`, or, for a cycle that is all cache
replay, ``PAYLOAD_REPLAY`` + ``<II`` (epoch, groups) + per fused
response ``<I`` count + that many ``<I`` entry indices, which the
workers rebuild from their replica.  A broadcast that asks the workers
for their metrics snapshots (``telemetry.cluster_metrics``) is
``PAYLOAD_PULL_METRICS`` followed by the cycle's payload, if any.  The
other prefixes rank 0 may put in front, each once, in any order:
``PAYLOAD_SIGNATURE`` + ``<BI`` (1 for a divergence, length) + the
verdict text (``verify_program``'s answer); ``PAYLOAD_PULL_TRACE`` (a
trace pull); ``PAYLOAD_PING`` + ``<d`` rank 0's send stamp (a clock
probe, the reference's ``FRAME_PING``; a probe replayed after a resume
answers with a huge round trip, which the min-RTT filter throws away);
``PAYLOAD_CTX`` + the 16-byte trace context of the cycle (the
reference's broadcast trailer).
"""

from __future__ import annotations

import atexit
import collections
import itertools
import json
import os
import queue
import socket
import struct
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import wire
from .. import chaos as _chaos
from .. import telemetry as _telemetry
from ..analysis import lockorder as _lockorder
from ..analysis import races as _races
from ..analysis import threads as _athreads
from ..telemetry import flight as _flight
from ..trace import clock as _trace_clock
from ..utils.retry import BackoffPolicy
from .wire import DEAD_PEER_MARKER, Request, Response, ResponseType

KIND_REQUEST, KIND_WITHDRAW, KIND_SHUTDOWN, KIND_HITS = 0, 1, 2, 3
KIND_METRICS = 4
KIND_SIGNATURE, KIND_TRACE, KIND_PONG, KIND_TRACE_CTX = 16, 17, 18, 19
# In a subtree envelope's batch section only: a grouped KIND_HITS record,
# as <H index of its hit section> (ops/tree.py).
KIND_HITS_REF = 20
PAYLOAD_RESPONSES, PAYLOAD_REPLAY, PAYLOAD_PULL_METRICS = 0, 1, 2
PAYLOAD_SIGNATURE, PAYLOAD_PULL_TRACE, PAYLOAD_PING, PAYLOAD_CTX = \
    3, 4, 5, 6
_CTX = struct.Struct("<IIQd")  # trace.CTX_STRUCT + the first post's stamp


def encode_request(req: Request) -> bytes:
    return struct.pack("<B", KIND_REQUEST) + req.pack()


def encode_withdraw(name: str, process_set_id: int) -> bytes:
    nb = name.encode("utf-8")
    return struct.pack("<BHH", KIND_WITHDRAW, process_set_id, len(nb)) + nb


def encode_shutdown() -> bytes:
    return struct.pack("<B", KIND_SHUTDOWN)


def encode_hits(hits: List[Tuple[int, int]]) -> bytes:
    """``(epoch, entry index)`` pairs as one record per run of equal
    epochs (a flush between two submissions changes the epoch)."""
    out, i = [], 0
    while i < len(hits):
        epoch = hits[i][0]
        j = i
        while j < len(hits) and hits[j][0] == epoch:
            j += 1
        idxs = [idx for _, idx in hits[i:j]]
        out.append(struct.pack(f"<BII{len(idxs)}I", KIND_HITS, epoch,
                               len(idxs), *idxs))
        i = j
    return b"".join(out)


def encode_metrics(snapshot: dict) -> bytes:
    body = json.dumps(snapshot).encode("utf-8")
    return struct.pack("<BI", KIND_METRICS, len(body)) + body


def _encode_blob(kind: int, body: bytes) -> bytes:
    return struct.pack("<BI", kind, len(body)) + body


def encode_signature(packed: bytes) -> bytes:
    return _encode_blob(KIND_SIGNATURE, packed)


def encode_trace(events: list) -> bytes:
    return _encode_blob(KIND_TRACE, json.dumps(events).encode("utf-8"))


def encode_pong(t0: float, t1: float, t1s: float) -> bytes:
    return struct.pack("<Bddd", KIND_PONG, t0, t1, t1s)


def encode_trace_ctx(ctx: bytes, t_post: float) -> bytes:
    """``ctx`` is ``trace.pack_ctx()``'s 16 bytes."""
    return struct.pack("<B", KIND_TRACE_CTX) + ctx + struct.pack("<d",
                                                                 t_post)


def encode_prefixes(pull_metrics: bool = False,
                    signature: Optional[Tuple[bool, str]] = None,
                    pull_trace: bool = False,
                    ping: Optional[float] = None,
                    ctx: Optional[bytes] = None) -> bytes:
    """Rank 0's broadcast prefixes (put them in front of the payload)."""
    out = []
    if pull_metrics:
        out.append(struct.pack("<B", PAYLOAD_PULL_METRICS))
    if signature is not None:
        text = signature[1].encode("utf-8")
        out.append(struct.pack("<BBI", PAYLOAD_SIGNATURE, int(signature[0]),
                               len(text)) + text)
    if pull_trace:
        out.append(struct.pack("<B", PAYLOAD_PULL_TRACE))
    if ping is not None:
        out.append(struct.pack("<Bd", PAYLOAD_PING, ping))
    if ctx is not None:
        out.append(struct.pack("<B", PAYLOAD_CTX) + ctx)
    return b"".join(out)


def strip_prefixes(payload: bytes) -> Tuple[dict, bytes]:
    """``({prefix kind: body}, the rest)`` of a broadcast: the metrics and
    trace pulls map to True, the signature verdict to ``(diverged,
    text)``, the probe to rank 0's stamp, the context to its tuple."""
    found: dict = {}
    off = 0
    while off < len(payload):
        kind = payload[off]
        if kind in (PAYLOAD_PULL_METRICS, PAYLOAD_PULL_TRACE):
            found[kind] = True
            off += 1
        elif kind == PAYLOAD_SIGNATURE:
            bad, n = struct.unpack_from("<BI", payload, off + 1)
            text = bytes(payload[off + 6:off + 6 + n]).decode("utf-8")
            found[kind] = (bool(bad), text)
            off += 6 + n
        elif kind == PAYLOAD_PING:
            (found[kind],) = struct.unpack_from("<d", payload, off + 1)
            off += 9
        elif kind == PAYLOAD_CTX:
            found[kind] = struct.unpack_from("<IIQ", payload, off + 1)
            off += 17
        else:
            break
    return found, payload[off:]


def iter_messages(buf: bytes, off: int = 0):
    """Yield ``(kind, start, end)`` for each message of a batch from
    ``off``: ``buf[start]`` is its kind byte and ``buf[start + 1:end]``
    its body.  Reads the lengths alone; raises ValueError on an unknown
    kind or a message that runs past the end (``struct.error`` on a
    truncated length)."""
    size = len(buf)
    while off < size:
        kind = buf[off]
        body = off + 1
        if kind == KIND_REQUEST:
            end = Request.skip(buf, body)
        elif kind == KIND_WITHDRAW:
            end = body + 4 + struct.unpack_from("<H", buf, body + 2)[0]
        elif kind == KIND_SHUTDOWN:
            end = body
        elif kind == KIND_HITS:
            end = body + 8 + 4 * struct.unpack_from("<I", buf, body + 4)[0]
        elif kind in (KIND_METRICS, KIND_TRACE, KIND_SIGNATURE):
            end = body + 4 + struct.unpack_from("<I", buf, body)[0]
        elif kind == KIND_PONG:
            end = body + 24
        elif kind == KIND_TRACE_CTX:
            end = body + _CTX.size
        elif kind == KIND_HITS_REF:
            end = body + 2
        else:
            raise ValueError(f"control batch: unknown message kind {kind} "
                             f"at byte {off}")
        if end > size:
            raise ValueError(f"control batch: the message at byte {off} "
                             f"runs past the end")
        yield kind, off, end
        off = end


def decode_batch(buf: bytes) -> List[Tuple[int, object]]:
    """``[(kind, body)]``: a Request, a (process set, name) pair, None, an
    (epoch, [entry index]) pair, a metrics snapshot, a packed signature,
    a span list, a ``(t0, t1, t1s)`` probe answer, or a ``(step, cycle,
    trace_id, t_post)`` context."""
    out: List[Tuple[int, object]] = []
    for kind, off, end in iter_messages(buf):
        off += 1
        if kind == KIND_REQUEST:
            body = Request.unpack(buf, off)[0]
        elif kind == KIND_WITHDRAW:
            body = (struct.unpack_from("<H", buf, off)[0],
                    bytes(buf[off + 4:end]).decode("utf-8"))
        elif kind == KIND_SHUTDOWN:
            body = None
        elif kind == KIND_HITS:
            epoch, count = struct.unpack_from("<II", buf, off)
            body = (epoch, list(struct.unpack_from(f"<{count}I", buf,
                                                   off + 8)))
        elif kind in (KIND_METRICS, KIND_TRACE):
            body = json.loads(bytes(buf[off + 4:end]))
        elif kind == KIND_SIGNATURE:
            body = bytes(buf[off + 4:end])
        elif kind == KIND_PONG:
            body = struct.unpack_from("<ddd", buf, off)
        elif kind == KIND_TRACE_CTX:
            body = _CTX.unpack_from(buf, off)
        else:
            raise ValueError(f"control batch: a hit reference at byte "
                             f"{off - 1} outside a subtree envelope")
        out.append((kind, body))
    return out


def encode_responses(responses: List[Response]) -> bytes:
    return struct.pack("<B", PAYLOAD_RESPONSES) + \
        wire.pack_response_list(responses)


def encode_replay(groups: List[List[int]], epoch: int) -> bytes:
    parts = [struct.pack("<BII", PAYLOAD_REPLAY, epoch, len(groups))]
    for g in groups:
        parts.append(struct.pack(f"<I{len(g)}I", len(g), *g))
    return b"".join(parts)


def decode_payload(buf: bytes):
    """``(PAYLOAD_RESPONSES, [Response])`` or ``(PAYLOAD_REPLAY,
    (groups, epoch))``."""
    (kind,) = struct.unpack_from("<B", buf, 0)
    if kind == PAYLOAD_RESPONSES:
        return kind, wire.unpack_response_list(bytes(buf[1:]))
    if kind != PAYLOAD_REPLAY:
        raise ValueError(f"response broadcast: unknown payload kind {kind}")
    epoch, n = struct.unpack_from("<II", buf, 1)
    off, groups = 9, []
    for _ in range(n):
        (k,) = struct.unpack_from("<I", buf, off)
        groups.append(list(struct.unpack_from(f"<{k}I", buf, off + 4)))
        off += 4 + 4 * k
    return kind, (groups, epoch)


def check_env_fingerprint(rank: int, theirs: str) -> None:
    """Warn, naming the rank and every knob, when ``rank``'s
    :func:`.compression.env_fingerprint` differs from this rank's
    (reference ``_check_env_fingerprint_str``, transport.py:498-515)."""
    from . import compression as _compression

    mine = _compression.env_fingerprint()
    if theirs == mine:
        return
    their_map = dict(kv.split("=", 1) for kv in theirs.split(";") if kv)
    my_map = dict(kv.split("=", 1) for kv in mine.split(";") if kv)
    diffs = [f"{k}: rank0={my_map.get(k, '?')} rank{rank}="
             f"{their_map.get(k, '?')}"
             for k in sorted(set(my_map) | set(their_map))
             if my_map.get(k) != their_map.get(k)]
    print(f"WARNING: rank {rank} disagrees with rank 0 on env knobs "
          f"that change the compiled SPMD program — collectives WILL "
          f"diverge (docs/performance.md \"Env-knob uniformity\"): "
          f"{'; '.join(diffs)}", file=sys.stderr)


# ---------------------------------------------------------------------------
# Frames (reference :75-197)
# ---------------------------------------------------------------------------

FRAME_HELLO = 0
FRAME_REQUEST = 1
FRAME_RESPONSES = 2
FRAME_TOPO = 3
FRAME_SHUTDOWN = 4
FRAME_WITHDRAW = 5
FRAME_SIGNATURE = 6
FRAME_SIGRESULT = 7
FRAME_REQUEST_BATCH = 8
FRAME_RESPONSE_BATCH = 9
FRAME_METRICS = 10
FRAME_RECONNECT = 11
FRAME_RESUME = 12
FRAME_PING = 13
FRAME_PONG = 14
FRAME_TRACE = 15
FRAME_HELLO_TREE = 16
FRAME_TOPO_TREE = 17
FRAME_SUBTREE_BATCH = 18
FRAME_METRICS_TREE = 19
FRAME_TRACE_TREE = 20
FRAME_CHILD_LOST = 21

_FRAME_NAMES = {
    FRAME_HELLO: "HELLO", FRAME_REQUEST: "REQUEST",
    FRAME_RESPONSES: "RESPONSES", FRAME_TOPO: "TOPO",
    FRAME_SHUTDOWN: "SHUTDOWN", FRAME_WITHDRAW: "WITHDRAW",
    FRAME_SIGNATURE: "SIGNATURE", FRAME_SIGRESULT: "SIGRESULT",
    FRAME_REQUEST_BATCH: "REQUEST_BATCH",
    FRAME_RESPONSE_BATCH: "RESPONSE_BATCH", FRAME_METRICS: "METRICS",
    FRAME_RECONNECT: "RECONNECT", FRAME_RESUME: "RESUME",
    FRAME_PING: "PING", FRAME_PONG: "PONG", FRAME_TRACE: "TRACE",
    FRAME_HELLO_TREE: "HELLO_TREE", FRAME_TOPO_TREE: "TOPO_TREE",
    FRAME_SUBTREE_BATCH: "SUBTREE_BATCH",
    FRAME_METRICS_TREE: "METRICS_TREE",
    FRAME_TRACE_TREE: "TRACE_TREE", FRAME_CHILD_LOST: "CHILD_LOST",
}


def frame_name(ftype: Optional[int]) -> str:
    return _FRAME_NAMES.get(ftype, f"type-{ftype}")


_HDR = struct.Struct("<IB")
_CYCLE = struct.Struct("<iQ")  # FRAME_REQUEST_BATCH: rank, batch seq
_BSEQ = struct.Struct("<Q")  # FRAME_RESPONSES: broadcast seq

# The reference's control-plane counters (:204-246), under its names.
_M_TX = _telemetry.counter("transport.frames_sent")
_M_TX_BYTES = _telemetry.counter("transport.bytes_sent")
_M_RX = _telemetry.counter("transport.frames_received")
_M_RX_BYTES = _telemetry.counter("transport.bytes_received")
_M_FRAME_BYTES = _telemetry.histogram(
    "transport.frame_bytes", "bytes", "payload size per control frame")
_M_BATCH_BITS = _telemetry.counter(
    "transport.batched_cache_bits", "cache-hit entry indices carried by "
    "cycle batches")
_M_BATCH_REQS = _telemetry.counter(
    "transport.batched_requests", "full requests carried by cycle "
    "batches")
_M_BATCH_WIDTH = _telemetry.histogram(
    "transport.batch_width", "count",
    "items (hits + requests) per cycle batch")
_M_DISCONNECTS = _telemetry.counter(
    "transport.disconnects", "control-plane connections lost without a "
    "shutdown handshake (reconnect grace entered)")
_M_RECONNECTS = _telemetry.counter(
    "transport.reconnects", "worker control-plane reconnects completed")
_M_RECONNECTS_ACCEPTED = _telemetry.counter(
    "transport.reconnects_accepted", "worker reconnects the controller "
    "resumed")
_M_RECONNECT_FAILURES = _telemetry.counter(
    "transport.reconnect_failures", "reconnect attempts that failed "
    "(connect refused / handshake error)")
_M_REPLAYED = _telemetry.counter(
    "transport.frames_replayed", "frames re-sent from a replay ring "
    "after a reconnect")
_M_FRAME_TIMEOUTS = _telemetry.counter(
    "transport.frame_timeouts", "mid-frame read deadlines exceeded "
    "(slow/stalled peer)")
_M_TREE_MERGED = _telemetry.counter(
    "transport.tree_merged_frames", "child control frames dissolved "
    "into merged FRAME_SUBTREE_BATCH envelopes")
_M_TREE_BITS = _telemetry.counter(
    "transport.tree_merged_cache_bits", "cache-hit entry indices interiors "
    "sent in grouped hit sections, counted once a rank")
_M_TREE_RELAYED = _telemetry.counter(
    "transport.tree_relayed_frames", "broadcast frames an interior "
    "node relayed down to its children")
_M_REPARENTS = _telemetry.counter(
    "transport.reparents", "orphaned tree ranks the root adopted as "
    "direct children after their interior parent died")
_M_CHILD_LOST = _telemetry.counter(
    "transport.tree_child_lost", "FRAME_CHILD_LOST reports interiors "
    "escalated to the root")


# -- knobs, read at call time (reference :251-273) ---------------------------

def _reconnect_enabled() -> bool:
    return os.environ.get("HVD_TPU_RECONNECT", "1") != "0"


def _grace_seconds() -> float:
    return float(os.environ.get("HVD_TPU_RECONNECT_GRACE", "10"))


def _reconnect_deadline_seconds() -> float:
    return float(os.environ.get("HVD_TPU_RECONNECT_DEADLINE", "10"))


def _ring_limit() -> int:
    return int(os.environ.get("HVD_TPU_RECONNECT_RING", "1024"))


def _frame_timeout() -> Optional[float]:
    v = float(os.environ.get("HVD_TPU_FRAME_TIMEOUT", "30"))
    return v if v > 0 else None


def _connect_timeout() -> float:
    return float(os.environ.get("HVD_TPU_CONNECT_TIMEOUT", "120"))


class FrameDeadlineError(OSError):
    """A peer stalled midway through a frame (hvd-chaos frame-level
    deadline).  Subclasses OSError so every broken-connection path —
    reconnect on the worker, grace on the controller — handles it."""


def _frame_deadline(peer: str, what: str, got: int,
                    want: int) -> FrameDeadlineError:
    msg = (f"control-plane frame deadline exceeded: peer {peer} stalled "
           f"mid-frame ({what}, {got}/{want} bytes within "
           f"{_frame_timeout()}s)")
    _M_FRAME_TIMEOUTS.inc()
    _flight.record("frame_timeout", peer, what, got, want)
    print(f"WARNING: {msg}", file=sys.stderr)
    return FrameDeadlineError(msg)


class PeerLostError(ConnectionError):
    """Rank 0's gather: a rank it waits for was declared lost (its grace
    window expired, or the replay ring could not resume it)."""

    def __init__(self, ranks: List[int], why: str) -> None:
        self.ranks, self.why = list(ranks), why
        super().__init__(f"rank(s) {self.ranks} {DEAD_PEER_MARKER}"
                         + (f" ({why})" if why else ""))


class _FrameRing:
    """Bounded replay ring for one send direction (reference :293-319):
    every post-handshake frame is appended with a cumulative index;
    ``since(n)`` returns the frames the peer (which received ``n`` of
    them) is missing, or None when the gap outgrew the ring.  Callers
    serialize access under their send lock."""

    def __init__(self, limit: int) -> None:
        self._limit = max(1, limit)
        self._frames: collections.deque = collections.deque()
        self._base = 0   # stream index of _frames[0]
        self.count = 0   # frames ever appended

    def append(self, ftype: int, payload: bytes) -> int:
        self._frames.append((ftype, payload))
        self.count += 1
        if len(self._frames) > self._limit:
            self._frames.popleft()
            self._base += 1
        return self.count

    def since(self, received: int) -> Optional[List[Tuple[int, bytes]]]:
        if received < self._base or received > self.count:
            return None
        return list(itertools.islice(
            self._frames, received - self._base, len(self._frames)))


def _send_frame(sock: socket.socket, ftype: int, payload: bytes = b"") -> None:
    sock.sendall(_HDR.pack(len(payload), ftype) + payload)
    _M_TX.inc()
    _M_TX_BYTES.inc(_HDR.size + len(payload))
    _M_FRAME_BYTES.observe(len(payload))


def _wake_close(sock: socket.socket) -> None:
    """Close a socket another thread may be blocked reading: ``shutdown``
    delivers the EOF first, so the reader wakes at once."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _hard_close(sock: socket.socket) -> None:
    """Close with RST (SO_LINGER 0): the chaos 'connection reset' wire
    effect; the peer's recv fails instead of seeing a clean EOF."""
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass
    _wake_close(sock)


def _apply_send_chaos(sock: socket.socket, ftype: int,
                      payload: bytes) -> str:
    """Consult the hvd-chaos schedule for one outgoing post-handshake
    frame and perform the fault's wire effect (reference :358-407).
    Returns "send", "done" (dropped, or already on the wire) or "dup"
    (the caller sends it twice and rings both copies).  Raises
    ConnectionResetError for the connection-killing faults."""
    if not _chaos.active():
        return "send"
    if _chaos.fire("transport.drop") is not None:
        return "done"  # silent loss; only a reconnect replay recovers it
    if _chaos.fire("transport.reset") is not None:
        _hard_close(sock)
        raise ConnectionResetError(
            f"hvd-chaos: transport.reset before {frame_name(ftype)}")
    f = _chaos.fire("transport.trunc")
    if f is not None:
        blob = _HDR.pack(len(payload), ftype) + payload
        cut = max(1, (len(blob) * 2) // 3)
        try:
            sock.sendall(blob[:cut])
        except OSError:
            pass
        _hard_close(sock)
        raise ConnectionResetError(
            f"hvd-chaos: transport.trunc mid-{frame_name(ftype)} "
            f"({cut}/{len(blob)} bytes)")
    f = _chaos.fire("transport.stall")
    if f is not None:
        blob = _HDR.pack(len(payload), ftype) + payload
        sock.sendall(blob[:_HDR.size])
        time.sleep(f.delay)
        sock.sendall(blob[_HDR.size:])
        _M_TX.inc()
        _M_TX_BYTES.inc(len(blob))
        return "done"  # already on the wire, slowly
    f = _chaos.fire("transport.delay")
    if f is not None:
        time.sleep(f.delay)
    if _chaos.fire("transport.dup") is not None:
        return "dup"
    return "send"


def _send_frame_or_fault(sock: socket.socket, ftype: int,
                         payload: bytes = b"",
                         allow_dup: bool = True) -> int:
    """The steady-state send: chaos, then the real send.  Returns the
    stream slots the frame took (2 when chaos duplicated it), so the
    caller's replay ring stays aligned with the receiver's count.
    ``allow_dup=False`` (the tree's downward stream, whose global index
    a re-parent resumes from) sends a duplicated frame once."""
    act = _apply_send_chaos(sock, ftype, payload)
    if act == "done":
        return 1
    _send_frame(sock, ftype, payload)
    if act == "dup" and allow_dup:
        _send_frame(sock, ftype, payload)
        return 2
    return 1


def _recv_exact(sock: socket.socket, n: int, idle_ok: bool = False,
                peer: str = "", what: str = "") -> Optional[bytes]:
    """Read exactly ``n`` bytes.  With a socket timeout armed, a timeout
    between frames is legal idleness (``idle_ok``, header position only);
    one after any byte of the frame arrived is a stalled peer, raised as
    :class:`FrameDeadlineError` naming the peer and frame type."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if idle_ok and not buf:
                continue
            raise _frame_deadline(peer or "?", what or "frame",
                                  len(buf), n) from None
        if not chunk:
            if buf:
                _flight.record("truncated_frame", peer or "?",
                               what or "frame", len(buf), n)
                print(f"WARNING: truncated control frame from "
                      f"{peer or '?'} ({what or 'frame'}: {len(buf)}/"
                      f"{n} bytes before EOF)", file=sys.stderr)
            return None
        buf += chunk
    return buf


def _recv_frame(sock: socket.socket, peer: str = "",
                idle_ok: bool = True):
    """Read one frame; ``(None, None)`` at EOF.  ``idle_ok=False`` bounds
    even the wait for the first byte (the handshake reads)."""
    hdr = _recv_exact(sock, _HDR.size, idle_ok=idle_ok, peer=peer,
                      what="header")
    if hdr is None:
        return None, None
    length, ftype = _HDR.unpack(hdr)
    payload = _recv_exact(sock, length, peer=peer,
                          what=frame_name(ftype)) if length else b""
    if length and payload is None:
        return None, None
    _M_RX.inc()
    _M_RX_BYTES.inc(_HDR.size + length)
    return ftype, payload


def pack_hello(rank: int, hostname: str, fingerprint: str) -> bytes:
    hb, fb = hostname.encode("utf-8"), fingerprint.encode("utf-8")
    return (struct.pack("<iH", rank, len(hb)) + hb
            + struct.pack("<H", len(fb)) + fb)


def parse_hello(payload: bytes) -> Tuple[int, str, str]:
    rank, hlen = struct.unpack_from("<iH", payload)
    host = payload[6:6 + hlen].decode("utf-8")
    (flen,) = struct.unpack_from("<H", payload, 6 + hlen)
    off = 8 + hlen
    return rank, host, payload[off:off + flen].decode("utf-8")


def pack_withdraw(rank: int, name: str, process_set_id: int) -> bytes:
    nb = name.encode("utf-8")
    return (struct.pack("<iH", rank, len(nb)) + nb
            + struct.pack("<H", process_set_id))


def parse_withdraw(payload: bytes) -> Tuple[int, str, int]:
    rank, nlen = struct.unpack_from("<iH", payload)
    name = payload[6:6 + nlen].decode("utf-8")
    psid = 0
    if len(payload) >= 8 + nlen:
        (psid,) = struct.unpack_from("<H", payload, 6 + nlen)
    return rank, name, psid


def pack_resume(received: int, verdict: int, reason: str) -> bytes:
    rb = reason.encode("utf-8")
    return struct.pack("<IBH", received, verdict, len(rb)) + rb


@dataclass(frozen=True)
class Topology:
    local_rank: int
    local_size: int
    cross_rank: int
    cross_size: int


def _assign_topology(hosts: Dict[int, str]) -> Dict[int, Topology]:
    """rank→hostname ⇒ rank→(local/cross) placement (reference :525-541):
    local = ranks sharing a host, cross = one rank per host ordered by
    lowest global rank (operations.cc:1184-1196)."""
    by_host: Dict[str, List[int]] = {}
    for rank in sorted(hosts):
        by_host.setdefault(hosts[rank], []).append(rank)
    host_order = sorted(by_host, key=lambda h: by_host[h][0])
    out: Dict[int, Topology] = {}
    for ci, host in enumerate(host_order):
        ranks = by_host[host]
        for li, rank in enumerate(ranks):
            out[rank] = Topology(local_rank=li, local_size=len(ranks),
                                 cross_rank=ci, cross_size=len(host_order))
    return out


def batch_payload(rank: int, seq: int, batch: bytes) -> bytes:
    """A ``FRAME_REQUEST_BATCH`` payload."""
    return _CYCLE.pack(rank, seq) + batch


def _shutdown_payload(message: str = "") -> bytes:
    return encode_responses([Response(ResponseType.SHUTDOWN,
                                      error_message=message)])


def _account_batch(batch: bytes) -> None:
    """The reference's batch counters, from a batch's messages."""
    reqs = hits = 0
    try:
        for kind, off, _end in iter_messages(batch):
            if kind == KIND_REQUEST:
                reqs += 1
            elif kind == KIND_HITS:
                hits += struct.unpack_from("<I", batch, off + 5)[0]
    except (ValueError, struct.error):
        return
    if reqs or hits:
        _M_BATCH_REQS.inc(reqs)
        _M_BATCH_BITS.inc(hits)
        _M_BATCH_WIDTH.observe(reqs + hits)


# ---------------------------------------------------------------------------
# Rank 0
# ---------------------------------------------------------------------------

@dataclass
class _PeerSession:
    """Rank 0's session with one directly connected rank, surviving
    reconnects (reference :544-567): the live socket (None while
    disconnected), the outgoing replay ring, the received-frame count
    and the grace bookkeeping."""

    rank: int
    conn: Optional[socket.socket]
    ring: _FrameRing
    rx_count: int = 0
    rx_thread: Optional[threading.Thread] = None
    grace_deadline: Optional[float] = None
    disc_epoch: int = -1
    resuming: bool = False
    # Tree mode: every rank this connection's subtree covers.
    covers: set = field(default_factory=set)


@_races.race_checked
class ControllerTransport:
    """Rank 0: one connection a worker (or a direct child of the tree),
    the gather of every rank's cycle batch and the broadcast of the
    cycle's payload, the session-resume listener and the grace windows.

    Construction binds and listens (``port`` 0 picks a free one,
    :attr:`port` tells it); :meth:`accept` runs the handshake."""

    def __init__(self, num_processes: int, port: int = 0,
                 bind_host: str = "127.0.0.1", tree=None) -> None:
        self.num_processes = num_processes
        self.tree = tree
        # Tree mode: ONE shared broadcast ring (every path relays the
        # identical stream, so a re-parented rank resumes from its global
        # index) and per-origin upward frame counts.
        self._bcast_ring = _FrameRing(_ring_limit()) if tree is not None \
            else None
        self._lock = _lockorder.make_lock("ControllerTransport._lock")
        self._send_lock = _lockorder.make_lock(
            "ControllerTransport._send_lock")
        self._cond = threading.Condition(self._lock)
        self._rank_rx: Dict[int, int] = {}  # guarded_by: _lock
        # Per-rank cycle items not yet gathered, the last batch seq
        # taken, and the ranks that left with the exit handshake.
        self._inbox: Dict[int, List[bytes]] = {}  # guarded_by: _lock
        self._last_seq: Dict[int, int] = {}  # guarded_by: _lock
        self._left: set = set()  # guarded_by: _lock
        self._cycle_frames = 0  # guarded_by: _lock
        # Cache requests a cache-less resume's flush downgraded; the
        # runtime submits them on its next negotiation.
        self._orphans: List[Request] = []  # guarded_by: _lock
        self.lost_ranks: set = set()  # guarded_by: _lock
        self.lost_reasons: Dict[int, str] = {}  # guarded_by: _lock
        self._sess: Dict[int, _PeerSession] = {}  # guarded_by: _lock
        self.cache = None  # rank 0's response cache, set by the runtime
        self._closing = False
        self._bseq = 0  # broadcasts sent (cycle thread only)
        # Frames gathered a cycle -> cycles (chip_smoke's root count).
        self.frame_counts: collections.Counter = collections.Counter()
        self.clock = _trace_clock.ClockSync()
        self.topology: Dict[int, Topology] = {}
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((bind_host, port))
        self._srv.listen(max(1, num_processes))
        self.port = self._srv.getsockname()[1]
        self._threads: List[threading.Thread] = []

    def accept(self, hostname: Optional[str] = None) -> None:
        """The handshake (reference :654-749): one HELLO (HELLO_TREE
        under the tree) a direct child, each fingerprint checked, then
        TOPO (TOPO_TREE) back; frame deadlines arm; the receive threads
        and the session-resume listener start."""
        from . import cache as _cache_mod

        tree = self.tree
        n = self.num_processes
        hosts = {0: hostname or socket.gethostname()}
        socks: Dict[int, socket.socket] = {}
        coverage: Dict[int, set] = {}
        accept_timeout = _connect_timeout()
        self._srv.settimeout(accept_timeout)
        expected = len(tree.children(0)) if tree is not None else n - 1
        for _ in range(expected):
            try:
                conn, _addr = self._srv.accept()
            except socket.timeout:
                missing = sorted(set(range(n)) - set(hosts))
                raise TimeoutError(
                    f"controller: ranks {missing} did not connect within "
                    f"{accept_timeout}s; did those processes die during "
                    f"startup?") from None
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            ftype, payload = _recv_frame(conn)
            if tree is not None:
                if ftype != FRAME_HELLO_TREE:
                    raise RuntimeError(
                        f"controller expected HELLO_TREE, got frame "
                        f"type {ftype}")
                from . import tree as _tree_mod

                entries = _tree_mod.parse_hello_tree(payload)
                child = entries[0][0]
                coverage[child] = {r for r, _h, _fp in entries}
                for rank, host, fp in entries:
                    hosts[rank] = host
                    check_env_fingerprint(rank, fp)
                socks[child] = conn
                continue
            if ftype != FRAME_HELLO:
                raise RuntimeError(
                    f"controller expected HELLO, got frame type {ftype}")
            rank, host, fp = parse_hello(payload)
            hosts[rank] = host
            check_env_fingerprint(rank, fp)
            socks[rank] = conn
            coverage[rank] = {rank}
        if len(hosts) != n:
            missing = sorted(set(range(n)) - set(hosts))
            raise RuntimeError(
                f"controller: tree handshake left ranks {missing} "
                f"uncovered (HVD_TPU_TREE_FANOUT mismatch across ranks?)")
        self.topology = _assign_topology(hosts)
        cache_flag = 1 if _cache_mod.cache_enabled() else 0
        for rank, conn in socks.items():
            if tree is not None:
                from . import tree as _tree_mod

                _send_frame(conn, FRAME_TOPO_TREE, _tree_mod.pack_topo_tree(
                    cache_flag, [(r, self.topology[r])
                                 for r in sorted(coverage[rank])]))
            else:
                t = self.topology[rank]
                _send_frame(conn, FRAME_TOPO, struct.pack(
                    "<iiiii", t.local_rank, t.local_size, t.cross_rank,
                    t.cross_size, cache_flag))
        with self._lock:
            for rank, conn in socks.items():
                conn.settimeout(_frame_timeout())
                self._sess[rank] = _PeerSession(
                    rank=rank, conn=conn, ring=_FrameRing(_ring_limit()),
                    covers=set(coverage[rank]))
        for rank, conn in socks.items():
            self._start_rx(rank, conn)
        if _reconnect_enabled() and n > 1:
            self._srv.settimeout(None)
            th = threading.Thread(target=self._accept_loop,
                                  name="hvd-controller-accept", daemon=True)
            th.start()
            self._threads.append(th)
        atexit.register(self._atexit_handshake)

    def _start_rx(self, rank: int, conn: socket.socket) -> None:
        th = threading.Thread(target=self._serve, args=(rank, conn),
                              name=f"hvd-controller-rx-{rank}", daemon=True)
        with self._lock:
            self._sess[rank].rx_thread = th
        th.start()
        self._threads.append(th)

    def _atexit_handshake(self) -> None:
        """An interpreter that exits without ``hvd.shutdown()`` still
        tells the workers the controller left cleanly."""
        if self._closing:
            return
        try:
            self._broadcast_frame(FRAME_SHUTDOWN, b"")
        except OSError:
            pass

    # -- the cycle (the runtime's cycle thread) ----------------------------
    def gather(self, batch: bytes) -> List[bytes]:
        """Every rank's cycle batch, rank 0's (``batch``) first.  Waits
        for one item from each rank: its next batch, or a withdrawal or
        exit handshake sent in its place.  Raises :class:`PeerLostError`
        when a rank it waits for is lost."""
        n = self.num_processes
        while True:
            lost: List[int] = []
            with self._lock:
                missing = [r for r in range(1, n) if not self._inbox.get(r)]
                if not missing:
                    items = [self._inbox.pop(r) for r in range(1, n)]
                    frames, self._cycle_frames = self._cycle_frames, 0
                    break
                lost = sorted(set(missing) & self.lost_ranks)
                if lost:
                    why = "; ".join(f"rank {r}: {self.lost_reasons[r]}"
                                    for r in lost if r in self.lost_reasons)
                else:
                    self._cond.wait(0.05)
            if lost:
                raise PeerLostError(lost, why)
            self.expire_grace()
        self.frame_counts[frames] += 1
        return [batch] + [b"".join(parts) for parts in items]

    def broadcast(self, payload: Optional[bytes]) -> bytes:
        """Send the cycle's payload to every rank; returns it."""
        payload = payload or b""
        self._bseq += 1
        self._broadcast_frame(FRAME_RESPONSES, _BSEQ.pack(self._bseq)
                              + payload)
        return payload

    def take_orphans(self) -> List[Request]:
        with self._lock:
            out, self._orphans = self._orphans, []
        return out

    def _broadcast_frame(self, ftype: int, payload: bytes) -> None:
        """One frame to every session (reference :1576-1616): appended to
        the replay ring first, so a rank in its grace window receives it
        on resume, in order."""
        with self._send_lock:
            with self._lock:
                sessions = list(self._sess.values())
            if self.tree is not None:
                self._bcast_ring.append(ftype, payload)
                for sess in sessions:
                    conn = sess.conn
                    if conn is None:
                        continue
                    try:
                        _send_frame_or_fault(conn, ftype, payload,
                                             allow_dup=False)
                    except OSError as e:
                        self._mark_disconnected(sess, f"send failed: {e}")
                return
            for sess in sessions:
                sess.ring.append(ftype, payload)
                conn = sess.conn
                if conn is None:
                    continue
                try:
                    if _send_frame_or_fault(conn, ftype, payload) == 2:
                        sess.ring.append(ftype, payload)  # chaos dup
                except OSError as e:
                    self._mark_disconnected(sess, f"send failed: {e}")

    def _take_item(self, rank: int, item: bytes, frame: bool = True) -> None:
        with self._lock:
            self._inbox.setdefault(rank, []).append(item)
            if frame:
                self._cycle_frames += 1
            self._cond.notify_all()

    def _take_batch(self, body: bytes, cum: int = 0,
                    frame: bool = True) -> None:
        """One rank's ``FRAME_REQUEST_BATCH`` payload (direct, or an
        entry of a subtree envelope): queued unless already taken."""
        rank, seq = _CYCLE.unpack_from(body)
        with self._lock:
            if cum > self._rank_rx.get(rank, 0):
                self._rank_rx[rank] = cum
            if seq and seq <= self._last_seq.get(rank, 0):
                return  # a duplicate, or replayed after a re-parent
            if seq:
                self._last_seq[rank] = seq
            self._inbox.setdefault(rank, []).append(body[_CYCLE.size:])
            if frame:
                self._cycle_frames += 1
            self._cond.notify_all()

    def _take_subtree(self, payload: bytes) -> None:
        """A subtree envelope (reference :1267-1300): every batch section
        back to the ``FRAME_REQUEST_BATCH`` payload its rank sent, taken
        as the flat star takes it, so a rank whose seq is stale is dropped
        alone."""
        from . import tree as _tree_mod

        entries, groups = _tree_mod.expand_subtree_batch(payload)
        for i, (cum, body) in enumerate(entries):
            self._take_batch(body, cum, frame=i == 0)
        _flight.record("frame_rx_subtree", len(entries), groups)

    # -- session-resume listener (reference :773-819) ----------------------
    def _accept_loop(self) -> None:  # thread: accept
        _athreads.set_role("accept")
        try:
            self._accept_loop_inner()
        except Exception:
            import traceback

            _telemetry.exception_event(
                "controller-accept", traceback.format_exc())
            raise

    def _accept_loop_inner(self) -> None:
        while not self._closing:
            try:
                conn, _addr = self._srv.accept()
            except OSError:
                return  # close() shut the server socket down
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                conn.settimeout(10.0)
                ftype, payload = _recv_frame(conn, peer="reconnecting",
                                             idle_ok=False)
            except OSError:
                continue
            if (ftype != FRAME_RECONNECT or self._closing
                    or len(payload) < 13):
                try:
                    conn.close()
                except OSError:
                    pass
                continue
            try:
                self._handle_reconnect(conn, payload)
            except Exception:  # noqa: BLE001 — one bad resume must not
                # kill the listener for the rest of the job
                import traceback

                _telemetry.exception_event(
                    "controller-resume", traceback.format_exc())
                try:
                    conn.close()
                except OSError:
                    pass

    def _mark_disconnected(self, sess: _PeerSession, why: str) -> None:
        """A connection broke: close it and open the grace window, or,
        with reconnect off, declare the rank lost (reference :821-857)."""
        with self._lock:
            conn, sess.conn = sess.conn, None
            if conn is not None:
                _wake_close(conn)
            if self._closing or sess.rank in self.lost_ranks \
                    or sess.rank in self._left:
                return
            if not _reconnect_enabled():
                self.lost_ranks.add(sess.rank)
                self.lost_reasons[sess.rank] = (
                    f"control-plane connection lost ({why}); reconnect "
                    f"disabled (HVD_TPU_RECONNECT=0)")
                self._cond.notify_all()
                return
            if sess.grace_deadline is None:
                grace = _grace_seconds()
                sess.grace_deadline = time.monotonic() + grace
                sess.disc_epoch = (self.cache.epoch
                                   if self.cache is not None else -1)
                _M_DISCONNECTS.inc()
                _flight.record("peer_disconnect", sess.rank, why)
                print(f"[hvd-reconnect] controller: rank {sess.rank} "
                      f"control-plane connection lost ({why}); holding "
                      f"its session for {grace:.1f}s grace",
                      file=sys.stderr)
        _telemetry.transport_fault_event("peer-disconnect",
                                         f"rank {sess.rank}: {why}")

    def expire_grace(self) -> None:
        """A disconnected rank whose grace window expired without a
        reconnect becomes a dead peer, with a reason naming the fault
        (reference :859-909)."""
        now = time.monotonic()
        with self._lock:
            for sess in list(self._sess.values()):
                if (sess.grace_deadline is None or sess.resuming
                        or now <= sess.grace_deadline
                        or sess.rank in self.lost_ranks):
                    continue
                reason = (f"control-plane connection lost; no reconnect "
                          f"within {_grace_seconds():.1f}s grace")
                self.lost_ranks.add(sess.rank)
                self.lost_reasons[sess.rank] = reason
                sess.grace_deadline = None
                _flight.record("grace_expired", sess.rank)
                print(f"ERROR: rank {sess.rank}: {reason}", file=sys.stderr)
                # Tree mode: the expired link covered a subtree; each
                # covered rank gets its own window to re-parent.
                for crank in sorted(sess.covers - {sess.rank}):
                    if crank in self.lost_ranks or crank in self._sess:
                        continue
                    self._sess[crank] = _PeerSession(
                        rank=crank, conn=None, ring=_FrameRing(1),
                        covers={crank},
                        grace_deadline=now + _grace_seconds(),
                        disc_epoch=(self.cache.epoch
                                    if self.cache is not None else -1))
                    print(f"[hvd-tree] controller: rank {crank} was routed "
                          f"via lost rank {sess.rank}; holding "
                          f"{_grace_seconds():.1f}s for a re-parent",
                          file=sys.stderr)
                sess.covers = {sess.rank}
                self._cond.notify_all()

    def _handle_reconnect(self, conn: socket.socket,
                          payload: bytes) -> None:
        """Resume one rank's session on a fresh socket (reference
        :911-983); under the tree, adopt a re-parenting rank as a direct
        child."""
        rank, their_rx, epoch, has_cache = struct.unpack_from("<iIiB",
                                                              payload)
        adopted = False
        with self._lock:
            sess = self._sess.get(rank)
            lost = rank in self.lost_ranks
            if (sess is None and not lost and self.tree is not None
                    and 0 < rank < self.num_processes):
                for other in self._sess.values():
                    other.covers.discard(rank)
                sess = _PeerSession(
                    rank=rank, conn=None, ring=_FrameRing(1), covers={rank},
                    disc_epoch=(self.cache.epoch
                                if self.cache is not None else -1))
                self._sess[rank] = sess
                adopted = True
            why = (self.lost_reasons.get(rank, "declared dead")
                   if lost else "unknown rank")
        if sess is None or lost:
            self._reject_reconnect(conn, rank, why)
            return
        if adopted:
            _M_REPARENTS.inc()
            _flight.record("tree_reparent", rank)
            print(f"[hvd-tree] controller: adopting rank {rank} as a "
                  f"direct child (re-parented after interior loss)",
                  file=sys.stderr)
        with self._lock:
            sess.resuming = True
        try:
            self._resume_session(sess, conn, their_rx, epoch, has_cache)
        finally:
            with self._lock:
                sess.resuming = False
                if (sess.conn is None and sess.rank not in self.lost_ranks
                        and not self._closing):
                    sess.grace_deadline = time.monotonic() + _grace_seconds()

    def _resume_session(self, sess: _PeerSession, conn: socket.socket,
                        their_rx: int, epoch: int, has_cache: int) -> None:
        """Reference :985-1060: replay the suffix the worker missed and
        give the cache verdict; reset the peer's clock samples."""
        rank = sess.rank
        self._mark_disconnected(sess, "superseded by reconnect")
        with self._lock:
            rx_th = sess.rx_thread
        if rx_th is not None and rx_th is not threading.current_thread():
            rx_th.join(timeout=5.0)
        with self._send_lock:
            ring = self._bcast_ring if self.tree is not None else sess.ring
            suffix = ring.since(their_rx)
            if suffix is None:
                reason = (f"cannot resume rank {rank}: it received "
                          f"{their_rx} of {ring.count} frames but the "
                          f"replay ring no longer holds that suffix (gap "
                          f"beyond HVD_TPU_RECONNECT_RING)")
                with self._lock:
                    self.lost_ranks.add(rank)
                    self.lost_reasons[rank] = "reconnect replay ring overflow"
                    self._cond.notify_all()
                self._reject_reconnect(conn, rank, reason)
                return
            cache = self.cache
            live_epoch = cache.epoch if cache is not None else -1
            if self.tree is not None:
                # The global stream's replay applies any flush markers
                # the rank missed, so only a future epoch is a desync.
                drop_cache = bool(has_cache) and (cache is None
                                                  or epoch > live_epoch)
                reason = (f"cache epoch {epoch} ahead of controller epoch "
                          f"{live_epoch}; resume cache-less"
                          if drop_cache else "")
            else:
                drop_cache = bool(has_cache) and (cache is None
                                                  or epoch != sess.disc_epoch)
                reason = (f"cache epoch {epoch} != disconnect-time epoch "
                          f"{sess.disc_epoch}; resume cache-less"
                          if drop_cache else "")
            verdict = 2 if drop_cache else 1
            with self._lock:
                rx_report = (self._rank_rx.get(rank, 0)
                             if self.tree is not None else sess.rx_count)
            try:
                _send_frame(conn, FRAME_RESUME,
                            pack_resume(rx_report, verdict, reason))
                for ftype, fpayload in suffix:
                    _send_frame(conn, ftype, fpayload)
                    _M_REPLAYED.inc()
            except OSError:
                try:
                    conn.close()
                except OSError:
                    pass
                return  # still in grace; the worker may try again
            conn.settimeout(_frame_timeout())
            with self._lock:
                sess.conn = conn
                sess.grace_deadline = None
        _M_RECONNECTS_ACCEPTED.inc()
        # The peer's network path changed: its old clock samples measured
        # a connection that no longer exists.
        self.clock.reset(rank)
        _flight.record("reconnect_accepted", rank, their_rx, len(suffix),
                       verdict)
        print(f"[hvd-reconnect] controller: rank {rank} resumed (replayed "
              f"{len(suffix)} frames"
              f"{', cache dropped' if drop_cache else ''})",
              file=sys.stderr)
        if drop_cache and cache is not None:
            # No compact replay the rank cannot rebuild is ever sent:
            # flush, and the runtime re-submits what the flush orphaned.
            orphans = cache.flush(f"rank {rank} reconnected cache-less",
                                  broadcast=True)
            with self._lock:
                self._orphans.extend(orphans)
        self._start_rx(rank, conn)

    def _reject_reconnect(self, conn: socket.socket, rank: int,
                          reason: str) -> None:
        print(f"[hvd-reconnect] controller: rejecting reconnect from rank "
              f"{rank}: {reason}", file=sys.stderr)
        _flight.record("reconnect_rejected", rank, reason)
        try:
            _send_frame(conn, FRAME_RESUME, pack_resume(0, 0, reason))
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    # -- receive threads (reference :1078-1226) ----------------------------
    def _serve(self, rank: int, conn: socket.socket) -> None:  # thread: rx
        _athreads.set_role("rx")
        try:
            self._serve_inner(rank, conn)
        except Exception:
            import traceback

            _telemetry.exception_event("controller-rx",
                                       traceback.format_exc())
            raise

    def _serve_inner(self, rank: int, conn: socket.socket) -> None:
        with self._lock:
            sess = self._sess[rank]
        while True:
            try:
                ftype, payload = _recv_frame(conn, peer=f"rank {rank}")
            except OSError:
                ftype = None  # died mid-frame, reset, or stalled
            if ftype is None:
                with self._lock:
                    superseded = sess.conn is not conn
                if superseded:
                    return  # a reconnect already installed a new socket
                if not self._closing:
                    _flight.record("peer_eof", rank)
                    self._mark_disconnected(sess, "eof")
                return
            sess.rx_count += 1
            if self.tree is not None:
                with self._lock:
                    self._rank_rx[rank] = self._rank_rx.get(rank, 0) + 1
            if ftype == FRAME_REQUEST_BATCH:
                self._take_batch(payload)
            elif ftype == FRAME_SUBTREE_BATCH:
                self._take_subtree(payload)
            elif ftype == FRAME_WITHDRAW:
                wrank, name, psid = parse_withdraw(payload)
                _flight.record("frame_rx_withdraw", wrank, name)
                self._take_item(wrank, encode_withdraw(name, psid))
            elif ftype == FRAME_SHUTDOWN:
                # The exit handshake: this link's ranks leave cleanly.
                with self._lock:
                    self._left |= sess.covers or {rank}
                self._take_item(rank, encode_shutdown())
            elif ftype == FRAME_CHILD_LOST:
                (crank,) = struct.unpack_from("<i", payload)
                (rlen,) = struct.unpack_from("<H", payload, 4)
                self._handle_child_lost(
                    crank, payload[6:6 + rlen].decode("utf-8"))

    def _handle_child_lost(self, crank: int, reason: str) -> None:
        """An interior reported a dead child link (reference :1350-1381):
        the root gives the rank its own grace window to re-parent."""
        _M_CHILD_LOST.inc()
        with self._lock:
            sess = self._sess.get(crank)
            if crank in self.lost_ranks:
                return
            if sess is not None and (sess.conn is not None
                                     or sess.resuming):
                return  # already re-parented; the report is stale
            for other in self._sess.values():
                other.covers.discard(crank)
            if sess is None:
                sess = _PeerSession(rank=crank, conn=None,
                                    ring=_FrameRing(1), covers={crank})
                self._sess[crank] = sess
            if sess.grace_deadline is None:
                sess.grace_deadline = time.monotonic() + _grace_seconds()
                sess.disc_epoch = (self.cache.epoch
                                   if self.cache is not None else -1)
        _flight.record("tree_child_lost", crank, reason)
        print(f"[hvd-tree] controller: interior reported rank {crank} "
              f"unreachable ({reason}); holding {_grace_seconds():.1f}s "
              f"for a re-parent", file=sys.stderr)

    def close(self) -> None:
        """Tell the workers the controller leaves, close every socket."""
        if not self._closing:
            try:
                self._broadcast_frame(FRAME_SHUTDOWN, b"")
            except OSError:
                pass
        self._closing = True
        atexit.unregister(self._atexit_handshake)
        with self._lock:
            conns = [s.conn for s in self._sess.values()
                     if s.conn is not None]
            for s in self._sess.values():
                s.conn = None
            self._cond.notify_all()
        for conn in conns:
            _wake_close(conn)
        # The accept thread is blocked in accept(): shutdown wakes it.
        _wake_close(self._srv)


# ---------------------------------------------------------------------------
# Ranks 1..N-1
# ---------------------------------------------------------------------------

@_races.race_checked
class WorkerTransport:
    """A worker: one connection to rank 0 (reference :1642-2194); sends
    its cycle batches, receives rank 0's payloads into a queue the
    cycle takes them from, and resumes a dropped session."""

    def __init__(self, host: str, port: int, rank: int,
                 hostname: Optional[str] = None,
                 connect_timeout: Optional[float] = None) -> None:
        self.rank = rank
        self._host, self._port = host, port
        self.cache = None  # this rank's response-cache replica, if any
        # Called when a resume drops the replica (the runtime's).
        self.on_cache_dropped: Optional[Callable[[], None]] = None
        self.on_wait: Optional[Callable[[], None]] = None
        self.shutdown_received = threading.Event()
        self._closing = False
        self._left = False
        self._responses: "queue.Queue[bytes]" = queue.Queue()
        self._seq = 0  # batches sent (cycle thread only)
        self._last_bseq = 0  # last broadcast taken (receive thread only)
        self._send_lock = _lockorder.make_lock("WorkerTransport._send_lock")
        self._ring = _FrameRing(_ring_limit())  # guarded_by: _send_lock
        self._broken = False  # guarded_by: _send_lock
        self._rx_count = 0  # the receive thread's
        timeout = _connect_timeout() if connect_timeout is None \
            else connect_timeout
        self._sock = self._connect(host, port, timeout)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._handshake(hostname)
        self._sock.settimeout(_frame_timeout())
        self._rx = threading.Thread(target=self._recv_loop,
                                    name=f"hvd-worker-rx-{rank}", daemon=True)
        self._rx.start()
        atexit.register(self._atexit_handshake)

    def _connect(self, host: str, port: int,
                 connect_timeout: float) -> socket.socket:
        """The initial connect with the shared jittered backoff, each
        attempt logged with the deadline left (reference :1686-1716)."""
        deadline = time.monotonic() + connect_timeout
        policy = BackoffPolicy(base=0.05, cap=2.0)
        attempt = 0
        while True:
            try:
                return socket.create_connection((host, port), timeout=5.0)
            except OSError as e:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"rank {self.rank} could not reach the controller "
                        f"at {host}:{port} within {connect_timeout}s: "
                        f"{e}") from e
                delay = min(policy.delay(attempt), max(remaining, 0.0))
                attempt += 1
                print(f"[hvd-connect] rank {self.rank}: controller "
                      f"{host}:{port} not reachable (attempt {attempt}: "
                      f"{e}); retrying in {delay:.2f}s ({remaining:.1f}s "
                      f"before deadline)", file=sys.stderr)
                time.sleep(delay)

    def _handshake(self, hostname: Optional[str]) -> None:
        """HELLO → TOPO (the tree overlay speaks HELLO_TREE/TOPO_TREE)."""
        from . import compression as _compression

        _send_frame(self._sock, FRAME_HELLO, pack_hello(
            self.rank, hostname or socket.gethostname(),
            _compression.env_fingerprint()))
        ftype, payload = _recv_frame(self._sock)
        if ftype != FRAME_TOPO:
            raise RuntimeError(f"rank {self.rank} expected TOPO from the "
                               f"controller, got {frame_name(ftype)}")
        lr, ls, cr, cs = struct.unpack_from("<iiii", payload)
        self.controller_cache = bool(struct.unpack_from(
            "<i", payload, 16)[0]) if len(payload) >= 20 else True
        self.topology = Topology(lr, ls, cr, cs)

    def _atexit_handshake(self) -> None:
        """An interpreter that exits without ``hvd.shutdown()`` still
        tells rank 0 it left cleanly: an EOF without it is a crash."""
        if self._closing:
            return
        self._leave()

    def _leave(self) -> None:
        if self._left:
            return
        self._left = True
        try:
            self._send(FRAME_SHUTDOWN)
        except OSError:
            pass

    # -- the cycle ---------------------------------------------------------
    def gather(self, batch: bytes) -> None:
        """Send this cycle's batch to rank 0."""
        _account_batch(batch)
        self._seq += 1
        self._send(FRAME_REQUEST_BATCH,
                   batch_payload(self.rank, self._seq, batch))

    def broadcast(self, payload: Optional[bytes] = None) -> bytes:
        """Rank 0's payload for this cycle (or a SHUTDOWN payload when
        the controller is gone)."""
        while True:
            try:
                return self._responses.get(timeout=0.05)
            except queue.Empty:
                pass
            self._idle()

    def _idle(self) -> None:
        """Each slice of a cycle's wait: the runtime's withdraw timer."""
        hook = self.on_wait
        if hook is not None:
            hook()

    def withdraw(self, name: str, process_set_id: int = 0) -> None:
        """At once, outside the cycle: this rank gave up on ``name``."""
        self._send(FRAME_WITHDRAW,
                   pack_withdraw(self.rank, name, process_set_id))

    # -- outgoing frames ---------------------------------------------------
    def _send(self, ftype: int, payload: bytes = b"") -> None:
        """The one post-handshake send path (reference :1770-1791): ring
        first; a broken connection buffers in the ring and the resume
        replays what rank 0 never received."""
        with self._send_lock:
            self._ring.append(ftype, payload)
            if self._broken:
                return
            sock = self._sock
            try:
                if _send_frame_or_fault(sock, ftype, payload) == 2:
                    self._ring.append(ftype, payload)  # chaos dup
            except OSError:
                self._broken = True
                _wake_close(sock)

    # -- receive thread ----------------------------------------------------
    def _recv_loop(self) -> None:  # thread: rx
        _athreads.set_role("rx")
        try:
            self._recv_loop_inner()
        except Exception:
            import traceback

            _telemetry.exception_event("worker-rx", traceback.format_exc())
            raise

    def _poison(self, detail: str) -> None:
        """The controller is unreachable for good: the cycle gets a
        SHUTDOWN naming it, so pending ops fail instead of hanging."""
        _telemetry.dead_peer_event(
            f"rank {self.rank}: controller unreachable ({detail})")
        self._responses.put(_shutdown_payload(
            f"Horovod has been shut down: the rank-0 controller "
            f"{DEAD_PEER_MARKER} while collectives were pending "
            f"({detail})."))

    def _recv_loop_inner(self) -> None:
        while True:
            sock = self._sock
            try:
                ftype, payload = _recv_frame(sock, peer="controller")
            except OSError:
                ftype = None
            if ftype is None:
                if self.shutdown_received.is_set() or self._closing:
                    return
                _flight.record("ctrl_eof", self.rank)
                if _reconnect_enabled():
                    why = self._reconnect()
                    if why is None:
                        continue  # resumed; keep receiving
                else:
                    why = "reconnect disabled (HVD_TPU_RECONNECT=0)"
                if self._closing or self.shutdown_received.is_set():
                    return
                self._poison(why)
                return
            self._rx_count += 1
            # Tree overlay: an interior relays the frame to its children
            # before it acts on it (no-op for a leaf or a flat worker).
            self._relay_downward(ftype, payload)
            if ftype == FRAME_RESPONSES:
                (seq,) = _BSEQ.unpack_from(payload)
                if seq <= self._last_bseq:
                    continue  # a duplicate
                self._last_bseq = seq
                self._responses.put(payload[_BSEQ.size:])
            elif ftype == FRAME_SHUTDOWN:
                self.shutdown_received.set()
                self._responses.put(_shutdown_payload())

    def _relay_downward(self, ftype: int, payload: bytes) -> None:
        """Tree-overlay hook (no-op here)."""

    # -- session resume (reference :1963-2069) -----------------------------
    def _drop_cache_replica(self) -> None:
        self.cache = None
        hook = self.on_cache_dropped
        if hook is not None:
            hook()

    def _reconnect(self) -> Optional[str]:
        """Re-establish the session with jittered backoff within
        ``HVD_TPU_RECONNECT_DEADLINE``; None on success, else the
        failure's diagnostic."""
        deadline = time.monotonic() + _reconnect_deadline_seconds()
        policy = BackoffPolicy(base=0.05, cap=2.0)
        attempt = 0
        last: Optional[str] = None
        while not (self._closing or self.shutdown_received.is_set()):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            attempt += 1
            print(f"[hvd-reconnect] rank {self.rank}: attempt {attempt} to "
                  f"{self._host}:{self._port} ({remaining:.1f}s before "
                  f"deadline{'; last error: ' + last if last else ''})",
                  file=sys.stderr)
            _flight.record("reconnect_attempt", self.rank, attempt)
            try:
                return self._try_resume(min(5.0, max(0.2, remaining)))
            except OSError as e:
                last = f"{type(e).__name__}: {e}"
                _M_RECONNECT_FAILURES.inc()
            time.sleep(min(policy.delay(attempt - 1),
                           max(0.0, deadline - time.monotonic())))
        return (f"no reconnect within {_reconnect_deadline_seconds():.1f}s "
                f"({attempt} attempts; last error: {last})")

    def _try_resume(self, timeout: float) -> Optional[str]:
        """One attempt: RECONNECT with our received count and cache
        epoch, the RESUME verdict, then the replay of our unacknowledged
        suffix.  None on resume, a terminal reason as a string; raises
        OSError on a retryable failure."""
        sock = socket.create_connection((self._host, self._port),
                                        timeout=timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(10.0)
            cache = self.cache
            epoch = cache.epoch if cache is not None else -1
            _send_frame(sock, FRAME_RECONNECT, struct.pack(
                "<iIiB", self.rank, self._rx_count, epoch,
                1 if cache is not None else 0))
            ftype, payload = _recv_frame(sock, peer="controller",
                                         idle_ok=False)
            if ftype != FRAME_RESUME:
                raise OSError(f"expected RESUME, got {frame_name(ftype)}")
            ctrl_rx, verdict, rlen = struct.unpack_from("<IBH", payload)
            reason = payload[7:7 + rlen].decode("utf-8")
            if verdict == 0:
                print(f"[hvd-reconnect] rank {self.rank}: controller "
                      f"rejected resume: {reason}", file=sys.stderr)
                sock.close()
                return f"controller rejected the session resume: {reason}"
            if verdict == 2:
                print(f"[hvd-reconnect] rank {self.rank}: resuming "
                      f"cache-less: {reason}", file=sys.stderr)
                self._drop_cache_replica()
            with self._send_lock:
                suffix = self._ring.since(ctrl_rx)
                count = self._ring.count
                if suffix is not None:
                    for ftype2, payload2 in suffix:
                        _send_frame(sock, ftype2, payload2)
                        _M_REPLAYED.inc()
                    sock.settimeout(_frame_timeout())
                    old, self._sock = self._sock, sock
                    self._broken = False
            if suffix is None:
                sock.close()
                return (f"outgoing replay ring overflow (controller "
                        f"received {ctrl_rx} of {count} frames; "
                        f"HVD_TPU_RECONNECT_RING too small)")
            _wake_close(old)
            _M_RECONNECTS.inc()
            _flight.record("reconnected", self.rank, ctrl_rx, len(suffix),
                           verdict)
            _telemetry.transport_fault_event(
                "reconnect", f"rank {self.rank} resumed: replayed "
                f"{len(suffix)} frames, verdict {verdict}")
            print(f"[hvd-reconnect] rank {self.rank}: session resumed "
                  f"(replayed {len(suffix)} frames"
                  f"{', cache dropped' if verdict == 2 else ''})",
                  file=sys.stderr)
            return None
        except OSError:
            try:
                sock.close()
            except OSError:
                pass
            raise

    def close(self) -> None:
        """The exit handshake, then close the connection."""
        self._leave()
        self._closing = True
        atexit.unregister(self._atexit_handshake)
        _wake_close(self._sock)
