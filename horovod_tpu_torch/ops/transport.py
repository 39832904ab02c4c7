"""The control channel of the negotiated collectives (the message flow of
horovod_tpu/ops/transport.py:570-2071, itself v0.13's background loop,
operations.cc:1226-1374: MPI_Gather of the requests, MPI_Bcast of the
responses), over a dedicated gloo process group.

Every rank's background thread runs one exchange a cycle, in lockstep:

1. gather the batch lengths, then (if any batch is non-empty) the packed
   batches, to rank 0;
2. rank 0 negotiates and broadcasts the packed response list (its
   length, then, if non-empty, the bytes).

The exchange blocks until every rank reaches it, so a rank runs one
cycle at a time (the background thread, or a caller waiting in
``synchronize``, under the runtime's cycle lock), and everything the
ranks must agree on (requests,
withdrawals, shutdown, join) travels in the batches and the response
list, never as a side call.  With one rank there is no exchange.

A batch is a sequence of messages, each a one-byte kind and a body:
``KIND_REQUEST`` + :meth:`wire.Request.pack`; ``KIND_WITHDRAW`` +
``<HH`` (process set, name length) + name; ``KIND_SHUTDOWN``;
``KIND_HITS`` + ``<II`` (cache epoch, count) + ``count`` × ``<I``
response-cache entry indices: the requests of this rank that hit its
cache replica (:mod:`.cache`), in place of the reference's TCP
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
probe, the reference's ``FRAME_PING``); ``PAYLOAD_CTX`` + the 16-byte
trace context of the cycle (the reference's broadcast trailer).
"""

from __future__ import annotations

import json
import struct
import sys
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from . import wire
from .wire import Request, Response

KIND_REQUEST, KIND_WITHDRAW, KIND_SHUTDOWN, KIND_HITS = 0, 1, 2, 3
KIND_METRICS = 4
KIND_SIGNATURE, KIND_TRACE, KIND_PONG, KIND_TRACE_CTX = 16, 17, 18, 19
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


def decode_batch(buf: bytes) -> List[Tuple[int, object]]:
    """``[(kind, body)]``: a Request, a (process set, name) pair, None, an
    (epoch, [entry index]) pair, a metrics snapshot, a packed signature,
    a span list, a ``(t0, t1, t1s)`` probe answer, or a ``(step, cycle,
    trace_id, t_post)`` context."""
    out: List[Tuple[int, object]] = []
    off = 0
    while off < len(buf):
        (kind,) = struct.unpack_from("<B", buf, off)
        off += 1
        if kind == KIND_REQUEST:
            req, off = Request.unpack(buf, off)
            out.append((kind, req))
        elif kind == KIND_WITHDRAW:
            psid, nlen = struct.unpack_from("<HH", buf, off)
            off += 4
            out.append((kind, (psid,
                               bytes(buf[off:off + nlen]).decode("utf-8"))))
            off += nlen
        elif kind == KIND_SHUTDOWN:
            out.append((kind, None))
        elif kind == KIND_HITS:
            epoch, count = struct.unpack_from("<II", buf, off)
            off += 8
            out.append((kind, (epoch, list(struct.unpack_from(
                f"<{count}I", buf, off)))))
            off += 4 * count
        elif kind in (KIND_METRICS, KIND_TRACE):
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            out.append((kind, json.loads(bytes(buf[off:off + n]))))
            off += n
        elif kind == KIND_SIGNATURE:
            (n,) = struct.unpack_from("<I", buf, off)
            off += 4
            out.append((kind, bytes(buf[off:off + n])))
            off += n
        elif kind == KIND_PONG:
            out.append((kind, struct.unpack_from("<ddd", buf, off)))
            off += 24
        elif kind == KIND_TRACE_CTX:
            out.append((kind, _CTX.unpack_from(buf, off)))
            off += _CTX.size
        else:
            raise ValueError(f"control batch: unknown message kind {kind} "
                             f"at byte {off - 1}")
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


def _as_tensor(data: bytes, length: int) -> torch.Tensor:
    t = torch.zeros(length, dtype=torch.uint8)
    if data:
        t[:len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return t


class ControlChannel:
    """Gather to rank 0 and broadcast from it on ``group`` (gloo, CPU
    tensors), for ``size`` ranks."""

    def __init__(self, group, rank: int, size: int) -> None:
        self.group, self.rank, self.size = group, rank, size

    def gather(self, batch: bytes) -> Optional[List[bytes]]:
        """Every rank's batch on rank 0 (in rank order); None elsewhere."""
        lens = [torch.zeros(1, dtype=torch.int64) for _ in range(self.size)]
        dist.all_gather(lens, torch.tensor([len(batch)], dtype=torch.int64),
                        group=self.group)
        sizes = [int(n) for n in lens]
        longest = max(sizes)
        if longest == 0:
            return [b""] * self.size if self.rank == 0 else None
        mine = _as_tensor(batch, longest)
        if self.rank == 0:
            bufs = [torch.empty(longest, dtype=torch.uint8)
                    for _ in range(self.size)]
            dist.gather(mine, bufs, dst=0, group=self.group)
            return [b.numpy().tobytes()[:n] for b, n in zip(bufs, sizes)]
        dist.gather(mine, None, dst=0, group=self.group)
        return None

    def broadcast(self, payload: Optional[bytes]) -> bytes:
        """Rank 0's ``payload`` on every rank."""
        n = torch.tensor([len(payload) if self.rank == 0 else 0],
                         dtype=torch.int64)
        dist.broadcast(n, src=0, group=self.group)
        length = int(n)
        if length == 0:
            return b""
        buf = _as_tensor(payload if self.rank == 0 else b"", length)
        dist.broadcast(buf, src=0, group=self.group)
        return buf.numpy().tobytes()


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
