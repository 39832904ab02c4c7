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
``<HH`` (process set, name length) + name; ``KIND_SHUTDOWN``.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from .wire import Request

KIND_REQUEST, KIND_WITHDRAW, KIND_SHUTDOWN = 0, 1, 2


def encode_request(req: Request) -> bytes:
    return struct.pack("<B", KIND_REQUEST) + req.pack()


def encode_withdraw(name: str, process_set_id: int) -> bytes:
    nb = name.encode("utf-8")
    return struct.pack("<BHH", KIND_WITHDRAW, process_set_id, len(nb)) + nb


def encode_shutdown() -> bytes:
    return struct.pack("<B", KIND_SHUTDOWN)


def decode_batch(buf: bytes) -> List[Tuple[int, object]]:
    """``[(kind, body)]``: a Request, a (process set, name) pair, or None."""
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
        else:
            raise ValueError(f"control batch: unknown message kind {kind} "
                             f"at byte {off - 1}")
    return out


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
