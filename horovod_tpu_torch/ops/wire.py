"""Control-message wire format of the negotiated collectives.

Copied from horovod_tpu/ops/wire.py:30-349 (the port may not import it:
importing any horovod_tpu module imports jax), with ``dtype_of`` taking
``torch.dtype``s.  Packed bytes equal the reference's for the same
message field for field, so the two coordinators can be compared byte for
byte.

  Request  ≙ MPIRequest: request_rank, request_type, tensor_type,
             tensor_name, root_rank, device, tensor_shape, reduce_op,
             process_set_id, splits.
  Response ≙ MPIResponse: response_type (incl. ERROR/DONE/SHUTDOWN/JOIN),
             fused tensor_names, error_message, devices, tensor_sizes
             (allgather dim 0 per rank, the alltoall split matrix, the
             broadcast root, the last joining rank), the validated dtype
             and shapes, reduce_op, process_set_id.

Layout: little-endian ``struct`` records, self-delimiting, so a batch is
the concatenation of its records.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from enum import IntEnum
from typing import List, Optional, Tuple

import torch


class DataType(IntEnum):
    """≙ MPIDataType plus bfloat16, float16, uint32 and uint64."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    INT32 = 4
    INT64 = 5
    FLOAT32 = 6
    FLOAT64 = 7
    BOOL = 8
    BFLOAT16 = 9
    FLOAT16 = 10
    UINT32 = 11
    UINT64 = 12


_TORCH_TO_DTYPE = {
    torch.uint8: DataType.UINT8, torch.int8: DataType.INT8,
    torch.uint16: DataType.UINT16, torch.int16: DataType.INT16,
    torch.int32: DataType.INT32, torch.int64: DataType.INT64,
    torch.float32: DataType.FLOAT32, torch.float64: DataType.FLOAT64,
    torch.bool: DataType.BOOL, torch.bfloat16: DataType.BFLOAT16,
    torch.float16: DataType.FLOAT16, torch.uint32: DataType.UINT32,
    torch.uint64: DataType.UINT64,
}
_DTYPE_TO_TORCH = {v: k for k, v in _TORCH_TO_DTYPE.items()}

_DTYPE_SIZE = {
    DataType.UINT8: 1, DataType.INT8: 1, DataType.UINT16: 2,
    DataType.INT16: 2, DataType.INT32: 4, DataType.INT64: 8,
    DataType.FLOAT32: 4, DataType.FLOAT64: 8, DataType.BOOL: 1,
    DataType.BFLOAT16: 2, DataType.FLOAT16: 2,
    DataType.UINT32: 4, DataType.UINT64: 8,
}


def dtype_of(dtype: torch.dtype) -> DataType:
    """torch dtype -> wire DataType."""
    try:
        return _TORCH_TO_DTYPE[dtype]
    except KeyError:
        raise ValueError(f"Unsupported dtype for horovod_tpu_torch "
                         f"collective: {dtype}") from None


def torch_dtype_of(dt: DataType) -> torch.dtype:
    """Wire DataType -> torch dtype; a joined rank builds its zero
    contributions from a Response with it."""
    return _DTYPE_TO_TORCH[DataType(dt)]


def dtype_name(dt: DataType) -> str:
    return DataType(dt).name.lower()


def dtype_size(dt: DataType) -> int:
    return _DTYPE_SIZE[DataType(dt)]


class RequestType(IntEnum):
    """≙ MPIRequestType, plus JOIN (a rank out of data contributes zeros
    to every remaining collective), REDUCESCATTER and ALLTOALL."""

    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    JOIN = 3
    REDUCESCATTER = 4
    ALLTOALL = 5


class ReduceOp(IntEnum):
    """Allreduce reduction operator (hvd.Average/Sum/Adasum/Min/Max/
    Product).  Carried per Request so the coordinator validates cross-rank
    agreement and fuses only like-op responses."""

    AVERAGE = 0
    SUM = 1
    ADASUM = 2
    MIN = 3
    MAX = 4
    PRODUCT = 5


def reduce_op_name(op) -> str:
    return ReduceOp(op).name.lower()


class ResponseType(IntEnum):
    """≙ MPIResponseType.  ERROR carries a cross-rank validation message;
    SHUTDOWN closes the negotiation; JOIN releases every joined rank
    (tensor_sizes carries the last joining rank).  CACHE_FLUSH is the
    response cache's epoch marker; RETUNE carries hvd-tune's ``knob=value``
    tokens (tensor_names) and the decision's sequence number
    (tensor_sizes), applied by every rank at its stream position
    (tuning/actuation.py)."""

    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    ERROR = 3
    DONE = 4
    SHUTDOWN = 5
    JOIN = 6
    REDUCESCATTER = 7
    ALLTOALL = 8
    CACHE_FLUSH = 9
    RETUNE = 10


# Device id of a host-resident tensor (≙ CPU_DEVICE_ID, common.h:28).
CPU_DEVICE_ID = -1

# Phrase carried by every dead-peer SHUTDOWN diagnosis (a peer vanished
# without its exit handshake; reference wire.py:170-180).  Every producer
# (rank 0's gather in ops/collective.py, the worker's lost controller in
# ops/transport.py) builds its message from this constant.
DEAD_PEER_MARKER = "terminated unexpectedly"

_REQ_HEAD = "<BBiiiBHH"


@dataclass
class Request:
    request_rank: int
    request_type: RequestType
    tensor_type: DataType
    tensor_name: str
    root_rank: int = -1
    device: int = CPU_DEVICE_ID
    tensor_shape: Tuple[int, ...] = ()
    # ALLREDUCE/REDUCESCATTER: the reduction, validated across ranks.
    reduce_op: ReduceOp = ReduceOp.AVERAGE
    # Process set (0 = global).  request_rank/root_rank are SET-LOCAL
    # indices for other sets.
    process_set_id: int = 0
    # ALLTOALL: rows of dim 0 sent to each destination (empty = even).
    splits: Tuple[int, ...] = ()

    def pack(self) -> bytes:
        name_b = self.tensor_name.encode("utf-8")
        out = struct.pack(
            _REQ_HEAD, int(self.request_type), int(self.tensor_type),
            self.request_rank, self.root_rank, self.device,
            int(self.reduce_op), self.process_set_id, len(name_b))
        out += name_b
        out += struct.pack("<B", len(self.tensor_shape))
        for d in self.tensor_shape:
            out += struct.pack("<q", d)
        out += struct.pack("<H", len(self.splits))
        for s in self.splits:
            out += struct.pack("<q", s)
        return out

    @staticmethod
    def unpack(buf: bytes, off: int = 0) -> Tuple["Request", int]:
        rt, tt, rank, root, dev, rop, psid, nlen = struct.unpack_from(
            _REQ_HEAD, buf, off)
        off += struct.calcsize(_REQ_HEAD)
        name = bytes(buf[off:off + nlen]).decode("utf-8")
        off += nlen
        (ndim,) = struct.unpack_from("<B", buf, off)
        off += 1
        dims = struct.unpack_from(f"<{ndim}q", buf, off) if ndim else ()
        off += 8 * ndim
        (nspl,) = struct.unpack_from("<H", buf, off)
        off += 2
        spl = struct.unpack_from(f"<{nspl}q", buf, off) if nspl else ()
        off += 8 * nspl
        return Request(rank, RequestType(rt), DataType(tt), name, root, dev,
                       tuple(dims), ReduceOp(rop), psid, tuple(spl)), off


@dataclass
class Response:
    response_type: ResponseType
    tensor_names: List[str] = field(default_factory=list)
    error_message: str = ""
    devices: List[int] = field(default_factory=list)
    # ALLGATHER: dim 0 of each rank, in rank order (0 for joined ranks).
    # ALLTOALL: the split matrix, row-major by sender.  BROADCAST:
    # [root_rank].  JOIN: [last joining rank].
    tensor_sizes: List[int] = field(default_factory=list)
    # The validated dtype and each fused tensor's shape, aligned with
    # tensor_names: a joined rank builds its zero contributions from
    # them.  255 on the wire = no dtype.
    tensor_type: Optional[DataType] = None
    tensor_shapes: List[Tuple[int, ...]] = field(default_factory=list)
    reduce_op: ReduceOp = ReduceOp.AVERAGE
    process_set_id: int = 0

    def pack(self) -> bytes:
        out = struct.pack("<BH", int(self.response_type),
                          len(self.tensor_names))
        for n in self.tensor_names:
            nb = n.encode("utf-8")
            out += struct.pack("<H", len(nb)) + nb
        eb = self.error_message.encode("utf-8")
        out += struct.pack("<I", len(eb)) + eb
        out += struct.pack("<H", len(self.devices))
        for d in self.devices:
            out += struct.pack("<i", d)
        out += struct.pack("<H", len(self.tensor_sizes))
        for s in self.tensor_sizes:
            out += struct.pack("<q", s)
        out += struct.pack("<B", 255 if self.tensor_type is None
                           else int(self.tensor_type))
        out += struct.pack("<H", len(self.tensor_shapes))
        for shape in self.tensor_shapes:
            out += struct.pack("<B", len(shape))
            for d in shape:
                out += struct.pack("<q", d)
        out += struct.pack("<B", int(self.reduce_op))
        out += struct.pack("<H", self.process_set_id)
        return out

    @staticmethod
    def unpack(buf: bytes, off: int = 0) -> Tuple["Response", int]:
        rt, nnames = struct.unpack_from("<BH", buf, off)
        off += struct.calcsize("<BH")
        names = []
        for _ in range(nnames):
            (ln,) = struct.unpack_from("<H", buf, off)
            off += 2
            names.append(bytes(buf[off:off + ln]).decode("utf-8"))
            off += ln
        (elen,) = struct.unpack_from("<I", buf, off)
        off += 4
        err = bytes(buf[off:off + elen]).decode("utf-8")
        off += elen
        (ndev,) = struct.unpack_from("<H", buf, off)
        off += 2
        devices = list(struct.unpack_from(f"<{ndev}i", buf, off)) \
            if ndev else []
        off += 4 * ndev
        (nsz,) = struct.unpack_from("<H", buf, off)
        off += 2
        sizes = list(struct.unpack_from(f"<{nsz}q", buf, off)) if nsz else []
        off += 8 * nsz
        (tt,) = struct.unpack_from("<B", buf, off)
        off += 1
        (nshp,) = struct.unpack_from("<H", buf, off)
        off += 2
        shapes: List[Tuple[int, ...]] = []
        for _ in range(nshp):
            (ndim,) = struct.unpack_from("<B", buf, off)
            off += 1
            dims = struct.unpack_from(f"<{ndim}q", buf, off) if ndim else ()
            off += 8 * ndim
            shapes.append(tuple(dims))
        (rop,) = struct.unpack_from("<B", buf, off)
        off += 1
        (psid,) = struct.unpack_from("<H", buf, off)
        off += 2
        return Response(ResponseType(rt), names, err, devices, sizes,
                        None if tt == 255 else DataType(tt), shapes,
                        ReduceOp(rop), psid), off


def pack_response_list(responses: List[Response]) -> bytes:
    out = struct.pack("<H", len(responses))
    for r in responses:
        out += r.pack()
    return out


def unpack_response_list(buf: bytes) -> List[Response]:
    (n,) = struct.unpack_from("<H", buf, 0)
    off = 2
    out = []
    for _ in range(n):
        r, off = Response.unpack(buf, off)
        out.append(r)
    return out
