"""Eager collectives on ``torch.distributed`` (port of the public surface of
horovod_tpu/ops/collective.py:2429-2913).

Each ``*_async`` call starts an ``async_op=True`` collective on a copy of
its input, placed on the device ``init`` bound, and returns an integer
handle; ``synchronize`` waits for it and returns the result on the
input's device, ``poll`` asks without waiting.  Inputs are never written.
``name`` is kept for the reference's signatures: without the negotiation
layer, collectives match up by call order and nothing reads it.

The port has allreduce (Average, Sum), allgather (variable dim 0),
broadcast and barrier.  The other reductions, alltoall, reducescatter,
the grouped variants, process sets and the negotiation layer
(ops/coordinator.py) come in a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..core import state as _state
from .handles import HandleManager
from .wire import ReduceOp

_handles = HandleManager()


def _resolve_op(average, op) -> ReduceOp:
    """``op`` and ``average`` are mutually exclusive; neither means
    Average (the reference's default)."""
    if op is not None:
        if average is not None:
            raise ValueError("specify either average= or op=, not both "
                             "(they are mutually exclusive).")
        red = ReduceOp(op)
    else:
        red = ReduceOp.SUM if average is not None and not average \
            else ReduceOp.AVERAGE
    if red not in (ReduceOp.AVERAGE, ReduceOp.SUM):
        raise NotImplementedError(
            f"op={red.name.lower()} is not in this slice of the port "
            f"(Average and Sum are); see ROADMAP.md queue A")
    return red


def _on_device(tensor: torch.Tensor) -> torch.Tensor:
    """A private copy of ``tensor`` on the process group's device."""
    return tensor.detach().to(_state.device(), copy=True)


def _divide(x: torch.Tensor, denom: int) -> torch.Tensor:
    """Average's division; integer dtypes divide with floor, as the
    reference does."""
    if x.dtype.is_floating_point or x.dtype.is_complex:
        return x.div_(denom)
    return x.floor_divide_(denom)


def allreduce_async(tensor, average=None, name: Optional[str] = None,
                    op=None) -> int:
    """Start an allreduce of ``tensor`` over all ranks; returns a handle.
    Averages by default; ``average=False`` or ``op=Sum`` sums."""
    _state._check_initialized()
    red = _resolve_op(average, op)
    out = _on_device(tensor)
    work = dist.all_reduce(out, op=dist.ReduceOp.SUM, async_op=True)
    n, home = _state.size(), tensor.device

    def finish(x):
        if red == ReduceOp.AVERAGE:
            x = _divide(x, n)
        return x.to(home)

    return _handles.allocate(work, out, finish)


def allreduce(tensor, average=None, name: Optional[str] = None, op=None):
    """Synchronous allreduce: mean by default, sum with ``average=False``
    or ``op=Sum``."""
    return synchronize(allreduce_async(tensor, average=average, name=name,
                                       op=op))


def broadcast_async(tensor, root_rank: int,
                    name: Optional[str] = None) -> int:
    """Start a broadcast of ``root_rank``'s ``tensor``; returns a handle."""
    _state._check_initialized()
    if not 0 <= root_rank < _state.size():
        raise ValueError(f"root_rank {root_rank} outside "
                         f"[0, {_state.size()}).")
    out = _on_device(tensor)
    work = dist.broadcast(out, src=root_rank, async_op=True)
    home = tensor.device
    return _handles.allocate(work, out, lambda x: x.to(home))


def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    """Synchronous broadcast from ``root_rank``."""
    return synchronize(broadcast_async(tensor, root_rank, name=name))


def _check_allgather_shapes(shapes, dtypes) -> None:
    """The reference's agreement rules and messages
    (ops/coordinator.py:190-280): one dtype, one rank, equal dims past
    the first.  Every rank sees the same gathered metadata, so every rank
    raises alike."""
    first = shapes[0]
    for dt in dtypes[1:]:
        if dt != dtypes[0]:
            raise ValueError(f"Mismatched data types: One rank had type "
                             f"{dtypes[0]}, but another rank had type {dt}.")
    if not first:
        raise ValueError("Rank zero tried to gather a rank-zero tensor.")
    for shape in shapes[1:]:
        if len(shape) != len(first):
            raise ValueError(
                f"Mismatched allgather tensor shapes: One rank sent a tensor "
                f"of rank {len(first)}, but another rank sent a tensor of "
                f"rank {len(shape)}.")
        for dim in range(1, len(first)):
            if shape[dim] != first[dim]:
                raise ValueError(
                    f"Mismatched allgather tensor shapes: One rank sent a "
                    f"tensor with dimension {dim} equal to {first[dim]}, but "
                    f"another rank sent a tensor with dimension {dim} equal "
                    f"to {shape[dim]}.")


def allgather_async(tensor, name: Optional[str] = None) -> int:
    """Start an allgather along dim 0, in rank order; ranks may send
    different dim-0 sizes (the other dims must agree).  Returns a handle.

    Shapes and dtypes are exchanged first (a blocking object gather: the
    sizes decide the buffers); then every rank pads its tensor to the
    largest dim 0 and one ``all_gather`` runs asynchronously; the result
    is the concatenation of each rank's unpadded rows."""
    _state._check_initialized()
    meta = (tuple(tensor.shape), str(tensor.dtype))
    metas = [meta]
    if _state.size() > 1:
        metas = [None] * _state.size()
        dist.all_gather_object(metas, meta)
    _check_allgather_shapes([m[0] for m in metas], [m[1] for m in metas])
    rows = [m[0][0] for m in metas]
    longest = max(rows)
    out = _on_device(tensor)
    if out.shape[0] < longest:
        out = torch.cat([out, out.new_zeros((longest - out.shape[0],)
                                            + tuple(out.shape[1:]))])
    parts = [torch.empty_like(out) for _ in rows]
    work = dist.all_gather(parts, out, async_op=True)
    home = tensor.device

    def finish(gathered):
        return torch.cat([p[:n] for p, n in zip(gathered, rows)]).to(home)

    return _handles.allocate(work, parts, finish)


def allgather(tensor, name: Optional[str] = None):
    """Synchronous allgather along dim 0, in rank order."""
    return synchronize(allgather_async(tensor, name=name))


def barrier() -> None:
    """Block until every rank reaches the barrier."""
    _state._check_initialized()
    dist.barrier()


def poll(handle: int) -> bool:
    """True once the collective behind ``handle`` has completed."""
    return _handles.poll(handle)


def synchronize(handle: int):
    """Wait for the collective behind ``handle`` and return its output."""
    return _handles.synchronize(handle)
