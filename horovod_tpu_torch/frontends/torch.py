"""The ``horovod.torch`` surface over the port's negotiated collectives
(port of horovod_tpu/frontends/torch.py; ≙ horovod/torch/mpi_ops.py and
horovod/torch/__init__.py).

Usage::

    import horovod_tpu_torch.frontends.torch as hvd
    hvd.init()
    h = hvd.allreduce_async_(p.grad, name="g0")   # in place, async
    hvd.synchronize(h)
    opt = hvd.DistributedOptimizer(opt, named_parameters=model.named_parameters())
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

Tensors stay on their device (no NumPy bridge) and float64 computes in
float64; the reference computes it in float32, x64 being off there.  An
in-place op's result is written into the caller's tensor by the executor
(a copy out of the fused buffer on its stream), and ``synchronize``
returns that same tensor object.  ``DistributedOptimizer`` registers
post-accumulate-grad hooks that fire ``allreduce_async_`` on each
``.grad`` as backward produces it; ``step()`` synchronizes them, then
steps the wrapped optimizer (≙ torch/__init__.py:30-122).
"""

from __future__ import annotations

import sys
import weakref
from typing import Dict, Iterable, Optional

import torch

from ..core.features import (  # noqa: F401  (feature queries)
    cuda_built, gloo_built, mpi_built, mpi_enabled, nccl_built, rocm_built)
from ..core.state import (init, is_initialized, local_rank,  # noqa: F401
                          local_size, mpi_threads_supported, rank, shutdown,
                          size, start_timeline, stop_timeline)
from ..analysis import program as _program
from ..ops import collective as _C
from ..ops.collective import (Adasum, Average, HorovodError,  # noqa: F401
                              Max, Min, Product, Sum, add_process_set,
                              barrier, global_process_set, join,
                              remove_process_set)
from ..ops.compression import (Compression, get_compression,  # noqa: F401
                                set_compression)
from ..ops.megakernel import (compression_state,  # noqa: F401
                              load_compression_state)
from ..ops.objects import allgather_object, broadcast_object  # noqa: F401
from ..ops.process_set import ProcessSet  # noqa: F401
from .torch_sync_bn import SyncBatchNorm  # noqa: F401


class _Pending:
    """An in-place or compressed op, as the frontend tracks it."""

    __slots__ = ("target", "compression", "ctx", "done", "wref", "error")

    def __init__(self, target: Optional[torch.Tensor], compression, ctx):
        self.target = target        # in-place target, or None
        self.compression = compression
        self.ctx = ctx
        self.done = False           # poll() already retired the handle
        self.wref = None            # weakref to the target after poll()
        self.error = None           # the failure poll() observed


# handle -> pending record.  poll() retires a completed in-place handle at
# once and keeps only a weak reference to its target, so a polled
# fire-and-forget handle pins neither the caller's tensor nor the
# collective's buffers; a later synchronize() still returns the target
# (the reference's identity contract, torch/mpi_ops.py:328-344).
_pending: Dict[int, _Pending] = {}


def _check(tensor) -> torch.Tensor:
    if not isinstance(tensor, torch.Tensor):
        raise ValueError(f"expected a torch.Tensor, got {type(tensor)}")
    return tensor.detach()


def _enqueue(kind: str, tensor, *, inplace: bool, compression=None,
             **kw) -> int:
    t = _check(tensor)
    wire, ctx = (compression.compress(t) if compression is not None
                 else (t, None))
    if inplace:
        kw["out"] = t
    # hvd-analyze: signature records from this funnel name the binding
    # (reference frontends/torch.py:123-125).
    with _program.collective_source("torch"):
        handle = getattr(_C, f"{kind}_async")(wire, **kw)
    _pending[handle] = _Pending(tensor if inplace else None, compression,
                                ctx)
    return handle


def poll(handle: int) -> bool:
    """Non-blocking completion check.  A completed in-place op is retired
    here: the core handle is released and only a weak reference to the
    target survives (its death evicts the record)."""
    entry = _pending.get(handle)
    if entry is not None and entry.done:
        return True
    done = _C.poll(handle)
    if done and entry is not None and entry.target is not None:
        try:
            _C.synchronize(handle)
        except HorovodError as exc:
            entry.target, entry.done, entry.error = None, True, exc
            return True
        target = entry.target
        entry.done = True
        # Refs now: entry.target, ``target``, getrefcount's argument.  A
        # temporary view (``p.data``) dies with our reference: keep it.
        if sys.getrefcount(target) > 3:
            entry.target = None
            entry.wref = weakref.ref(
                target, lambda _r, h=handle: _pending.pop(h, None))
    return done


def synchronize(handle: int) -> torch.Tensor:
    """Wait for ``handle``; returns the result (an in-place op returns the
    caller's tensor, now holding it)."""
    entry = _pending.pop(handle, None)
    if entry is not None and entry.done:
        if entry.error is not None:
            raise entry.error
        target = entry.target if entry.target is not None else (
            entry.wref() if entry.wref is not None else None)
        if target is None:
            raise ValueError(
                f"Handle {handle} completed via poll() and its in-place "
                f"target tensor has since been garbage-collected; the "
                f"result was written into that tensor and is gone with it.")
        return target
    result = _C.synchronize(handle)
    if entry is not None and entry.target is not None:
        return entry.target
    if entry is None:
        return result
    if entry.compression is not None:
        result = entry.compression.decompress(result, entry.ctx)
    return result


# -- allreduce --------------------------------------------------------------

def allreduce_async(tensor, average=None, name: Optional[str] = None,
                    compression=None, op=None, process_set=None) -> int:
    return _enqueue("allreduce", tensor, inplace=False, name=name,
                    compression=compression, average=average, op=op,
                    process_set=process_set)


def allreduce_async_(tensor, average=None, name: Optional[str] = None,
                     compression=None, op=None, process_set=None) -> int:
    return _enqueue("allreduce", tensor, inplace=True, name=name,
                    compression=compression, average=average, op=op,
                    process_set=process_set)


def allreduce(tensor, average=None, name: Optional[str] = None,
              compression=None, op=None, process_set=None) -> torch.Tensor:
    """``compression`` (``Compression.fp16``/``bf16``) casts the wire
    down and restores the dtype; ``op`` is any of Average/Sum/Min/Max/
    Product, exclusive with ``average``; ``process_set`` restricts the
    collective to a rank subset."""
    return synchronize(allreduce_async(tensor, average, name, compression,
                                       op, process_set))


def allreduce_(tensor, average=None, name: Optional[str] = None,
               compression=None, op=None, process_set=None) -> torch.Tensor:
    return synchronize(allreduce_async_(tensor, average, name, compression,
                                        op, process_set))


def _grouped_allreduce_async(tensors, *, inplace: bool, average, name,
                             compression, op=None, process_set=None) -> list:
    """One cycle's batch for the whole group, so it fuses; the default
    base name is unique per call."""
    ts = [_check(t) for t in tensors]
    wires = [compression.compress(t) if compression is not None
             else (t, None) for t in ts]
    handles = _C.grouped_allreduce_async(
        [w for w, _ in wires], average=average, name=name, op=op,
        process_set=process_set, outs=ts if inplace else None)
    for h, t, (_, ctx) in zip(handles, tensors, wires):
        _pending[h] = _Pending(t if inplace else None, compression, ctx)
    return handles


def grouped_allreduce_async(tensors, average=None,
                            name: Optional[str] = None, compression=None,
                            op=None, process_set=None) -> list:
    return _grouped_allreduce_async(tensors, inplace=False, average=average,
                                    name=name, compression=compression,
                                    op=op, process_set=process_set)


def grouped_allreduce(tensors, average=None, name: Optional[str] = None,
                      compression=None, op=None, process_set=None) -> list:
    return [synchronize(h) for h in grouped_allreduce_async(
        tensors, average, name, compression, op, process_set)]


def grouped_allreduce_async_(tensors, average=None,
                             name: Optional[str] = None, compression=None,
                             op=None, process_set=None) -> list:
    return _grouped_allreduce_async(tensors, inplace=True, average=average,
                                    name=name, compression=compression,
                                    op=op, process_set=process_set)


def grouped_allreduce_(tensors, average=None, name: Optional[str] = None,
                       compression=None, op=None, process_set=None) -> list:
    return [synchronize(h) for h in grouped_allreduce_async_(
        tensors, average, name, compression, op, process_set)]


# -- allgather, broadcast, alltoall, reducescatter ---------------------------

def allgather_async(tensor, name: Optional[str] = None,
                    process_set=None) -> int:
    return _enqueue("allgather", tensor, inplace=False, name=name,
                    process_set=process_set)


def allgather(tensor, name: Optional[str] = None,
              process_set=None) -> torch.Tensor:
    return synchronize(allgather_async(tensor, name, process_set))


def broadcast_async(tensor, root_rank: int, name: Optional[str] = None,
                    process_set=None) -> int:
    return _enqueue("broadcast", tensor, inplace=False, name=name,
                    root_rank=root_rank, process_set=process_set)


def broadcast_async_(tensor, root_rank: int, name: Optional[str] = None,
                     process_set=None) -> int:
    return _enqueue("broadcast", tensor, inplace=True, name=name,
                    root_rank=root_rank, process_set=process_set)


def broadcast(tensor, root_rank: int, name: Optional[str] = None,
              process_set=None) -> torch.Tensor:
    return synchronize(broadcast_async(tensor, root_rank, name, process_set))


def broadcast_(tensor, root_rank: int, name: Optional[str] = None,
               process_set=None) -> torch.Tensor:
    return synchronize(broadcast_async_(tensor, root_rank, name,
                                        process_set))


def alltoall(tensor, splits=None, name: Optional[str] = None,
             process_set=None) -> torch.Tensor:
    """Scatter this rank's dim-0 rows by ``splits``; receive every rank's
    rows in rank order."""
    with _program.collective_source("torch"):
        return _C.alltoall(_check(tensor), splits=splits, name=name,
                           process_set=process_set)


def reducescatter_async(tensor, average=None, name: Optional[str] = None,
                        op=None, process_set=None) -> int:
    return _enqueue("reducescatter", tensor, inplace=False, name=name,
                    average=average, op=op, process_set=process_set)


def reducescatter(tensor, average=None, name: Optional[str] = None,
                  op=None, process_set=None) -> torch.Tensor:
    """Reduce across ranks, split dim 0: this rank's chunk (op in
    {Average, Sum})."""
    return synchronize(reducescatter_async(tensor, average, name, op,
                                           process_set))


# -- high-level glue --------------------------------------------------------

_BROADCAST_DTYPES = (torch.int32, torch.int64, torch.uint8, torch.int8,
                     torch.int16, torch.bool)


def broadcast_parameters(params, root_rank: int = 0) -> None:
    """Sync a ``state_dict`` or an iterable of ``(name, tensor)`` from
    ``root_rank`` in place: every broadcast started, then synchronized
    (≙ torch/__init__.py:125-152)."""
    items = sorted(params.items()) if isinstance(params, dict) \
        else list(params)
    handles = [broadcast_async_(p, root_rank, name=f"broadcast.{name}")
               for name, p in items
               if torch.is_tensor(p) and (torch.is_floating_point(p)
                                          or p.dtype in _BROADCAST_DTYPES)]
    for h in handles:
        synchronize(h)


def broadcast_optimizer_state(optimizer, root_rank: int = 0) -> None:
    """Sync an optimizer's whole ``state_dict`` from ``root_rank`` as one
    ``broadcast_object`` (the reference's design: no lazy-state special
    case; it runs once at start or restore)."""
    inner = optimizer._inner if isinstance(optimizer, _DistributedOptimizer) \
        else optimizer
    sd = broadcast_object(inner.state_dict(), root_rank=root_rank,
                          name="broadcast.optimizer.state")
    inner.load_state_dict(sd)


class _DistributedOptimizer:
    """Wraps a torch optimizer: a post-accumulate-grad hook per parameter
    fires ``allreduce_async_`` on its gradient during backward; ``step``
    synchronizes them, then steps the wrapped optimizer.  The rest of the
    Optimizer surface is the wrapped one's."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 named_parameters: Optional[Iterable] = None,
                 average: bool = True, compression=None):
        self._inner = optimizer
        self._average = average
        self._compression = compression
        if named_parameters is not None:
            named = list(named_parameters)
        else:
            named = [(f"allreduce.noname.{i}.{j}", p)
                     for i, group in enumerate(optimizer.param_groups)
                     for j, p in enumerate(group["params"])]
        self._param_names = {p: name for name, p in named}
        self._handles: Dict[torch.Tensor, int] = {}
        # The hook holds the optimizer weakly: a parameter's hooks live in
        # autograd's C++ metadata, which the garbage collector does not
        # traverse, so a bound method there would keep this optimizer,
        # its parameters, gradients and state alive after the last user
        # reference is gone (the observe phase's live-tensor sweep showed
        # a dropped GPT-2-small run's 1.09 GB still held).
        ref = weakref.WeakMethod(self._hook)

        def hook(p: torch.Tensor) -> None:
            fn = ref()
            if fn is not None:
                fn(p)

        self._hook_handles = [
            p.register_post_accumulate_grad_hook(hook)
            for group in optimizer.param_groups for p in group["params"]
            if p.requires_grad]

    def __getattr__(self, item):
        return getattr(self.__dict__["_inner"], item)

    def __del__(self) -> None:
        for h in self.__dict__.get("_hook_handles", ()):
            h.remove()

    @property
    def param_groups(self):
        return self._inner.param_groups

    @property
    def state(self):
        return self._inner.state

    def _hook(self, p: torch.Tensor) -> None:
        if p.grad is None:
            return
        name = self._param_names.get(p, f"allreduce.noname.{id(p)}")
        self._handles[p] = allreduce_async_(
            p.grad, average=self._average, name=f"grad.{name}",
            compression=self._compression)

    def synchronize(self) -> None:
        handles, self._handles = self._handles, {}
        for handle in handles.values():
            synchronize(handle)

    def step(self, closure=None):
        self.synchronize()
        return self._inner.step(closure)

    def zero_grad(self, set_to_none: bool = True):
        return self._inner.zero_grad(set_to_none=set_to_none)

    def state_dict(self):
        return self._inner.state_dict()

    def load_state_dict(self, sd):
        return self._inner.load_state_dict(sd)


def DistributedOptimizer(optimizer: torch.optim.Optimizer,
                         named_parameters: Optional[Iterable] = None,
                         average: bool = True,
                         compression=None) -> _DistributedOptimizer:
    """Distributed wrapper for any ``torch.optim.Optimizer``
    (≙ hvd.DistributedOptimizer, torch/__init__.py:90-122)."""
    return _DistributedOptimizer(optimizer, named_parameters, average,
                                 compression)
