"""Data-parallel training glue: Tensor Fusion, DistributedOptimizer and
parameter broadcast (port of horovod_tpu/parallel/data.py).

Gradients are reduced after the backward pass, bucket by bucket: grouped
by dtype in first-appearance order, packed greedily up to
``HOROVOD_FUSION_THRESHOLD`` bytes (default 64 MB), one flat buffer and one
allreduce per bucket.  Leaves come in the reference's pytree order
(:mod:`..utils.tree`), so the bucket plans equal the reference's exactly.

This module is the port of the reference's compiled, un-negotiated path:
its collectives are direct ``torch.distributed`` calls on the job's
group, every rank issuing them in the same order.  The hook-driven
optimizer that overlaps the reduction with the backward pass rides the
negotiated collectives instead (:mod:`..frontends.torch`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..core import state as _state
from ..ops.compression import NoneCompressor
from ..ops.wire import ReduceOp
from ..utils.tree import tree_flatten, tree_unflatten


def _resolve_grad_op(average: bool, op) -> ReduceOp:
    """``op`` supersedes ``average``; gradients take Average or Sum."""
    red = (ReduceOp.AVERAGE if average else ReduceOp.SUM) if op is None \
        else ReduceOp(op)
    if red == ReduceOp.ADASUM:
        raise NotImplementedError(
            "op=Adasum is not in this slice of the port (ROADMAP.md A.6)")
    if red not in (ReduceOp.AVERAGE, ReduceOp.SUM):
        raise ValueError(
            f"gradient reduction supports op=Average/Sum/Adasum; got "
            f"{red.name.lower()} (min/max/product are not gradient "
            f"combiners).")
    return red


def partition_fusion_buckets(leaves, threshold: int):
    """Greedy Tensor-Fusion partition of a flat leaf list: the reference's
    rule exactly (horovod_tpu/parallel/data.py:83).

    Group by dtype in first-appearance order, then pack each dtype's
    leaves, in order, into buckets of at most ``threshold`` bytes (a leaf
    bigger than the threshold forms its own bucket; a threshold <= 0 gives
    one bucket per leaf).  ``leaves`` are anything with ``shape`` and a
    ``dtype`` that has ``itemsize``.  Returns index lists covering every
    leaf once.
    """
    by_dtype: dict = {}
    for i, g in enumerate(leaves):
        by_dtype.setdefault(g.dtype, []).append(i)
    buckets: list = []
    for dtype, idxs in by_dtype.items():
        bucket: list = []
        bucket_bytes = 0
        for i in idxs:
            nbytes = dtype.itemsize
            for n in leaves[i].shape:
                nbytes *= int(n)
            if threshold <= 0 or (bucket
                                  and bucket_bytes + nbytes > threshold):
                if bucket:
                    buckets.append(bucket)
                bucket, bucket_bytes = [], 0
            bucket.append(i)
            bucket_bytes += nbytes
        if bucket:
            buckets.append(bucket)
    return buckets


def allreduce_gradients(grads, average: bool = True,
                        fusion_threshold: Optional[int] = None,
                        compression=None, op=None):
    """Reduce a pytree of gradients across ranks with Tensor Fusion.

    Each bucket is packed into one flat buffer, reduced by one allreduce
    (all started before any is waited for), and unpacked.  ``compression``
    casts the wire buffers down and restores the dtype after; with
    Average the division follows the decompress, in the restored dtype
    (reference :237-241).  The inputs are not modified.
    """
    _state._check_initialized()
    red = _resolve_grad_op(average, op)
    compression = compression or NoneCompressor
    threshold = (_state.fusion_threshold_bytes() if fusion_threshold is None
                 else fusion_threshold)
    leaves, spec = tree_flatten(grads)
    if any(g.is_sparse for g in leaves):
        raise NotImplementedError(
            "sparse gradients are not in this slice of the port "
            "(ROADMAP.md A.2)")
    wire, ctxs = zip(*(compression.compress(g) for g in leaves)) \
        if leaves else ((), ())
    pending = []
    for bucket in partition_fusion_buckets(wire, threshold):
        flat = torch.cat([wire[i].reshape(-1) for i in bucket])
        pending.append((bucket, flat, dist.all_reduce(flat, async_op=True)))
    out = [None] * len(leaves)
    for bucket, flat, work in pending:
        work.wait()
        off = 0
        for i in bucket:
            n = wire[i].numel()
            out[i] = flat[off:off + n].view(wire[i].shape)
            off += n
    n_ranks = _state.size()
    out = [compression.decompress(o, ctx) for o, ctx in zip(out, ctxs)]
    if red == ReduceOp.AVERAGE:
        out = [o / n_ranks for o in out]
    return tree_unflatten(spec, out)


class DistributedOptimizer:
    """Wrap a ``torch.optim.Optimizer`` so that ``step()`` first reduces
    every parameter's ``.grad`` across ranks (one fused allreduce per
    bucket), then steps the inner optimizer.  Other attributes
    (``zero_grad``, ``param_groups``, ``state_dict``...) are the inner
    optimizer's.

    Build the inner optimizer over ``tree_leaves(params)`` so that its
    parameter order, and so the bucket plan, is the reference's.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, average: bool = True,
                 fusion_threshold: Optional[int] = None, compression=None,
                 op=None):
        self._inner = optimizer
        self._average = average
        self._op = None if op is None else _resolve_grad_op(average, op)
        self._fusion_threshold = fusion_threshold
        self._compression = compression

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _params(self):
        return [p for group in self._inner.param_groups
                for p in group["params"]]

    def synchronize(self) -> None:
        """Reduce every parameter's gradient in place of ``.grad``.  A
        parameter without a gradient contributes zeros, so that every rank
        reduces the same buckets."""
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        reduced = allreduce_gradients(
            grads, average=self._average,
            fusion_threshold=self._fusion_threshold,
            compression=self._compression, op=self._op)
        for p, g in zip(params, reduced):
            p.grad = g

    def step(self, closure=None):
        self.synchronize()
        return self._inner.step(closure)


def broadcast_parameters(params, root_rank: int = 0):
    """Copy ``root_rank``'s parameters into every rank's, in place (all
    broadcasts started, then waited for; reference :445).  ``params`` is a
    pytree of tensors; returns it.  Like :func:`allreduce_gradients`, a
    direct ``torch.distributed`` call on the job's group, not a negotiated
    collective."""
    _state._check_initialized()
    if not 0 <= root_rank < _state.size():
        raise ValueError(f"root_rank {root_rank} outside "
                         f"[0, {_state.size()}).")
    dev = _state.device()
    leaves, _ = tree_flatten(params)
    bufs = [leaf.detach().to(dev) for leaf in leaves]
    works = [dist.broadcast(b, src=root_rank, async_op=True) for b in bufs]
    with torch.no_grad():
        for leaf, buf, work in zip(leaves, bufs, works):
            work.wait()
            if buf.data_ptr() != leaf.data_ptr():
                leaf.copy_(buf)
    return params
