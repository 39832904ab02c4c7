"""Collectives over one mesh axis, with the backward each needs.

The counterparts of ``jax.lax.psum``, ``all_gather(tiled=True)``,
``psum_scatter(tiled=True)``, ``all_to_all(tiled=True)`` and
``ppermute`` inside the reference's ``shard_map``.  Each takes the axis
as a :class:`~..core.topology.MeshAxis` (its group, size and this rank's
index) and runs on ``torch.distributed``.  Over an axis of one rank each
is the identity and issues nothing, as XLA drops a collective over a
size-1 axis.

**The gradient convention** (the one every parallel module and
:func:`..parallel.training.make_parallel_train_step` keep).  Parameters
are stored whole on every rank and sliced in the forward, as in the
reference.  Then:

* every collective's backward is its linear transpose over the whole
  job: ``psum`` -> ``psum``, ``all_gather`` -> ``psum_scatter``,
  ``psum_scatter`` -> ``all_gather``, ``all_to_all`` -> the inverse
  ``all_to_all``, ``ppermute`` -> the inverse ``ppermute``;
* the loss is averaged over the mesh by :func:`pmean_loss`, whose
  backward hands each rank ``1/n`` of the cotangent (every rank's copy
  of the replicated loss counts once);
* the step sums every parameter's gradient over the whole mesh.

Each rank's gradient is then its part of d(global loss)/d(its copy of
the parameters), and the sum over copies is the exact gradient of the
global loss, for replicated and sharded leaves alike: what ``jax.grad``
of the reference's ``shard_map`` gives (reference
``tests/test_transformer.py:127``).  ``tests/test_torch_*parallel*.py``
hold it on meshes of 2 and 4 gloo ranks.  (A psum with an identity
backward, or ``torch.distributed.nn``'s all_reduce with a summed one
and no 1/n seed, would count a loss replicated over ``model`` ranks
``mp`` times.)

``async_op=True`` (psum, psum_scatter, all_to_all) returns a
:class:`Pending` whose :func:`wait` gives the tensor: the chunked
closers of :mod:`..ops.fused` put several in flight at once.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.distributed as dist

# torch 2.13 renamed these; older releases have only the old names.
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single",
                                 dist.reduce_scatter_tensor)


class Pending:
    """Collectives in flight (``works``) and what gives their result once
    they are done (``finish``)."""

    def __init__(self, works: List, finish: Callable[[], torch.Tensor]):
        self.works = works
        self.finish = finish


def wait(x):
    """The result of a :class:`Pending` once its collectives are done; a
    tensor is returned as it is."""
    if isinstance(x, Pending):
        for work in x.works:
            work.wait()
        return x.finish()
    return x


def _issue(work, works: Optional[list]):
    if works is None:
        if work is not None:
            work.wait()
    else:
        works.append(work)


# ---------------------------------------------------------------------------
# Plain collectives (no autograd), each writing a fresh output
# ---------------------------------------------------------------------------

def _psum(x, axis, works=None):
    out = x.contiguous().clone()
    _issue(dist.all_reduce(out, group=axis.group, async_op=True), works)
    return out


def _all_gather(x, axis, dim, works=None):
    """Concatenation along ``dim`` in rank order."""
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((axis.size * front.shape[0],) + front.shape[1:])
    _issue(_all_gather_single(out, front, group=axis.group, async_op=True),
           works)
    return out.movedim(0, dim)


def _psum_scatter(x, axis, dim, works=None):
    """Rank ``i`` keeps slice ``i`` of the sum along ``dim``."""
    if x.shape[dim] % axis.size:
        raise ValueError(f"psum_scatter: dimension {dim} of size "
                         f"{x.shape[dim]} does not divide over the "
                         f"'{axis.name}' axis of {axis.size}")
    front = x.movedim(dim, 0).contiguous()
    out = front.new_empty((front.shape[0] // axis.size,) + front.shape[1:])
    _issue(_reduce_scatter_single(out, front, op=dist.ReduceOp.SUM,
                                  group=axis.group, async_op=True), works)
    return out.movedim(0, dim)


def _all_to_all(x, axis, split_axis, concat_axis, works=None):
    """Slice ``j`` of ``split_axis`` goes to rank ``j``; what arrives is
    concatenated along ``concat_axis`` in source-rank order
    (``jax.lax.all_to_all(..., tiled=True)``).  ``all_to_all_single``
    exchanges along dim 0, so ``split_axis`` moves to the front as
    ``[n, chunk, ...]`` and the received ``[n, ...]`` source blocks are
    laid along ``concat_axis``."""
    n = axis.size
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: split axis {split_axis} of size "
                         f"{x.shape[split_axis]} does not divide over the "
                         f"'{axis.name}' axis of {n}")
    front = x.movedim(split_axis, 0).contiguous()
    out = torch.empty_like(front)
    _issue(dist.all_to_all_single(out, front, group=axis.group,
                                  async_op=True), works)
    return _Arrived(out, n, split_axis, concat_axis)


class _Arrived:
    """The received buffer of :func:`_all_to_all`, laid out once the
    exchange is done (:meth:`layout`)."""

    def __init__(self, buf, n, split_axis, concat_axis):
        self.buf, self.n = buf, n
        self.split_axis, self.concat_axis = split_axis, concat_axis

    def layout(self) -> torch.Tensor:
        n, s, c = self.n, self.split_axis, self.concat_axis
        # buf: [n * chunk, rest...] with source rank major; the rest is
        # the input's other axes in order, split_axis removed.
        blocks = self.buf.reshape((n, self.buf.shape[0] // n)
                                  + tuple(self.buf.shape[1:]))
        # Back to the input's axis order with the source axis in front:
        # [n, ..., chunk at s, ...].
        blocks = blocks.movedim(1, s + 1)
        # Merge the source axis into concat_axis (source-rank major).
        blocks = blocks.movedim(0, c)
        shape = list(blocks.shape)
        merged = shape[:c] + [shape[c] * shape[c + 1]] + shape[c + 2:]
        return blocks.reshape(merged)


def _ppermute(tensors, axis, shift, works=None):
    """Each tensor of this rank goes to coordinate ``index + shift`` and
    this rank receives from ``index - shift`` (mod the axis size), by one
    ``batch_isend_irecv`` on the axis's group."""
    n = axis.size
    dst = axis.ranks[(axis.index + shift) % n]
    src = axis.ranks[(axis.index - shift) % n]
    tensors = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t, dst, axis.group))
        ops.append(dist.P2POp(dist.irecv, o, src, axis.group))
    for work in dist.batch_isend_irecv(ops):
        _issue(work, works)
    return outs


# ---------------------------------------------------------------------------
# Differentiable forms
# ---------------------------------------------------------------------------

class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, works):
        ctx.axis = axis
        return _psum(x, axis, works)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, ctx.axis, ctx.dim), None, None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, works):
        ctx.axis, ctx.dim = axis, dim
        return _psum_scatter(x, axis, dim, works)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    """Forward on an exchange already done (``_Arrived``): lays it out;
    backward is the inverse all_to_all."""

    @staticmethod
    def forward(ctx, x, arrived, axis, split_axis, concat_axis):
        ctx.axis, ctx.split, ctx.concat = axis, split_axis, concat_axis
        return arrived.layout()

    @staticmethod
    def backward(ctx, g):
        back = _all_to_all(g, ctx.axis, ctx.concat, ctx.split)
        return back.layout(), None, None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _ppermute([x], axis, shift)[0]

    @staticmethod
    def backward(ctx, g):
        return _ppermute([g], ctx.axis, -ctx.shift)[0], None, None


def psum(x, axis, *, async_op: bool = False):
    """Every rank of ``axis`` gets the sum; backward is ``psum``."""
    if axis.size == 1:
        return x
    works = [] if async_op else None
    out = _PSum.apply(x, axis, works)
    return Pending(works, lambda: out) if async_op else out


def all_gather(x, axis, *, dim: int = 0):
    """Tiled ``all_gather``: ``x`` concatenated along ``dim`` in rank
    order (``jax.lax.all_gather(axis=dim, tiled=True)``); backward is
    ``psum_scatter``."""
    if axis.size == 1:
        return x
    return _AllGather.apply(x, axis, dim % x.dim())


def psum_scatter(x, axis, *, scatter_dimension: int = 0,
                 async_op: bool = False):
    """Tiled ``psum_scatter``: rank ``i`` keeps slice ``i`` of the sum
    along ``scatter_dimension``; backward is ``all_gather``."""
    if axis.size == 1:
        return x
    works = [] if async_op else None
    out = _PSumScatter.apply(x, axis, scatter_dimension % x.dim(), works)
    return Pending(works, lambda: out) if async_op else out


def all_to_all(x, axis, *, split_axis: int, concat_axis: int,
               async_op: bool = False):
    """Tiled ``all_to_all`` (see :func:`_all_to_all`); backward is the
    inverse exchange (``split_axis`` and ``concat_axis`` swapped)."""
    if axis.size == 1:
        return x
    split_axis, concat_axis = split_axis % x.dim(), concat_axis % x.dim()
    works = [] if async_op else None
    arrived = _all_to_all(x.detach(), axis, split_axis, concat_axis, works)

    def finish():
        return _AllToAll.apply(x, arrived, axis, split_axis, concat_axis)

    return Pending(works, finish) if async_op else finish()


def ppermute(x, axis, *, shift: int = 1):
    """Rotate along ``axis``: this rank's ``x`` goes to ``index + shift``;
    backward rotates back.  Over one rank, the identity (no P2P)."""
    if axis.size == 1:
        return x
    return _PPermute.apply(x, axis, shift)


class _PMeanLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n):
        ctx.n = n
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


def pmean_loss(loss, mesh):
    """The loss averaged over every rank of ``mesh`` (reference
    ``jax.lax.pmean(loss, axes)``), whose backward gives each rank
    ``1/n`` of the cotangent (see the module docstring)."""
    if mesh is None or mesh.size == 1:
        return loss
    return _PMeanLoss.apply(loss, mesh.group, mesh.size)


def sum_in_place(tensors, group) -> None:
    """Each tensor summed over ``group``, in place: one all_reduce per
    dtype, all in flight before any is waited on."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    pending = []
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        pending.append((ts, flat, dist.all_reduce(flat, group=group,
                                                  async_op=True)))
    for ts, flat, work in pending:
        work.wait()
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def reduce_gradients(leaves, mesh) -> None:
    """Sum each leaf's ``.grad`` over every rank of ``mesh``, in place:
    the step's one gradient reduction (see the module docstring)."""
    if mesh is None or mesh.size == 1:
        return
    sum_in_place([p.grad for p in leaves if p.grad is not None], mesh.group)
