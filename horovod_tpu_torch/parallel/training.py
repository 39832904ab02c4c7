"""The data-parallel train and eval steps (port of the monolithic path of
horovod_tpu/parallel/training.py:291-423 and :472-523).

One step is forward, backward, the bucketed gradient allreduce, the
optimizer's update, and the loss averaged over ranks; the stateful step
also averages the model's new non-trained state (BatchNorm statistics)
over ranks.  PyTorch runs eagerly, so a step is a plain function; the
parameters are updated in place by the optimizer.

:func:`make_parallel_train_step` (reference :423-461) is the multi-axis
step (data, tensor, sequence, pipeline and expert parallelism over a
:class:`~..core.topology.Mesh`), with :func:`shard_parallel_batch`.
The per-stage pipeline step, ZeRO and FSDP are :mod:`.pipeline`,
:mod:`.zero` and :mod:`.fsdp`.

``make_train_step(..., overlap=)`` and ``make_train_step_with_state(...,
overlap=)`` (or ``HVD_TPU_OVERLAP``) select the schedule: ``off`` is the
monolithic step below; ``on`` and ``serial`` build the bucketed-backward
step of :mod:`.overlap`, whose gradient buckets ride the negotiated
collectives (reference :240-290).  ``make_train_step(..., has_aux=True)``
also returns the loss's aux, averaged over ranks.

The gradients take one of two paths.  :class:`.data.DistributedOptimizer`
reduces them after the backward pass with direct ``torch.distributed``
calls on the job's group (the reference's compiled, un-negotiated path).
The hook-driven ``frontends.torch.DistributedOptimizer`` reduces each
gradient as backward produces it, through the negotiated collectives on
their own group.  The loss and metric averages are negotiated
collectives either way.  Rule: a caller does not keep negotiated async
ops in flight across a monolithic step (the two groups' kernels must not
interleave in different orders on different ranks).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from .. import trace as _trace
from ..core import state as _state
from ..memory import ledger as _mem
from ..memory import oom as _oom
from ..ops import collective as C
from . import axis_ops
from ..utils.tree import tree_leaves, tree_map
from .data import DistributedOptimizer, allreduce_gradients
from .input import device_put_batch


def _hook_optimizer():
    from ..frontends.torch import _DistributedOptimizer

    return _DistributedOptimizer


def _distributed(optimizer, average, fusion_threshold, op):
    if isinstance(optimizer, (DistributedOptimizer, _hook_optimizer())):
        return optimizer
    return DistributedOptimizer(optimizer, average=average,
                                fusion_threshold=fusion_threshold, op=op)


def _schedule(overlap, optimizer, loss_fn) -> str:
    """The step's schedule (:func:`.overlap.resolve_mode`).  The
    hook-driven optimizer overlaps from its hooks already: it takes the
    monolithic step, and an explicit ``on``/``serial`` with it is an
    error."""
    from . import overlap as _overlap

    schedule = _overlap.resolve_mode(overlap, _state.device(),
                                     _state.size(), loss_fn)
    if isinstance(optimizer, _hook_optimizer()):
        if overlap is not None and schedule != "off":
            raise ValueError(
                f"overlap={overlap!r} needs a DistributedOptimizer from "
                f"parallel.data; the hook-driven optimizer reduces each "
                f"gradient from its hook during backward already")
        schedule = "off"
    return schedule


def _average_extra(tree, fusion_threshold: Optional[int] = None):
    """A step's extra output (``has_aux``'s aux, the stateful step's new
    BatchNorm statistics) averaged over ranks: the reference's ``pmean``,
    as one fused allreduce a bucket (:func:`~.data.allreduce_gradients`).
    The monolithic and the overlapped forms both call it, after the
    update and before the loss's average."""
    return allreduce_gradients(
        tree_map(lambda x: x.detach() if isinstance(x, torch.Tensor) else x,
                 tree),
        average=True, fusion_threshold=fusion_threshold)


def _make_step(loss_fn, optimizer, average, fusion_threshold, op, overlap,
               has_aux: bool, has_state: bool):
    """The builder behind :func:`make_train_step` and
    :func:`make_train_step_with_state` (reference :240-290): the
    monolithic step, or the overlapped step of the same kind, which
    falls back to it for what it cannot bucket."""
    from . import overlap as _overlap

    optimizer = _distributed(optimizer, average, fusion_threshold, op)
    schedule = _schedule(overlap, optimizer, loss_fn)

    def finish(loss, extra):
        if extra is not None:
            extra = _average_extra(extra, fusion_threshold)
        loss = C.allreduce(loss.detach(), average=True, name="train.loss")
        if has_state:
            return extra, loss
        return (loss, extra) if has_aux else loss

    def step(params, *rest):
        optimizer.zero_grad(set_to_none=True)
        out = loss_fn(params, *rest)
        loss, extra = out if (has_aux or has_state) else (out, None)
        loss.backward()
        optimizer.step()  # the gradients' allreduce, then the update
        return finish(loss, extra)

    if schedule == "off":
        return _traced(step)
    return _traced(_overlap.make_overlapped_step(
        loss_fn, optimizer, stream=schedule == "stream",
        fallback_builder=lambda: step, finish=finish, has_aux=has_aux,
        has_state=has_state))


def make_train_step(loss_fn: Callable[..., Any], optimizer,
                    average: bool = True,
                    fusion_threshold: Optional[int] = None, op=None,
                    overlap: Optional[str] = None, has_aux: bool = False):
    """Build the data-parallel train step.

    Args:
      loss_fn: ``loss_fn(params, batch) -> scalar`` on this rank's batch
        (``-> (scalar, aux)`` with ``has_aux``), or a
        :class:`.overlap.ChainedLoss` (``params`` then one tree per
        stage), whose stages the overlapped step streams buckets out of.
      optimizer: a :class:`DistributedOptimizer`, the hook-driven
        ``frontends.torch.DistributedOptimizer``, or a
        ``torch.optim.Optimizer`` over the parameter leaves, which is
        wrapped in one with ``average``, ``fusion_threshold`` and ``op``
        (as for :func:`~.data.allreduce_gradients`).
      overlap: ``"on"``, ``"serial"``, ``"off"`` or ``"auto"``; default
        ``HVD_TPU_OVERLAP`` (see :mod:`.overlap`).  The hook-driven
        optimizer overlaps from its hooks already: it takes the
        monolithic step, and an explicit ``on``/``serial`` with it is an
        error.
      has_aux: ``loss_fn`` returns ``(loss, aux)``, ``aux`` a tree of
        tensors, which the step averages over ranks
        (:func:`_average_extra`; a ``ChainedLoss`` with aux is not
        segmented, as in the reference).

    Returns:
      ``step(params, batch) -> loss`` (``-> (loss, aux)`` with
      ``has_aux``): the loss averaged over ranks, as a tensor (reading it
      waits for the device).  The overlapped step also has ``stats()``,
      ``bucket_count`` and ``overlap_active``.
    """
    return _make_step(loss_fn, optimizer, average, fusion_threshold, op,
                      overlap, has_aux=has_aux, has_state=False)


class _TracedStep:
    """Per-step bookkeeping wrapper (reference parallel/training.py:
    189-234): advance the hvd-trace step id, so every span carries the
    step that owns it; close the memory ledger's step window; and, on the
    first call, warn when the working set this step implies (params +
    gradients + two optimizer slots + the batch) exceeds the advertised
    capacity (memory/oom.py).  Arithmetic is untouched; attributes pass
    through to the wrapped step (``stats()`` and the rest)."""

    def __init__(self, step_fn):
        self._step_fn = step_fn
        self._preflighted = False

    def _preflight(self, args) -> None:
        self._preflighted = True
        if _oom.advertised_capacity() is None or not args:
            return
        try:
            params_b = _mem.tree_nbytes(args[0])
            batch_b = _mem.tree_nbytes(args[-1]) if len(args) > 1 else 0
            _oom.preflight_warn(
                4 * params_b + batch_b, "make_train_step",
                f"params {params_b} B x (1 grad + 2 opt slots) + "
                f"batch {batch_b} B")
        except Exception:  # noqa: BLE001 — sizing is observability
            pass

    def __call__(self, *args, **kw):
        if _trace.trace_enabled_env():
            _trace.on_step()
        if not self._preflighted:
            self._preflight(args)
        out = self._step_fn(*args, **kw)
        if _mem.enabled():
            _mem.ledger.note_step()
        return out

    def __getattr__(self, name):
        return getattr(self._step_fn, name)


def _traced(step_fn):
    return _TracedStep(step_fn)


def make_train_step_with_state(loss_fn: Callable[..., Any], optimizer,
                               average: bool = True,
                               fusion_threshold: Optional[int] = None,
                               op=None, overlap: Optional[str] = None):
    """Train step for models with non-trained state (BatchNorm statistics):
    ``loss_fn(params, model_state, batch) -> (loss, new_state)`` on this
    rank's batch.  The new state is averaged over ranks every step
    (synchronized BatchNorm statistics, reference :316-318) by a fused
    allreduce a bucket (:func:`_average_extra`); ``optimizer`` and
    ``overlap`` as in :func:`make_train_step`.  ``on`` and ``serial``
    run one backward, then the gradient buckets (reference :398-420);
    ``auto`` is ``off``, since the loss is not a ``ChainedLoss``.

    Returns ``step(params, model_state, batch) -> (new_state, loss)``,
    the loss averaged over ranks; the parameters are updated in place.
    """
    return _make_step(loss_fn, optimizer, average, fusion_threshold, op,
                      overlap, has_aux=False, has_state=True)


def make_eval_step(metric_fn: Callable[..., Any]):
    """Eval step: ``metric_fn(params, batch)`` (a tree of tensors) on this
    rank's batch without gradients, each metric averaged over ranks
    (≙ MetricAverageCallback's allreduce, reference :509).  A model with
    state evaluates with ``train=False``, on its running statistics."""

    def eval_step(params, batch):
        with torch.no_grad():
            metrics = metric_fn(params, batch)
        return tree_map(lambda m: C.allreduce(m, average=True,
                                              name="eval.metric"), metrics)

    return eval_step


def shard_batch(batch, device=None):
    """This rank's rows of a global batch, on ``device`` (default: the
    device ``init`` bound) — the per-rank data split the reference gets
    from sharding the batch over the replica axis (reference :63)."""
    return device_put_batch(batch, device)


def shard_local_batch(local_batch, device=None):
    """The reference's input model, where each rank loads only its own
    rows (reference :84): move them to ``device``.  Every rank must pass
    the same number of rows, or the averaged gradient would weight the
    ranks unequally; one allgather of the counts checks it and raises on
    every rank alike."""
    dev = torch.device(device) if device is not None else _state.device()
    leaves = [torch.as_tensor(x) for x in tree_leaves(local_batch)]
    if not leaves:
        return local_batch
    rows = C.allgather(torch.tensor([leaves[0].shape[0]]))
    if len(set(rows.tolist())) > 1:
        raise ValueError(f"shard_local_batch: ranks passed different row "
                         f"counts {rows.tolist()}; every rank must pass the "
                         f"same number (drop or pad the dataset tail)")
    return tree_map(lambda x: torch.as_tensor(x).to(dev), local_batch)


def barrier_fence(*trees) -> None:
    """Block the host until device work completes (reference :472).

    * ``barrier_fence(tree, ...)``: wait for the current stream of every
      CUDA device holding a leaf of the given trees (the stream the
      leaves were computed on).
    * ``barrier_fence()``: wait for every stream of the device ``init``
      bound.

    Host-side only: no collective (unlike ``barrier()``, which
    synchronizes ranks).  On the CPU there is nothing to wait for.
    """
    if trees:
        devices = {leaf.device for leaf in tree_leaves(list(trees))
                   if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        return
    dev = _state.device() if _state.is_initialized() else None
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)



def make_parallel_train_step(loss_fn: Callable[..., torch.Tensor],
                             optimizer: torch.optim.Optimizer, mesh,
                             batch_spec):
    """The multi-axis train step (reference :423).

    ``loss_fn(params, batch)`` is a loss on this rank's shard of the
    batch that averages itself over the mesh (``models.transformer.
    make_loss_fn(cfg, ax, mesh)``).  The step runs forward and backward,
    sums every gradient over the whole mesh (the gradient convention of
    :mod:`.axis_ops`: the sum is the exact gradient of the global loss
    on every rank) and calls ``optimizer.step()``, a plain
    ``torch.optim`` optimizer over the parameter leaves.

    Returns ``step(params, batch) -> loss``: ``batch`` is the global
    batch (the same on every rank, on the host or the device), of which
    the step takes this rank's shard by ``batch_spec``
    (:func:`shard_parallel_batch`); the loss is the global loss.  The
    reference's buffer donation and its CPU throttle serve XLA only.
    """
    from .data import DistributedOptimizer

    if isinstance(optimizer, (DistributedOptimizer, _hook_optimizer())):
        raise TypeError(
            "make_parallel_train_step reduces the gradients over the mesh "
            "itself; pass the plain torch.optim optimizer, not a "
            "DistributedOptimizer")
    leaves = [p for group in optimizer.param_groups for p in group["params"]]

    def step(params, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, shard_parallel_batch(batch, mesh, batch_spec))
        loss.backward()
        axis_ops.reduce_gradients(leaves, mesh)
        optimizer.step()
        return loss.detach()

    return step


def shard_parallel_batch(batch, mesh, batch_spec):
    """This rank's shard of a global batch, on the device ``init`` bound
    (where the batch is, before ``init``).

    ``batch_spec`` gives each dimension of every leaf the mesh axis it
    is split over, or None (reference ``PartitionSpec``): e.g.
    ``("data", None)`` or ``("data", "seq")``; a tuple of axis names
    splits one dimension over several axes, the first outermost.  Shard
    ``i`` of a dimension is its ``i``-th equal block, so a sequence is
    sharded shard-major as ring attention expects."""
    device = _state.device() if _state.is_initialized() else None

    def shard(x):
        x = torch.as_tensor(x)
        for dim, names in enumerate(batch_spec):
            if names is None:
                continue
            names = (names,) if isinstance(names, str) else tuple(names)
            n, idx = 1, 0
            for name in names:
                ax = mesh.axis(name)
                n, idx = n * ax.size, idx * ax.size + ax.index
            if x.shape[dim] % n:
                raise ValueError(
                    f"batch dimension {dim} of size {x.shape[dim]} does not "
                    f"divide over mesh axes {names} ({n} shards)")
            size = x.shape[dim] // n
            x = x.narrow(dim, idx * size, size)
        return x if device is None else x.to(device)

    return tree_map(shard, batch)
