"""The data-parallel train and eval steps (port of the monolithic path of
horovod_tpu/parallel/training.py:291-423 and :472-523).

One step is forward, backward, the bucketed gradient allreduce, the
optimizer's update, and the loss averaged over ranks; the stateful step
also averages the model's new non-trained state (BatchNorm statistics)
over ranks.  PyTorch runs eagerly, so a step is a plain function; the
parameters are updated in place by the optimizer.  The overlapped
schedules and the multi-axis (tensor/sequence/pipeline/expert) step are
later work.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..core import state as _state
from ..ops import collective as C
from ..utils.tree import tree_leaves, tree_map
from .data import DistributedOptimizer, allreduce_gradients
from .input import device_put_batch


def _distributed(optimizer, average, fusion_threshold, op):
    if isinstance(optimizer, DistributedOptimizer):
        return optimizer
    return DistributedOptimizer(optimizer, average=average,
                                fusion_threshold=fusion_threshold, op=op)


def make_train_step(loss_fn: Callable[..., torch.Tensor], optimizer,
                    average: bool = True,
                    fusion_threshold: Optional[int] = None, op=None):
    """Build the data-parallel train step.

    Args:
      loss_fn: ``loss_fn(params, batch) -> scalar`` on this rank's batch.
      optimizer: a :class:`DistributedOptimizer`, or a
        ``torch.optim.Optimizer`` over the parameter leaves, which is
        wrapped in one with ``average``, ``fusion_threshold`` and ``op``
        (as for :func:`~.data.allreduce_gradients`).

    Returns:
      ``step(params, batch) -> loss``: the loss averaged over ranks, as a
      tensor (reading it waits for the device).
    """
    optimizer = _distributed(optimizer, average, fusion_threshold, op)

    def step(params, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch)
        loss.backward()
        optimizer.step()  # the bucketed allreduce, then the update
        return C.allreduce(loss.detach(), average=True, name="train.loss")

    return step


def make_train_step_with_state(loss_fn: Callable[..., Any], optimizer,
                               average: bool = True,
                               fusion_threshold: Optional[int] = None,
                               op=None):
    """Train step for models with non-trained state (BatchNorm statistics):
    ``loss_fn(params, model_state, batch) -> (loss, new_state)`` on this
    rank's batch.  The new state is averaged over ranks every step
    (synchronized BatchNorm statistics, reference :316-318) by the same
    fused bucket allreduce as the gradients; ``optimizer`` as in
    :func:`make_train_step`.

    Returns ``step(params, model_state, batch) -> (new_state, loss)``,
    the loss averaged over ranks; the parameters are updated in place.
    """
    optimizer = _distributed(optimizer, average, fusion_threshold, op)

    def step(params, model_state, batch):
        optimizer.zero_grad(set_to_none=True)
        loss, new_state = loss_fn(params, model_state, batch)
        loss.backward()
        optimizer.step()
        new_state = allreduce_gradients(new_state, average=True,
                                        fusion_threshold=fusion_threshold)
        return new_state, C.allreduce(loss.detach(), average=True,
                                      name="train.loss")

    return step


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

