"""ZeRO-3 / FSDP-style data parallelism: parameters, gradients and
optimizer state sharded across ranks (port of
horovod_tpu/parallel/fsdp.py).

One rung past :mod:`.zero` (ZeRO-1), on the same flat layout
(:class:`.zero.FlatLayout`):

    between steps : each rank stores only its contiguous 1/N slice of the
                    flattened parameters, a leaf tensor its optimizer
                    owns, and 1/N of the optimizer state.
    in the step   : all_gather(parameter shards) -> one flat tensor that
                    requires grad -> the parameter tree as views of it
                    (``split`` and ``view``, no copies) -> forward and
                    backward write one flat gradient -> its
                    reduce-scatter (the transpose of the all-gather,
                    reference :199-203) -> each rank steps its slice.

The full parameter vector is gathered once a step and lives through the
forward and backward; the step drops it before it returns (nothing
keeps a reference to it), so between steps a rank holds 1/N of the
parameters and of Adam's moments.  The elementwise-optimizer
precondition and its probe are ZeRO-1's.

Usage::

    fstep = make_fsdp_train_step(loss_fn,
                                 lambda ps: torch.optim.AdamW(ps, lr=3e-4))
    p_shard, opt_state = fstep.init(params)   # then drop params
    for batch in data:
        p_shard, opt_state, loss = fstep.step(p_shard, opt_state, batch)
    params = fstep.full_params(p_shard)       # rank-0 checkpoint / eval
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..utils.tree import tree_flatten
from . import axis_ops
from .zero import (FlatLayout, ShardState, _check_elementwise, _grad,
                   _optimizer_factory, _pmean, _reduce_shard,
                   _state_or_raise, replica_axis)


class FsdpTrainStep(NamedTuple):
    """``init(params) -> (p_shard, opt_state)``, ``step(p_shard,
    opt_state, batch) -> (p_shard, opt_state, loss)`` (the stateful
    variant threads ``model_state`` after ``p_shard``),
    ``full_params(p_shard) -> params`` (the whole tree, for
    checkpointing and evaluation) and ``shard_params(params) -> p_shard``
    (re-shard a whole tree without touching the optimizer state:
    checkpoint restore, broadcast-then-reshard)."""

    init: Callable[[Any], Any]
    step: Callable[..., Any]
    full_params: Callable[[Any], Any]
    shard_params: Callable[[Any], Any]


def make_fsdp_train_step(
    loss_fn,
    optimizer,
    mesh=None,
    average: bool = True,
    compression=None,
    has_state: bool = False,
    validate_elementwise: bool = True,
) -> FsdpTrainStep:
    """Build a ZeRO-3/FSDP-style train step (reference :81).

    Args:
      loss_fn: ``loss_fn(params, batch) -> scalar`` on this rank's batch
        (or, with ``has_state=True``, ``loss_fn(params, model_state,
        batch) -> (scalar, new_model_state)``), with no reduction across
        ranks inside.
      optimizer, mesh, average, compression, validate_elementwise: as
        :func:`.zero.make_zero_train_step`.

    Returns:
      :class:`FsdpTrainStep`.  ``init`` takes the whole parameter tree
      and returns this rank's flat shard (a leaf tensor the optimizer
      owns) and a :class:`.zero.ShardState`; drop the original
      ``params`` afterwards, or the memory is never saved.  One builder
      serves one parameter structure (the layout is captured at
      ``init``).
    """
    optimizer_fn, average, compression = _optimizer_factory(
        optimizer, average, compression)
    if validate_elementwise:
        _check_elementwise(optimizer_fn, feature="FSDP",
                           api_name="make_fsdp_train_step")
    axis = replica_axis(mesh)
    n = axis.size
    captured: dict = {}

    def _capture_layout(params) -> FlatLayout:
        # One builder serves one parameter structure: a later tree with
        # the same element count but another leaf order would misalign
        # the sharded optimizer state, so any change fails here.
        layout = FlatLayout(params, n)
        if captured and captured["layout"].signature != layout.signature:
            raise ValueError(
                "make_fsdp_train_step: parameter pytree structure "
                "differs from the one captured at init() — the sharded "
                "optimizer state is laid out for the original flat "
                "ordering, so re-sharding a different structure would "
                "silently apply wrong per-element state.  Build a new "
                "step for a new model structure.")
        captured["layout"] = layout
        return layout

    def _layout() -> FlatLayout:
        if not captured:
            raise RuntimeError(
                "make_fsdp_train_step: call init(params) before "
                "step()/full_params() — the flat parameter layout is "
                "captured there")
        return captured["layout"]

    def init(params):
        layout = _capture_layout(params)
        _state_or_raise(optimizer_fn, layout.chunk, layout.dtype,
                        feature="FSDP", api_name="make_fsdp_train_step")
        p_shard = layout.shard(tree_flatten(params)[0], axis.index)
        p_shard.requires_grad_(True)
        return p_shard, ShardState(p_shard, optimizer_fn([p_shard]), axis)

    def shard_params(params) -> torch.Tensor:
        """Re-shard a whole parameter tree (the structure given to
        ``init``) without touching the optimizer state; ``step`` copies
        it into the optimizer's shard."""
        return _capture_layout(params).shard(tree_flatten(params)[0],
                                             axis.index)

    def _step(p_shard, model_state, opt_state, batch):
        layout = _layout()
        shard = opt_state.shard
        if p_shard is not shard:
            with torch.no_grad():
                shard.copy_(p_shard)
        # One all-gather gives the whole parameters for the step; the
        # tree is views of it, so backward writes one flat gradient.
        flat_p = axis_ops._all_gather(shard.detach(), axis, 0)
        flat_p.requires_grad_(True)
        params = layout.unravel(flat_p)
        if has_state:
            loss, model_state = loss_fn(params, model_state, batch)
        else:
            loss = loss_fn(params, batch)
        del params
        loss.backward()
        flat_g = _grad(flat_p)
        del flat_p
        g_shard = _reduce_shard(flat_g, axis, compression, average)
        del flat_g
        shard.grad = g_shard.to(shard.dtype)
        opt_state.optimizer.step()
        shard.grad = None
        loss = _pmean(loss, axis)
        if has_state:
            return shard, _pmean(model_state, axis), opt_state, loss
        return shard, opt_state, loss

    if has_state:
        step = _step
    else:
        def step(p_shard, opt_state, batch):
            return _step(p_shard, None, opt_state, batch)

    def full_params(p_shard):
        """The whole parameter tree (gathered, detached; the leaves are
        views of one buffer) — for rank-0 checkpointing or eval."""
        layout = _layout()
        return layout.unravel(axis_ops._all_gather(p_shard.detach(),
                                                   axis, 0))

    return FsdpTrainStep(init=init, step=step, full_params=full_params,
                         shard_params=shard_params)


def make_fsdp_train_step_with_state(loss_fn, optimizer, mesh=None,
                                    average: bool = True,
                                    compression=None,
                                    validate_elementwise: bool = True,
                                    ) -> FsdpTrainStep:
    """Stateful-model spelling (BatchNorm etc., reference :293):
    ``loss_fn(params, model_state, batch) -> (loss, new_state)``;
    ``step(p_shard, model_state, opt_state, batch) -> (p_shard,
    model_state, opt_state, loss)``."""
    return make_fsdp_train_step(loss_fn, optimizer, mesh=mesh,
                                average=average, compression=compression,
                                has_state=True,
                                validate_elementwise=validate_elementwise)
