"""A Keras-style training loop to hang the Horovod callbacks on (port of
horovod_tpu/frontends/loop.py).

The callback protocol is the reference's (``on_train_begin``,
``on_epoch_begin/end``, ``on_batch_begin/end``).  The step is
:func:`~..parallel.training.make_train_step` or, with a model state,
:func:`~..parallel.training.make_train_step_with_state`, over a
:class:`~..parallel.data.DistributedOptimizer`.  Learning rate and
momentum live in the optimizer's ``param_groups``, which the ``lr`` and
``momentum`` properties read and write: the counterpart of the
reference's ``optax.inject_hyperparams`` state.  ``torch.optim.SGD``
with dampening 0 is ``optax.sgd(momentum=...)``, first step included
(both take the first gradient as the momentum buffer).

``zero=True`` and ``fsdp=True`` shard the optimizer state, and with
``fsdp`` the parameters too (:mod:`..parallel.zero`,
:mod:`..parallel.fsdp`); ``lr`` and ``momentum`` then reach the shard's
optimizer.  Under ``fsdp`` the ``params`` property gathers on read and
re-shards on assignment, so the callbacks see one contract in every
mode, and the hot loop steps the shard directly.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core import state as _state
from ..parallel.data import DistributedOptimizer
from ..parallel.input import prefetch_to_device
from ..parallel.training import (barrier_fence, make_train_step,
                                 make_train_step_with_state, shard_batch)
from ..utils.tree import tree_leaves


class Trainer:
    """Minimal distributed training loop.

    Args:
      loss_fn: ``loss_fn(params, batch) -> scalar`` or, with
        ``model_state``, ``loss_fn(params, model_state, batch) ->
        (scalar, new_model_state)``, on this rank's batch.
      params: the parameter tree (leaves require grad), updated in place.
      optimizer_fn: an optimizer class, called as
        ``optimizer_fn(tree_leaves(params), lr=lr, **optimizer_kwargs)``.
      lr: initial learning rate (``initial_lr`` in callback terms).
      callbacks: callback objects (see :mod:`horovod_tpu_torch.callbacks`).
      model_state: optional non-trained state (BatchNorm statistics).
      zero: ZeRO-1 optimizer-state sharding (the optimizer must be
        elementwise; ``fusion_threshold`` does not apply: the flattened
        gradient is one maximal fusion bucket).
      fsdp: FSDP/ZeRO-3: parameters and optimizer state live as 1/N
        flat shards between steps; ``params`` gathers on read and
        re-shards on assignment.  Same precondition as ``zero``.
    """

    def __init__(self, loss_fn, params, optimizer_fn=torch.optim.SGD,
                 lr: float = 0.01, optimizer_kwargs: Optional[dict] = None,
                 callbacks: Optional[Sequence] = None, model_state=None,
                 average_gradients: bool = True,
                 fusion_threshold: Optional[int] = None,
                 zero: bool = False, fsdp: bool = False):
        _state._check_initialized()
        if zero and fsdp:
            raise ValueError("zero and fsdp are mutually exclusive: "
                             "fsdp shards everything zero does and the "
                             "parameters too")
        self._fsdp = fsdp
        if not fsdp:
            self.params = params
        self.model_state = model_state
        self._has_state = model_state is not None
        kwargs = dict(optimizer_kwargs or {})
        self._momentum_key = "momentum" if "momentum" in kwargs else None
        if (zero or fsdp) and fusion_threshold is not None:
            import warnings

            warnings.warn(
                f"fusion_threshold is ignored with "
                f"{'fsdp' if fsdp else 'zero'}=True: the flattened "
                "gradient is one maximal fusion bucket", stacklevel=2)
        if zero or fsdp:
            self._run = self._sharded(
                loss_fn, lambda ps: optimizer_fn(ps, lr=lr, **kwargs),
                params, average_gradients)
        else:
            self.optimizer = DistributedOptimizer(
                optimizer_fn(tree_leaves(params), lr=lr, **kwargs),
                average=average_gradients, fusion_threshold=fusion_threshold)
            make_step = (make_train_step_with_state if self._has_state
                         else make_train_step)
            # The schedule follows HVD_TPU_OVERLAP, with or without a
            # model state, as the reference's Trainer does.
            step = self._step = make_step(loss_fn, self.optimizer)
            if self._has_state:
                def run(batch):
                    self.model_state, loss = step(self.params,
                                                  self.model_state, batch)
                    return loss
            else:
                def run(batch):
                    return step(self.params, batch)
            self._run = run
        self.callbacks = list(callbacks or [])
        for cb in self.callbacks:
            if hasattr(cb, "set_trainer"):
                cb.set_trainer(self)
        self.history: List[dict] = []
        self.steps_per_epoch: Optional[int] = None
        self.stop_training = False

    def _sharded(self, loss_fn, optimizer_fn, params, average):
        """``run(batch) -> loss`` over a ZeRO or FSDP step; the shard's
        optimizer becomes ``self.optimizer``."""
        if self._fsdp:
            from ..parallel.fsdp import (make_fsdp_train_step as build,
                                         make_fsdp_train_step_with_state
                                         as build_with_state)
        else:
            from ..parallel.zero import (make_zero_train_step as build,
                                         make_zero_train_step_with_state
                                         as build_with_state)
        sstep = (build_with_state if self._has_state else build)(
            loss_fn, optimizer_fn, average=average)
        if self._fsdp:
            self._fstep = sstep
            self._p_shard, self.opt_state = sstep.init(params)
            # Each rank's own tree until the first step or assignment:
            # a broadcast at train begin then starts every shard from
            # root's weights, as it does every replica without fsdp (the
            # shards of trees that differ by rank would mix them).
            self._unsharded = params
        else:
            self.opt_state = sstep.init(params)
        self.optimizer = self.opt_state.optimizer
        # The hot loop steps the shard directly under fsdp, with no
        # gather through the params property.
        held = "_p_shard" if self._fsdp else "_params"

        def run(batch):
            self._unsharded = None
            state = (self.model_state,) if self._has_state else ()
            out = sstep.step(getattr(self, held), *state, self.opt_state,
                             batch)
            setattr(self, held, out[0])
            if self._has_state:
                self.model_state = out[1]
            self.opt_state, loss = out[-2:]
            return loss

        return run

    # -- parameter access: one contract in every mode ---------------------
    @property
    def params(self):
        """The whole parameter tree.  Under ``fsdp=True`` reading gathers
        the shards and assigning re-shards, so callbacks (the broadcast
        at train begin, a rank-0 checkpoint) see the same contract as in
        every other mode; until the first step or assignment it is the
        tree this rank passed in."""
        if self._fsdp:
            if self._unsharded is not None:
                return self._unsharded
            return self._fstep.full_params(self._p_shard)
        return self._params

    @params.setter
    def params(self, value) -> None:
        if self._fsdp:
            self._p_shard = self._fstep.shard_params(value)
            self._unsharded = None
        else:
            self._params = value

    # -- hyperparameters for callbacks (≙ K.get/set_value) ----------------
    @property
    def lr(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    @lr.setter
    def lr(self, value: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = float(value)

    @property
    def momentum(self) -> Optional[float]:
        if self._momentum_key is None:
            return None
        return float(self.optimizer.param_groups[0][self._momentum_key])

    @momentum.setter
    def momentum(self, value: float) -> None:
        if self._momentum_key is None:
            raise AttributeError("optimizer has no momentum hyperparameter")
        for group in self.optimizer.param_groups:
            group[self._momentum_key] = float(value)

    @property
    def size(self) -> int:
        return _state.size()

    # -- loop -------------------------------------------------------------
    def _call(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            fn = getattr(cb, hook, None)
            if fn is not None:
                fn(*args)

    def fit(self, batches: Callable[[int, int], Any], epochs: int,
            steps_per_epoch: int, initial_epoch: int = 0,
            prefetch: int = 2,
            log_every: Optional[int] = None) -> List[dict]:
        """Run the loop.  ``batches(epoch, step)`` returns one global batch
        (leading axis divisible by the rank count); each rank trains on
        its rows.

        Each epoch's batches are staged on the device by
        :func:`..parallel.input.prefetch_to_device` (``prefetch`` is the
        queue depth; 0 stages each batch synchronously with
        ``shard_batch``).  Losses stay device tensors until the epoch's
        end, where they are fetched once; ``log_every=k`` also fetches
        the loss every k steps and hands it to ``on_batch_end``.

        With ``prefetch > 0``, ``batches`` runs on a stager thread up to
        ``prefetch + 1`` steps ahead of the callbacks: pass ``prefetch=0``
        if it is not thread-safe or reads state the callbacks change.
        """
        self.steps_per_epoch = steps_per_epoch
        self._call("on_train_begin", None)
        for epoch in range(initial_epoch, epochs):
            if self.stop_training:
                break
            self._call("on_epoch_begin", epoch, None)
            losses = []

            def epoch_batches(epoch=epoch):
                for s in range(steps_per_epoch):
                    yield batches(epoch, s)

            if prefetch and prefetch > 0:
                staged = prefetch_to_device(epoch_batches(), depth=prefetch)
            else:
                staged = (shard_batch(b) for b in epoch_batches())
            try:
                for step, batch in enumerate(staged):
                    self._call("on_batch_begin", step, None)
                    loss = self._run(batch)
                    losses.append(loss)
                    batch_logs = None
                    if log_every and (step + 1) % log_every == 0:
                        batch_logs = {"loss": float(loss)}
                    self._call("on_batch_end", step, batch_logs)
            finally:
                close = getattr(staged, "close", None)
                if close is not None:
                    close()
            # One fetch for the whole epoch; the mean as the reference's
            # np.mean over its f32 losses.
            logs = {"loss": float(np.mean(
                torch.stack(losses).float().cpu().numpy()))}
            self._call("on_epoch_end", epoch, logs)
            self.history.append(logs)
        barrier_fence()
        self._call("on_train_end", None)
        return self.history
