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
      zero, fsdp: optimizer-state / parameter sharding, not ported yet.
    """

    def __init__(self, loss_fn, params, optimizer_fn=torch.optim.SGD,
                 lr: float = 0.01, optimizer_kwargs: Optional[dict] = None,
                 callbacks: Optional[Sequence] = None, model_state=None,
                 average_gradients: bool = True,
                 fusion_threshold: Optional[int] = None,
                 zero: bool = False, fsdp: bool = False):
        _state._check_initialized()
        if zero or fsdp:
            raise NotImplementedError(
                f"Trainer({'zero' if zero else 'fsdp'}=True): optimizer-"
                f"state and parameter sharding are not in this slice of the "
                f"port (ROADMAP.md A.3)")
        self.params = params
        self.model_state = model_state
        self._has_state = model_state is not None
        kwargs = dict(optimizer_kwargs or {})
        self._momentum_key = "momentum" if "momentum" in kwargs else None
        self.optimizer = DistributedOptimizer(
            optimizer_fn(tree_leaves(params), lr=lr, **kwargs),
            average=average_gradients, fusion_threshold=fusion_threshold)
        make_step = (make_train_step_with_state if self._has_state
                     else make_train_step)
        self._step = make_step(loss_fn, self.optimizer)
        self.callbacks = list(callbacks or [])
        for cb in self.callbacks:
            if hasattr(cb, "set_trainer"):
                cb.set_trainer(self)
        self.history: List[dict] = []
        self.steps_per_epoch: Optional[int] = None
        self.stop_training = False

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
                    if self._has_state:
                        self.model_state, loss = self._step(
                            self.params, self.model_state, batch)
                    else:
                        loss = self._step(self.params, batch)
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
