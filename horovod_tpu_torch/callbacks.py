"""Training-loop callbacks (port of horovod_tpu/callbacks.py, itself the
port of horovod.keras.callbacks).

The same four callbacks with the same semantics, bound to
:class:`horovod_tpu_torch.frontends.loop.Trainer`: its ``lr`` and
``momentum`` properties read and write the optimizer's ``param_groups``,
the counterpart of the reference's ``inject_hyperparams`` state.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from .core import state as _state
from .parallel.data import broadcast_parameters


class Callback:
    def set_trainer(self, trainer) -> None:
        self.trainer = trainer


class BroadcastGlobalVariablesCallback(Callback):
    """Broadcast the parameters and the model state from ``root_rank`` at
    train start, so that every rank begins identical (reference :24)."""

    def __init__(self, root_rank: int = 0):
        self.root_rank = root_rank

    def on_train_begin(self, logs=None) -> None:
        broadcast_parameters(self.trainer.params, root_rank=self.root_rank)
        if getattr(self.trainer, "model_state", None) is not None:
            broadcast_parameters(self.trainer.model_state,
                                 root_rank=self.root_rank)


def _average_metric(allreduce_fn, metric: str, value):
    """Allreduce-average one logged metric; None for values that pass
    through untouched (strings, objects).  Any numeric value averages,
    arrays too (reference :40).

    Dtype contract (the reference's): the average is computed in
    ``promote_types(dtype, float32)``, so float64 stays float64 and ints
    average as floats; scalars come back as Python floats, arrays as
    ndarrays of that dtype."""
    try:
        arr = np.asarray(value)
    except Exception:  # noqa: BLE001 — an unconvertible log passes through
        return None
    if arr.dtype.kind not in "biuf":
        return None
    acc = np.promote_types(arr.dtype, np.float32)
    red = allreduce_fn(torch.from_numpy(np.array(arr, dtype=acc)),
                       average=True, name=f"metric.{metric}")
    out = red.cpu().numpy()
    if arr.ndim == 0:
        return float(out)
    return out.astype(acc, copy=False)


class MetricAverageCallback(Callback):
    """Average the epoch's logged metrics over ranks at epoch end, in
    place, in sorted-name order so that every rank issues the same
    collectives (reference :71)."""

    def on_epoch_end(self, epoch: int, logs=None) -> None:
        from .ops import collective as C

        if not logs:
            return
        for metric in sorted(logs.keys()):
            red = _average_metric(C.allreduce, metric, logs[metric])
            if red is not None:
                logs[metric] = red


class LearningRateScheduleCallback(Callback):
    """Set ``lr = initial_lr * multiplier(epoch)`` between ``start_epoch``
    and ``end_epoch`` (reference :154).

    ``multiplier`` is a constant or ``f(epoch) -> factor``; with
    ``staircase=False`` the adjustment happens every batch, at fractional
    epochs ``epoch + batch / steps_per_epoch``.  ``momentum_correction``
    scales momentum by ``new_lr / old_lr`` for the duration of the batch
    (Goyal et al., arXiv:1706.02677).
    """

    def __init__(self, multiplier: Union[float, Callable[[float], float]],
                 start_epoch: int = 0, end_epoch: Optional[int] = None,
                 staircase: bool = True, momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch
        self.staircase = staircase
        self.momentum_correction = momentum_correction
        self.steps_per_epoch = steps_per_epoch
        self.initial_lr: Optional[float] = None
        self.restore_momentum: Optional[float] = None
        self.current_epoch: int = 0
        if not callable(multiplier):
            self.staircase = True
            self.multiplier = lambda epoch: multiplier
        else:
            self.multiplier = multiplier

    def _adjust_learning_rate(self, epoch: float) -> None:
        old_lr = self.trainer.lr
        new_lr = self.initial_lr * self.multiplier(epoch)
        self.trainer.lr = new_lr
        if self.momentum_correction and self.trainer.momentum is not None \
                and old_lr > 0:
            self.restore_momentum = self.trainer.momentum
            self.trainer.momentum = self.restore_momentum * new_lr / old_lr

    def _restore_momentum_if_needed(self) -> None:
        if self.restore_momentum is not None:
            self.trainer.momentum = self.restore_momentum
            self.restore_momentum = None

    def on_train_begin(self, logs=None) -> None:
        self.initial_lr = self.trainer.lr
        if not self.staircase and not self.steps_per_epoch:
            self.steps_per_epoch = self.trainer.steps_per_epoch
            if not self.steps_per_epoch:
                raise ValueError(
                    "steps_per_epoch is required for smooth (staircase="
                    "False) schedules.")

    def on_epoch_begin(self, epoch: int, logs=None) -> None:
        self.current_epoch = epoch

    def on_batch_begin(self, batch: int, logs=None) -> None:
        if (self.current_epoch < self.start_epoch or
                (self.end_epoch is not None
                 and self.current_epoch >= self.end_epoch)):
            return
        if self.staircase and batch == 0:
            self._adjust_learning_rate(self.current_epoch)
        elif not self.staircase:
            epoch = self.current_epoch + float(batch) / self.steps_per_epoch
            self._adjust_learning_rate(epoch)

    def on_batch_end(self, batch: int, logs=None) -> None:
        self._restore_momentum_if_needed()

    def on_epoch_end(self, epoch: int, logs=None) -> None:
        if logs is not None:
            logs["lr"] = self.trainer.lr


class LearningRateWarmupCallback(LearningRateScheduleCallback):
    """Gradual warmup ``lr / size -> lr`` over ``warmup_epochs`` (reference
    :229; Goyal et al.), multiplier ``1/size * (epoch * (size-1) / warmup
    + 1)``."""

    def __init__(self, warmup_epochs: int = 5,
                 momentum_correction: bool = True,
                 steps_per_epoch: Optional[int] = None, verbose: int = 0):
        self.warmup_epochs = warmup_epochs
        self.verbose = verbose

        def multiplier(epoch):
            size = _state.size()
            # Nudge so that epoch boundaries land on round values
            # (≙ keras/callbacks.py:243-247).
            epoch += 1.0 / self.steps_per_epoch
            return 1.0 / size * (epoch * (size - 1) / warmup_epochs + 1)

        super().__init__(multiplier, start_epoch=0, end_epoch=warmup_epochs,
                         staircase=False,
                         momentum_correction=momentum_correction,
                         steps_per_epoch=steps_per_epoch)

    def on_epoch_end(self, epoch: int, logs=None) -> None:
        super().on_epoch_end(epoch, logs)
        if epoch == self.end_epoch - 1 and self.verbose > 0:
            print(f"\nEpoch {epoch + 1}: finished gradual learning rate "
                  f"warmup to {self.trainer.lr:g}.")


def warmup_then_decay_schedule(base_lr: float, warmup_epochs: int,
                               steps_per_epoch: int,
                               decay_epochs_and_factors=None
                               ) -> Callable[[int], float]:
    """The warmup as a plain ``step -> lr`` function (reference :259, there
    an optax schedule): linear from ``base_lr / size`` to ``base_lr`` over
    the warmup steps, then ``base_lr``, then ``base_lr * factor`` from
    each ``(epoch, factor)`` on."""
    size = _state.size()
    warmup_steps = warmup_epochs * steps_per_epoch
    decays = [(epoch * steps_per_epoch, base_lr * factor)
              for epoch, factor in (decay_epochs_and_factors or [])]

    def schedule(step: int) -> float:
        if step < warmup_steps:  # optax.linear_schedule, clipped count
            frac = 1.0 - max(step, 0) / warmup_steps
            lr = (base_lr / size - base_lr) * frac + base_lr
        else:
            lr = base_lr
        for boundary, value in decays:  # optax.join_schedules
            if step >= boundary:
                lr = value
        return lr

    return schedule
