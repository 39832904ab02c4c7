"""The ``horovod.keras`` surface for Keras 3 on its torch backend (port of
horovod_tpu/frontends/keras.py, which targets Keras on JAX; ≙
horovod/keras/__init__.py:29-160 and horovod/keras/callbacks.py).

Set ``KERAS_BACKEND=torch`` before the first ``import keras`` (importing
this module first sets it when it is unset; it never overwrites it), and
build and fit under ``keras.device(...)`` for the port's device: Keras
on torch picks ``cuda`` by itself whenever a card is visible.

Usage::

    import horovod_tpu_torch.frontends.keras as hvd
    hvd.init()
    opt = hvd.DistributedOptimizer(keras.optimizers.SGD(0.01))
    model.compile(optimizer=opt, loss="mse")
    model.fit(x, y, callbacks=[
        hvd.callbacks.BroadcastGlobalVariablesCallback(0),
        hvd.callbacks.MetricAverageCallback(),
    ])

Keras on torch trains eagerly (``jit_compile="auto"`` resolves to eager),
so ``apply`` always holds concrete gradients: they go through the port's
eager queue as one group (one cycle's batch, fused under the threshold).
The reference's traced branches (``psum`` under ``shard_map``, XLA's SPMD
pass-through and its multi-process refusal, :76-95) have no counterpart.
Under ``jit_compile=True`` Keras wraps the step in ``torch.compile``; the
reduction is excluded from the compiled graph (``torch.compiler.disable``),
so Dynamo breaks the graph there and the queue runs eagerly on concrete
gradients in that case too.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

# Keras 3 binds its backend at its first import; this frontend needs the
# torch backend.  If keras was already imported on another backend,
# DistributedOptimizer raises a diagnosis below.
os.environ.setdefault("KERAS_BACKEND", "torch")

from ..analysis.program import collective_source as _collective_source
from ..analysis.program import tag_source as _tag_source_factory
from ..core import state as _state
from ..core.state import (cross_rank, cross_size, init,  # noqa: F401
                          is_initialized, local_rank, local_size,
                          mpi_threads_supported, rank, shutdown, size)
from ..ops import collective as _C
from ..ops.collective import (Adasum, Average, Max, Min,  # noqa: F401
                              Product, Sum, add_process_set)
from ..ops.compression import Compression  # noqa: F401
from ..ops.objects import allgather_object, broadcast_object  # noqa: F401
from ..ops.process_set import ProcessSet  # noqa: F401
from . import torch as _T

# hvd-analyze: signature records from this binding carry source=keras.
_tag_source = _tag_source_factory("keras")


@torch.compiler.disable
def _reduce_grads(grads, average: bool, compression=None):
    """Concrete gradients through the eager queue as one group; ``None``
    gradients pass through in place (reference :70-103)."""
    if not _state.is_initialized():
        raise _state.NotInitializedError()
    idx = [i for i, g in enumerate(grads) if g is not None]
    if not idx or _state.size() <= 1:
        return grads
    with _collective_source("keras"):
        reduced = _T.grouped_allreduce([grads[i] for i in idx],
                                       average=average, name="grad",
                                       compression=compression)
    out = list(grads)
    for i, red in zip(idx, reduced):
        out[i] = red
    return out


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         average: bool = True, compression=None):
    """Wrap a ``keras.optimizers.Optimizer`` so gradients are averaged
    across ranks before the update.

    The returned object is an instance of a class with the wrapped
    optimizer's name and base class, so a saved model restores without
    this package (reference :106-142, horovod/keras/__init__.py:86-91).
    Every Keras 3 path (``apply_gradients``, ``apply``) funnels through
    ``apply``, which is where the reduction hooks in.
    """
    import keras

    if keras.backend.backend() != "torch":
        raise RuntimeError(
            f"horovod_tpu_torch.frontends.keras needs Keras on the torch "
            f"backend, but keras was already imported with backend "
            f"'{keras.backend.backend()}' (importing tensorflow or jax "
            f"code that imports keras first can cause this).  Set "
            f"KERAS_BACKEND=torch before the first keras import.")

    base = optimizer.__class__

    def _apply(self, grads, trainable_variables=None):
        grads = _reduce_grads(list(grads), self._hvd_average,
                              self._hvd_compression)
        return super(cls, self).apply(grads, trainable_variables)

    cls = type(base.__name__, (base,),
               {"apply": _apply, "_hvd_average": average,
                "_hvd_compression": compression,
                "_hvd_name": name or f"Distributed{base.__name__}"})
    config = optimizer.get_config()
    return cls.from_config(config) if hasattr(cls, "from_config") \
        else cls(**config)


def _tensor(value) -> torch.Tensor:
    """A torch tensor of ``value`` without a host round trip where it is
    one already (a keras Variable on torch holds one as ``.value``)."""
    value = getattr(value, "value", value)
    if isinstance(value, torch.Tensor):
        return value.detach()
    return torch.as_tensor(np.asarray(value))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@_tag_source
def broadcast_global_variables(model_or_variables, root_rank: int = 0):
    """Broadcast all variables (model + optimizer) from ``root_rank``
    (reference :153-170).  Accepts a Keras model, an optimizer, or an
    iterable of ``keras.Variable``.  Each variable's torch tensor goes to
    the port as it is, on its device."""
    variables = getattr(model_or_variables, "variables", None)
    if variables is None:
        variables = list(model_or_variables)
    opt = getattr(model_or_variables, "optimizer", None)
    if opt is not None:
        variables = list(variables) + list(opt.variables)
    handles = [
        _C.broadcast_async(_tensor(v), root_rank,
                           name=f"broadcast.keras.{i}.{v.path}")
        for i, v in enumerate(variables)
    ]
    for v, h in zip(variables, handles):
        v.assign(_C.synchronize(h))


@_tag_source
def allreduce(value, name: Optional[str] = None, average=None, op=None,
              process_set=None):
    """Allreduce a tensor-compatible value, returned as numpy
    (reference :173-181); ``op`` (hvd.Average/Sum/Adasum/Min/Max/Product)
    is exclusive with ``average``; ``process_set`` restricts the ranks."""
    return _numpy(_C.allreduce(_tensor(value), average=average, name=name,
                               op=op, process_set=process_set))


@_tag_source
def allgather(value, name: Optional[str] = None, process_set=None):
    return _numpy(_C.allgather(_tensor(value), name=name,
                               process_set=process_set))


@_tag_source
def broadcast(value, root_rank: int, name: Optional[str] = None,
              process_set=None):
    return _numpy(_C.broadcast(_tensor(value), root_rank, name=name,
                               process_set=process_set))


# ---------------------------------------------------------------------------
# Callbacks (reference :201-363, ≙ horovod/keras/callbacks.py)
# ---------------------------------------------------------------------------

def _make_callbacks():
    import keras

    def _scalar(x) -> float:
        return float(keras.ops.convert_to_numpy(x))

    class BroadcastGlobalVariablesCallback(keras.callbacks.Callback):
        """Broadcast initial variables from ``root_rank`` at train start
        (≙ keras/callbacks.py:24-44)."""

        def __init__(self, root_rank: int = 0):
            super().__init__()
            self.root_rank = root_rank
            self.broadcast_done = False

        def on_batch_begin(self, batch, logs=None):
            if self.broadcast_done:
                return
            broadcast_global_variables(self.model, self.root_rank)
            self.broadcast_done = True

    class MetricAverageCallback(keras.callbacks.Callback):
        """Average epoch metrics over all ranks before other callbacks
        (checkpointing, early stopping) read them
        (≙ keras/callbacks.py:47-70).  Any numeric log averages, scalars
        and arrays; non-numeric values pass through."""

        def on_epoch_end(self, epoch, logs=None):
            from ..callbacks import _average_metric

            if not logs:
                return
            with _collective_source("keras"):
                for k in sorted(logs.keys()):
                    value = logs[k]
                    if isinstance(value, torch.Tensor):
                        value = _numpy(value)
                    red = _average_metric(_C.allreduce, k, value)
                    if red is not None:
                        logs[k] = red

    class LearningRateScheduleCallback(keras.callbacks.Callback):
        """Multiply the initial LR by ``multiplier`` over
        [start_epoch, end_epoch) (≙ keras/callbacks.py:73-129)."""

        def __init__(self, multiplier, start_epoch: int = 0,
                     end_epoch: Optional[int] = None, staircase: bool = True,
                     momentum_correction: bool = True,
                     steps_per_epoch: Optional[int] = None):
            super().__init__()
            self.multiplier = (multiplier if callable(multiplier)
                               else (lambda epoch: multiplier))
            self.start_epoch = start_epoch
            self.end_epoch = end_epoch
            if not staircase and keras.backend.backend() == "jax":
                # The reference's rule, kept as it stands: only a backend
                # whose jitted step freezes the epoch's state degrades to
                # epoch steps.  Torch runs eagerly, so the per-batch ramp
                # runs there.
                staircase = True
            self.staircase = staircase
            self.momentum_correction = momentum_correction
            self.steps_per_epoch = steps_per_epoch
            self.initial_lr = None
            self.current_epoch = None
            # The true momentum while a corrected one is in force.
            self._restore_momentum = None

        def _autodetect_initial_lr(self):
            if self.initial_lr is None:
                self.initial_lr = _scalar(self.model.optimizer.learning_rate)
            return self.initial_lr

        def _adjust(self, epoch):
            old_lr = _scalar(self.model.optimizer.learning_rate)
            new_lr = self._autodetect_initial_lr() * self.multiplier(epoch)
            self.model.optimizer.learning_rate = new_lr
            if (self.momentum_correction
                    and hasattr(self.model.optimizer, "momentum")
                    and old_lr > 0):
                # Scale the true momentum by new_lr / old_lr for the one
                # batch that follows; on_batch_end restores it
                # (≙ keras/callbacks.py:104-116).  The eager torch step
                # reads the corrected value, where the reference's jitted
                # step never saw it.
                if self._restore_momentum is None:
                    self._restore_momentum = float(
                        np.asarray(self.model.optimizer.momentum))
                self.model.optimizer.momentum = \
                    self._restore_momentum * new_lr / old_lr

        def _restore_momentum_if_needed(self):
            if self._restore_momentum is not None:
                self.model.optimizer.momentum = self._restore_momentum
                self._restore_momentum = None

        def on_epoch_begin(self, epoch, logs=None):
            self.current_epoch = epoch
            if self.staircase and epoch >= self.start_epoch and (
                    self.end_epoch is None or epoch < self.end_epoch):
                self._adjust(epoch)

        def on_batch_begin(self, batch, logs=None):
            if self.staircase:
                return
            epoch = self.current_epoch or 0
            if epoch >= self.start_epoch and (
                    self.end_epoch is None or epoch < self.end_epoch):
                steps = (self.steps_per_epoch
                         or self.params.get("steps") or 1)
                frac = epoch + float(batch) / max(1, steps)
                self._adjust(frac)

        def on_batch_end(self, batch, logs=None):
            self._restore_momentum_if_needed()

        def on_epoch_end(self, epoch, logs=None):
            # Checkpoints and get_config() never see a corrected value.
            self._restore_momentum_if_needed()
            if logs is not None:
                logs["lr"] = _scalar(self.model.optimizer.learning_rate)

    class LearningRateWarmupCallback(LearningRateScheduleCallback):
        """Ramp LR from (initial / size) to initial over
        ``warmup_epochs``: the gradual warmup of the large-batch recipe
        (≙ keras/callbacks.py:132-186)."""

        def __init__(self, warmup_epochs: int = 5, momentum_correction: bool
                     = True, steps_per_epoch: Optional[int] = None,
                     verbose: int = 0):
            self.warmup_epochs = warmup_epochs
            self.verbose = verbose

            def multiplier(progress):
                # progress is fractional (the per-batch ramp) and reaches
                # exactly 1.0 at the end of warmup.
                p = min(progress + 1, self.warmup_epochs)
                return 1.0 / size() + p * (1.0 - 1.0 / size()) \
                    / self.warmup_epochs

            super().__init__(multiplier, start_epoch=0,
                             end_epoch=warmup_epochs, staircase=False,
                             momentum_correction=momentum_correction,
                             steps_per_epoch=steps_per_epoch)

        def on_epoch_end(self, epoch, logs=None):
            super().on_epoch_end(epoch, logs)
            if epoch == self.warmup_epochs - 1 and self.verbose and \
                    rank() == 0:
                print(f"Epoch {epoch + 1}: finished gradual learning rate "
                      f"warmup to "
                      f"{_scalar(self.model.optimizer.learning_rate)}.")

    return SimpleNamespace(
        BroadcastGlobalVariablesCallback=BroadcastGlobalVariablesCallback,
        MetricAverageCallback=MetricAverageCallback,
        LearningRateScheduleCallback=LearningRateScheduleCallback,
        LearningRateWarmupCallback=LearningRateWarmupCallback,
    )


# Lazy, so that importing this module does not import keras.
class _CallbacksModule:
    _cached = None

    def __getattr__(self, item):
        if _CallbacksModule._cached is None:
            _CallbacksModule._cached = _make_callbacks()
        return getattr(_CallbacksModule._cached, item)


callbacks = _CallbacksModule()
