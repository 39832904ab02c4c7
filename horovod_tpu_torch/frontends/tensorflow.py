"""The ``horovod.tensorflow`` surface for TF2 over the port's eager
collectives (port of horovod_tpu/frontends/tensorflow.py; ≙
horovod/tensorflow/__init__.py:49-192).

TF tensors cross to the port on the host: each collective turns its
inputs into numpy, then into CPU torch tensors, enqueues them on the
port's queue (which moves them to the port's device, ``cuda`` unless
``init(device="cpu")``), and turns the results back into TF tensors of
the caller's dtype.  bfloat16 crosses by its bits (numpy holds it as
``ml_dtypes.bfloat16``, which torch does not take), and float64 stays
float64 on the wire: the reference computes float64 in float32, x64
being off there.

* :func:`allreduce` takes dense tensors and ``tf.IndexedSlices`` (the
  gather of values and indices, :mod:`..ops.sparse`; sum or average
  only, and ``compression`` applies to dense tensors only).
* :class:`DistributedGradientTape` reduces what ``tape.gradient``
  returns; :func:`DistributedOptimizer` reduces in ``apply`` (Keras 3
  optimizers) or ``apply_gradients`` (legacy ones).
* :func:`broadcast_variables` / :func:`broadcast_global_variables` give
  every rank the root's values.

Inside ``tf.function`` each collective is one ``tf.py_function`` node
whose body re-enters the eager path at graph-execution time (≙ the
reference's AsyncOpKernel enqueue, mpi_ops.cc:270-298); names are fixed
at trace time, so repeated executions reuse the negotiation (and the
response cache).  Each node is one host round trip and TF chains
stateful nodes, so N separate calls run one after another and negotiate
alone: ``DistributedGradientTape``, ``DistributedOptimizer`` and
:func:`grouped_allreduce` bridge a whole batch through one node, which
enqueues it as one group: one cycle's batch, one fused response under
the threshold.
"""

from __future__ import annotations

from typing import Any, Iterable, List, Optional

import numpy as np
import torch

from ..analysis import program as _analysis_program
from ..core.features import (  # noqa: F401  (feature queries)
    cuda_built, gloo_built, mpi_built, mpi_enabled, nccl_built, rocm_built)
from ..core.state import (cross_rank, cross_size, init,  # noqa: F401
                          is_initialized, local_rank, local_size,
                          mpi_threads_supported, rank, shutdown, size,
                          start_timeline, stop_timeline)
from ..ops import collective as _C
from ..ops import sparse as _S
from ..ops.collective import (Adasum, Average, Max, Min,  # noqa: F401
                              Product, Sum, add_process_set, join)
from ..ops.compression import Compression  # noqa: F401
from ..ops.objects import allgather_object, broadcast_object  # noqa: F401
from ..ops.process_set import ProcessSet  # noqa: F401
from . import torch as _T


def _tf():
    import tensorflow as tf

    return tf


def _auto_name(prefix: str, process_set=None) -> str:
    return _C._runtime().auto_name(prefix, process_set)


def _to_numpy(t) -> np.ndarray:
    tf = _tf()
    if isinstance(t, tf.Variable):
        t = t.value()
    if hasattr(t, "numpy"):
        try:
            return t.numpy()
        except Exception as e:  # symbolic tensor outside our graph bridge
            raise RuntimeError(
                "horovod_tpu_torch.frontends.tensorflow got a symbolic "
                "tensor on the eager path; inside tf.function the "
                "collectives bridge through tf.py_function automatically: "
                "pass the tf.Tensor itself, not a structure the bridge "
                "cannot see.") from e
    return np.asarray(t)


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    """A CPU torch copy of ``arr``; bfloat16 (``ml_dtypes.bfloat16``,
    which torch does not take) crosses by its bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _from_torch(t: torch.Tensor, dtype) -> np.ndarray:
    """``t`` as a numpy array of ``dtype`` (a bfloat16 result keeps its
    bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16).astype(
            dtype, copy=False)
    return t.numpy().astype(dtype, copy=False)


def _tracing() -> bool:
    """True while tf.function traces the caller (graph construction): the
    moment to plant a ``tf.py_function`` bridge node instead of touching
    tensor values.  Inside the py_function body eager execution is back
    on, so the bridge cannot recurse."""
    tf = _tf()
    try:
        return not tf.executing_eagerly()
    except Exception:
        return False


def _graph_bridge(eager_fn, inputs, out_dtypes, op_name: str):
    """One ``tf.py_function`` node calling ``eager_fn`` with concrete
    tensors at graph-execution time.

    The body runs on a thread of TF's, so the hvd-analyze source tag is
    applied inside it, not around the trace: signature records for
    in-graph collectives still name this frontend."""
    tf = _tf()

    def tagged(*args):
        with _analysis_program.collective_source("tf"):
            return eager_fn(*args)

    flat = tf.py_function(func=tagged, inp=list(inputs),
                          Tout=list(out_dtypes),
                          name=op_name.replace(".", "_"))
    return flat if isinstance(flat, (list, tuple)) else [flat]


def _wrap(out: torch.Tensor, like: np.ndarray):
    """Result tensor -> tf tensor of the caller's dtype."""
    return _tf().constant(_from_torch(out, like.dtype))


def _dense_allreduce(arr: np.ndarray, average, name, compression, op,
                     process_set) -> torch.Tensor:
    t = _to_torch(arr)
    if compression is None:
        return _C.allreduce(t, average=average, name=name, op=op,
                            process_set=process_set)
    wire, ctx = compression.compress(t)
    return compression.decompress(
        _C.allreduce(wire, average=average, name=name, op=op,
                     process_set=process_set), ctx)


def _sparse_allreduce(values: np.ndarray, indices: np.ndarray, average,
                      name, process_set) -> _S.IndexedSlices:
    return _S.allreduce(
        _S.IndexedSlices(values=_to_torch(values),
                         indices=_to_torch(indices), dense_shape=()),
        average=average, name=name, process_set=process_set)


def _check_sparse_op(average, op) -> bool:
    """Whether a sparse allreduce averages; sum and average only."""
    red_op = _C._resolve_op(average, op)
    if red_op not in (Average, Sum):
        raise ValueError(
            "sparse (IndexedSlices) allreduce supports only sum/average.")
    return red_op == Average


def _allreduce_in_graph(tensor, average, name: Optional[str],
                        compression, op=None, process_set=None):
    """tf.function branch of :func:`allreduce`: one py_function node per
    collective, its name fixed at trace time."""
    tf = _tf()
    if isinstance(tensor, tf.IndexedSlices):
        mean = _check_sparse_op(average, op)
        op_name = name or _auto_name("allreduce.tf.fn.sparse", process_set)
        vdt, idt = tensor.values.dtype, tensor.indices.dtype

        def _eager(values, indices):
            red = _sparse_allreduce(values.numpy(), indices.numpy(), mean,
                                    op_name, process_set)
            return (_from_torch(red.values, vdt.as_numpy_dtype),
                    _from_torch(red.indices, idt.as_numpy_dtype))

        vals, idxs = _graph_bridge(_eager,
                                   [tensor.values, tensor.indices],
                                   [vdt, idt], op_name)
        # The gathered row count sums every rank's: only the trailing
        # dims are static.
        vals.set_shape([None] + list(tensor.values.shape[1:]))
        idxs.set_shape([None])
        return tf.IndexedSlices(vals, idxs, dense_shape=tensor.dense_shape)

    op_name = name or _auto_name("allreduce.tf.fn", process_set)
    dt = tensor.dtype

    def _eager(t):
        return _from_torch(
            _dense_allreduce(t.numpy(), average, op_name, compression, op,
                             process_set), dt.as_numpy_dtype)

    (out,) = _graph_bridge(_eager, [tensor], [dt], op_name)
    out.set_shape(tensor.shape)
    return out


# Eager entry points record source=tf; in-graph calls are tagged inside
# the py_function bridge instead.
_tag_source = _analysis_program.tag_source("tf")


@_tag_source
def allreduce(tensor, average=None, name: Optional[str] = None,
              compression=None, op=None, process_set=None):
    """Allreduce a ``tf.Tensor``/``tf.Variable``/``tf.IndexedSlices``.

    IndexedSlices take the gather of values and indices
    (tensorflow/__init__.py:67-78); they already ship a minimal payload,
    so ``compression`` (the dense wire cast, ``Compression.fp16``/
    ``bf16``) applies to dense tensors only.  ``op`` (Average/Sum/Adasum/
    Min/Max/Product) and ``average`` are mutually exclusive (both raise
    ValueError); with neither the call averages.  Sparse inputs accept
    sum and average only.  Inside ``tf.function`` the collective is a
    ``tf.py_function`` node running the same eager path mid-graph.
    """
    tf = _tf()
    if _tracing():
        return _allreduce_in_graph(tensor, average, name, compression,
                                   op=op, process_set=process_set)
    if isinstance(tensor, tf.IndexedSlices):
        mean = _check_sparse_op(average, op)
        # dense_shape may be None; the exchange never needs it.
        dense_shape = (None if tensor.dense_shape is None
                       else tuple(int(d) for d in tensor.dense_shape))
        values = _to_numpy(tensor.values)
        indices = _to_numpy(tensor.indices)
        red = _sparse_allreduce(values, indices, mean, name, process_set)
        return tf.IndexedSlices(
            _wrap(red.values, values), _wrap(red.indices, indices),
            dense_shape=None if dense_shape is None
            else tf.constant(dense_shape, dtype="int64"))
    arr = _to_numpy(tensor)
    return _wrap(_dense_allreduce(arr, average, name, compression, op,
                                  process_set), arr)


@_tag_source
def allgather(tensor, name: Optional[str] = None):
    """Gather along dim 0 in rank order; ranks may differ in dim 0."""
    if _tracing():
        op_name = name or _auto_name("allgather.tf.fn")
        dt = tensor.dtype

        def _eager(t):
            return _from_torch(
                _C.allgather(_to_torch(t.numpy()), name=op_name),
                dt.as_numpy_dtype)

        (out,) = _graph_bridge(_eager, [tensor], [dt], op_name)
        # Ragged gather: dim 0 sums every rank's extent.
        out.set_shape([None] + list(tensor.shape[1:]))
        return out
    arr = _to_numpy(tensor)
    return _wrap(_C.allgather(_to_torch(arr), name=name), arr)


@_tag_source
def broadcast(tensor, root_rank: int, name: Optional[str] = None):
    if _tracing():
        op_name = name or _auto_name("broadcast.tf.fn")
        dt = tensor.dtype

        def _eager(t):
            return _from_torch(
                _C.broadcast(_to_torch(t.numpy()), root_rank, name=op_name),
                dt.as_numpy_dtype)

        (out,) = _graph_bridge(_eager, [tensor], [dt], op_name)
        out.set_shape(tensor.shape)
        return out
    arr = _to_numpy(tensor)
    return _wrap(_C.broadcast(_to_torch(arr), root_rank, name=name), arr)


@_tag_source
def broadcast_variables(variables: Iterable, root_rank: int = 0) -> None:
    """Assign every variable the root's value: every broadcast started,
    then synchronized (tensorflow/__init__.py:100-107)."""
    variables = list(variables)
    arrs = [_to_numpy(v) for v in variables]
    handles = [
        _C.broadcast_async(_to_torch(a), root_rank,
                           name=f"broadcast.tf.{i}.{v.name}")
        for i, (v, a) in enumerate(zip(variables, arrs))
    ]
    for v, a, h in zip(variables, arrs, handles):
        v.assign(_from_torch(_C.synchronize(h), a.dtype))


def broadcast_global_variables(model_or_variables, root_rank: int = 0):
    """TF2 spelling of the reference's broadcast_global_variables: there
    is no global-variables collection, so pass a model (``.variables``)
    or an iterable of variables."""
    variables = getattr(model_or_variables, "variables", model_or_variables)
    broadcast_variables(variables, root_rank)


class DistributedGradientTape:
    """Wrap a ``tf.GradientTape`` so ``gradient()`` returns allreduced
    gradients: the TF2 idiom for the reference's DistributedOptimizer
    ``compute_gradients`` override (tensorflow/__init__.py:158-177)."""

    def __init__(self, tape, average: bool = True, compression=None):
        self._tape = tape
        self._average = average
        self._compression = compression

    def __getattr__(self, item):
        return getattr(self.__dict__["_tape"], item)

    def __enter__(self):
        self._tape.__enter__()
        return self

    def __exit__(self, *exc):
        return self._tape.__exit__(*exc)

    def gradient(self, target, sources, *args, **kwargs):
        tf = _tf()
        grads = self._tape.gradient(target, sources, *args, **kwargs)
        flat = tf.nest.flatten(grads)
        red = _allreduce_batch(flat, self._average, prefix="tape.grad",
                               compression=self._compression)
        return tf.nest.pack_sequence_as(grads, red)


def _allreduce_batch(tensors, average, prefix: str,
                     compression=None, op=None) -> List[Any]:
    """Allreduce a batch as one group (one cycle's batch, fused under the
    threshold); ``None`` entries stay ``None``.  ``compression`` casts the
    wire down and each result comes back in its input's dtype.

    Inside ``tf.function`` the whole batch is one py_function node whose
    body runs this function eagerly."""
    idx = [i for i, t in enumerate(tensors) if t is not None]
    if _tracing():
        base = _auto_name(f"{prefix}.fn")

        def _eager(*concrete):
            return _allreduce_batch(list(concrete), average, base,
                                    compression, op=op)

        outs = _graph_bridge(_eager, [tensors[i] for i in idx],
                             [tensors[i].dtype for i in idx], base)
        result: List[Any] = [None] * len(tensors)
        for o, i in zip(outs, idx):
            o.set_shape(tensors[i].shape)
            result[i] = o
        return result
    result = [None] * len(tensors)
    if not idx:
        return result
    arrs = [_to_numpy(tensors[i]) for i in idx]
    reduced = _T.grouped_allreduce([_to_torch(a) for a in arrs],
                                   average=average, name=prefix,
                                   compression=compression, op=op)
    for i, a, red in zip(idx, arrs, reduced):
        result[i] = _wrap(red, a)
    return result


def grouped_allreduce(tensors, average=None,
                      name: Optional[str] = None, compression=None,
                      op=None):
    """Allreduce a list of tensors as ONE group (≙ the post-v0.13
    ``hvd.grouped_allreduce``, sync form).  ``op`` and ``average`` are
    mutually exclusive; with neither the group averages.  Inside
    ``tf.function`` the whole group is one ``tf.py_function`` node: the
    API to reach for instead of N separate :func:`allreduce` calls, which
    trace to N stateful nodes that TF runs one after another."""
    base = name or _auto_name("grouped.allreduce.tf")
    return _allreduce_batch(list(tensors), average, base, compression,
                            op=op)


def DistributedOptimizer(optimizer, name: Optional[str] = None,
                         average: bool = True, compression=None):
    """Wrap a ``tf.keras`` optimizer so the gradients are allreduced
    before the update (≙ reference DistributedOptimizer,
    tensorflow/__init__.py:135-192).  The returned instance keeps the
    wrapped class's name."""
    base = optimizer.__class__
    overrides = {"_hvd_average": average,
                 "_hvd_compression": compression,
                 "_hvd_name": name or f"Distributed{base.__name__}"}

    if hasattr(base, "apply"):
        # Keras-3-style optimizer (tf.keras in TF >= 2.16): every path
        # funnels through apply(), so that is the one hook.
        def _apply(self, grads, trainable_variables=None):
            red = _allreduce_batch(list(grads), self._hvd_average,
                                   prefix="grad",
                                   compression=self._hvd_compression)
            return super(cls, self).apply(red, trainable_variables)

        overrides["apply"] = _apply
    else:
        # Legacy optimizer: apply_gradients is the entry point.
        def _apply_gradients(self, grads_and_vars, *args, **kwargs):
            gv = list(grads_and_vars)
            red = _allreduce_batch([g for g, _ in gv], self._hvd_average,
                                   prefix="grad",
                                   compression=self._hvd_compression)
            return super(cls, self).apply_gradients(
                [(r, v) for r, (_, v) in zip(red, gv)], *args, **kwargs)

        overrides["apply_gradients"] = _apply_gradients

    cls = type(base.__name__, (base,), overrides)
    return cls.from_config(optimizer.get_config()) \
        if hasattr(cls, "from_config") else cls(**optimizer.get_config())
