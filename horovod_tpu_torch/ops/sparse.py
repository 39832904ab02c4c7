"""Sparse gradients: the embedding and word2vec path (port of
horovod_tpu/ops/sparse.py).

Horovod allreduces the sparse rows of an embedding's gradient
(``tf.IndexedSlices``) as an allgather of values and indices instead of a
dense allreduce (tensorflow/__init__.py:67-78, exercised by
examples/tensorflow_word2vec.py:156-183): each rank contributes the rows
it touched, and every rank applies the union.  Here the two allgathers are
negotiated collectives (ragged: each rank's nnz may differ), and the
result is applied with ``index_add``.  ``nn.Embedding(sparse=True)`` gives
its gradient as a sparse COO tensor; :func:`from_sparse_coo` turns it into
:class:`IndexedSlices`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


class IndexedSlices(NamedTuple):
    """Sparse rows of a dense tensor (≙ tf.IndexedSlices): ``values[i]``
    is the update of row ``indices[i]`` of a tensor of ``dense_shape``."""

    values: torch.Tensor    # [nnz, ...row shape]
    indices: torch.Tensor   # [nnz] integer
    dense_shape: Tuple[int, ...]


def allreduce(slices: IndexedSlices, average: bool = True,
              name: Optional[str] = None, process_set=None) -> IndexedSlices:
    """The union of every rank's slices: two negotiated allgathers (values
    and indices, in one cycle), values divided by the contributor count
    when ``average`` (≙ tensorflow/__init__.py:75-77).  With
    ``process_set`` only its members gather and count."""
    from ..core import state as _state
    from . import collective as C

    name = name or C._runtime().auto_name("sparse_allreduce", process_set)
    hv = C.allgather_async(slices.values, name=f"{name}.values",
                           process_set=process_set)
    hi = C.allgather_async(slices.indices, name=f"{name}.indices",
                           process_set=process_set)
    values, indices = C.synchronize(hv), C.synchronize(hi)
    if average:
        values = values / (_state.size() if process_set is None
                           else process_set.size())
    return IndexedSlices(values, indices, tuple(slices.dense_shape))


def as_dense(slices: IndexedSlices) -> torch.Tensor:
    """Scatter-sum the slices into the dense tensor (duplicate indices
    add up)."""
    dense = slices.values.new_zeros(tuple(slices.dense_shape))
    return dense.index_add_(0, slices.indices, slices.values)


def apply_to(param: torch.Tensor, slices: IndexedSlices,
             scale: float = 1.0) -> torch.Tensor:
    """``param + scale * scatter(slices)``, out of place, without the
    dense gradient: the embedding update."""
    return param.index_add(0, slices.indices, scale * slices.values)


def sparse_grad_from_dense(dense_grad: torch.Tensor,
                           touched_rows: torch.Tensor) -> IndexedSlices:
    """The touched rows of a dense gradient as IndexedSlices: each row
    once (``torch.unique``, sorted, as the reference's ``np.unique``), so
    a duplicated row is never applied twice."""
    rows = torch.unique(touched_rows.to(dense_grad.device))
    return IndexedSlices(dense_grad[rows], rows, tuple(dense_grad.shape))


def from_sparse_coo(grad: torch.Tensor) -> IndexedSlices:
    """The sparse COO gradient of ``nn.Embedding(sparse=True)`` as
    IndexedSlices: ``coalesce()`` sorts the rows and sums duplicates, so
    the result equals ``sparse_grad_from_dense`` of the dense gradient
    over the looked-up rows."""
    g = grad.coalesce()
    return IndexedSlices(g.values(), g.indices()[0], tuple(g.shape))


def to_sparse_coo(slices: IndexedSlices) -> torch.Tensor:
    """IndexedSlices as a sparse COO tensor (what ``.grad`` of a sparse
    embedding holds; torch's sparse-aware optimizers apply it)."""
    return torch.sparse_coo_tensor(slices.indices.reshape(1, -1),
                                   slices.values, tuple(slices.dense_shape),
                                   check_invariants=False)
