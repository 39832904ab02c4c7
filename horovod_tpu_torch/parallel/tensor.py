"""Tensor (model) parallelism: Megatron-style sharded products (port of
horovod_tpu/parallel/tensor.py).

Weights shard over the model axis; activations stay replicated within a
model group.  :func:`column_parallel` splits a weight on its output axis
(no communication: each rank computes its slice of the outputs), and
:func:`row_parallel` on its input axis (each rank contracts its slice
and the partial products are summed with ``psum``), so a block costs one
``psum``.  :func:`row_parallel_scatter` (product + reduce-scatter: each
rank keeps its feature shard of the sum) and
:func:`gather_column_parallel` (all-gather + product) hand activations
on feature-sharded between blocks.

The closers are chunked along the token axis by
:func:`..ops.fused.chunked_map`, so chunk *i*'s collective is in flight
while chunk *i+1* multiplies (``fuse``/``fuse_chunks`` default to
``HVD_TPU_FUSE``/``HVD_TPU_FUSE_CHUNKS``).

Every function takes the model axis as a
:class:`~..core.topology.MeshAxis` (``axis=mesh.axis("model")``); the
collectives' backward follows :mod:`.axis_ops`'s convention.  Products
take the input's dtype with f32 accumulation, rounded back to it
(``torch.matmul`` on bf16; the reference's ``jnp.dot(...,
preferred_element_type=f32).astype(x.dtype)``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..ops import fused as _fused
from . import axis_ops


def column_parallel(x, w, b=None, *, axis, gather_output: bool = False):
    """``x @ w_local (+ b_local)`` with ``w`` sharded on its last (output)
    axis; the outputs stay feature-sharded unless ``gather_output``."""
    y = x @ w
    if b is not None:
        y = y + b
    if gather_output:
        y = axis_ops.all_gather(y, axis, dim=y.dim() - 1)
    return y


def row_parallel(x, w, b=None, *, axis, input_is_parallel: bool = True,
                 fuse: Optional[bool] = None,
                 fuse_chunks: Optional[int] = None):
    """``psum(x_local @ w_local) (+ b)`` with ``w`` sharded on its first
    (input) axis.  ``input_is_parallel=False`` takes this rank's slice of
    a replicated ``x`` here.  The product and its ``psum`` are chunked
    along ``x``'s first axis (see the module docstring)."""
    if not input_is_parallel:
        x = local_shard(x, x.dim() - 1, axis=axis)

    def closer(xc):
        return axis_ops.psum(xc @ w, axis, async_op=True)

    y = _fused.chunked_map(closer, x, axis=0, chunks=fuse_chunks, fuse=fuse)
    if b is not None:
        y = y + b
    return y


def row_parallel_scatter(x, w, b_local=None, *, axis,
                         fuse: Optional[bool] = None,
                         fuse_chunks: Optional[int] = None):
    """``psum_scatter(x_local @ w_local)`` over the last (feature) axis:
    each rank keeps its shard of the sum, 1/n of :func:`row_parallel`'s
    bytes.  ``b_local`` is this rank's shard of the bias."""

    def closer(xc):
        yc = xc @ w
        return axis_ops.psum_scatter(yc, axis, scatter_dimension=yc.dim() - 1,
                                     async_op=True)

    y = _fused.chunked_map(closer, x, axis=0, chunks=fuse_chunks, fuse=fuse)
    if b_local is not None:
        y = y + b_local
    return y


def gather_column_parallel(x, w, b=None, *, axis,
                           fuse: Optional[bool] = None,
                           fuse_chunks: Optional[int] = None):
    """``all_gather(x) @ w_local``: ``x`` arrives feature-sharded (from
    :func:`row_parallel_scatter`), ``w`` is sharded on its output axis."""

    def opener(xc):
        return axis_ops.all_gather(xc, axis, dim=xc.dim() - 1) @ w

    y = _fused.chunked_map(opener, x, axis=0, chunks=fuse_chunks, fuse=fuse)
    if b is not None:
        y = y + b
    return y


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def tp_mlp(x, w_in, b_in, w_out, b_out, *, axis, activation=_gelu,
           fuse: Optional[bool] = None, fuse_chunks: Optional[int] = None):
    """The Megatron MLP: column-parallel up-projection, the activation on
    the sharded features, row-parallel down-projection (one ``psum``)."""
    h = activation(column_parallel(x, w_in, b_in, axis=axis))
    return row_parallel(h, w_out, b_out, axis=axis, fuse=fuse,
                        fuse_chunks=fuse_chunks)


def local_shard(full: torch.Tensor, dim: int, *, axis) -> torch.Tensor:
    """This rank's shard of ``full`` along ``dim`` (a view; ``full``
    itself over one rank)."""
    if axis.size == 1:
        return full
    size = full.shape[dim] // axis.size
    return full.narrow(dim, axis.index * size, size)
