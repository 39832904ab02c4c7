"""Move parameter trees between the JAX package and the port, through numpy.

The port keeps the reference's parameter layout (same keys, ``[in, out]``
weights, layers stacked on a leading axis), so conversion is a copy of
each leaf, never a transpose.  bfloat16 leaves travel as their 16-bit
patterns (numpy has no bfloat16 of its own; JAX's comes from
``ml_dtypes``), so a round trip is bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .tree import tree_map


def _to_torch(x, device):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        t = torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(x.copy())
    return t.to(device)


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # JAX's numpy bfloat16; needed only for bf16 leaves

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_from_jax(tree, device=None, requires_grad: bool = True):
    """A tree of numpy (or JAX) arrays -> the port's tree of tensors on
    ``device``, leaves requiring grad."""
    return tree_map(lambda x: _to_torch(x, device).requires_grad_(
        requires_grad), tree)


def params_to_numpy(params):
    """The port's tree of tensors -> the same tree of numpy arrays."""
    return tree_map(_to_numpy, params)


def word2vec_from_jax(params, device=None, sparse: bool = True):
    """The reference's ``Word2VecParams`` (numpy or JAX arrays, in its
    field order) -> the port's :class:`~..models.word2vec.Word2Vec` on
    ``device``, the same values."""
    from ..models.word2vec import Word2Vec, Word2VecParams

    return Word2Vec(Word2VecParams(*(_to_torch(x, device) for x in params)),
                    sparse=sparse)
