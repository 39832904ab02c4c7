"""Move parameter trees between the JAX package and the port, through numpy.

The port keeps the reference's parameter layout (same keys, ``[in, out]``
weights, layers stacked on a leading axis), so conversion is a copy of
each leaf, never a transpose.  bfloat16 leaves travel as their 16-bit
patterns (numpy has no bfloat16 of its own; JAX's comes from
``ml_dtypes``), so a round trip is bitwise.

:func:`serving_shard` cuts one rank's serving parameters of a ``model``
axis out of the full tree (the layout the reference's GSPMD sharding
gives each device).
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


# Per layer: the leaves each rank of a ``model`` axis cuts along which
# dimension of the per-layer leaf (after the stacked layer axis), in
# units of heads (the attention) or of columns of d_ff (the FFN).
_COLUMN_HEADS = ("wq", "wk", "wv")   # [d, d]: the rank's heads' columns
_ROW_HEADS = ("wo",)                 # [d, d]: the rank's heads' rows
_COLUMN_FF = ("w_in", "b_in")        # [d, f], [f]: the rank's columns
_ROW_FF = ("w_out",)                 # [f, d]: the rank's rows


def serving_shard(params: dict, cfg, index: int, size: int) -> dict:
    """Rank ``index`` of a ``model`` axis of ``size``: its heads' columns
    of ``wq``/``wk``/``wv`` (and so of the fused ``wqkv``), their rows of
    ``wo``, its slice of FFN-in's columns and bias and of FFN-out's rows;
    every other leaf whole (embeddings, layer norms, ``b_out``, the
    unembedding).  The cut leaves are copies, so the full tree need not
    stay alive; ``size`` 1 returns ``params`` itself."""
    if size == 1:
        return params
    if cfg.n_heads % size or cfg.d_ff % size:
        raise ValueError(f"model axis {size} must divide n_heads "
                         f"({cfg.n_heads}) and d_ff ({cfg.d_ff})")
    dl = cfg.d_model // size
    fl = cfg.d_ff // size
    layers = {}
    for k, v in params["layers"].items():
        if k in _COLUMN_HEADS:
            v = v[..., index * dl:(index + 1) * dl].contiguous()
        elif k in _ROW_HEADS:
            v = v[:, index * dl:(index + 1) * dl].contiguous()
        elif k in _COLUMN_FF:
            v = v[..., index * fl:(index + 1) * fl].contiguous()
        elif k in _ROW_FF:
            v = v[:, index * fl:(index + 1) * fl].contiguous()
        elif k == "wqkv":
            raise ValueError("shard the training tree (wq, wk, wv), not "
                             "serving_params' fused wqkv")
        layers[k] = v
    return {**params, "layers": layers}

