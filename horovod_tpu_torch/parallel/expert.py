"""Expert parallelism: a Mixture-of-Experts layer with all_to_all token
routing (port of horovod_tpu/parallel/expert.py).

The Switch/GShard form over a mesh axis: each rank holds
``num_experts / n`` expert MLPs; a router picks the top-k experts of
each token under a per-expert capacity; one ``all_to_all`` sends each
expert its tokens from every rank, a second brings the outputs back,
and they are combined by router weight.  Dispatch and combine are dense
one-hot ``[tokens, E, capacity]`` tensors and f32 einsums, the
reference's numbers exactly (a sparse dispatch would be another
function).

The round trip (dispatch all_to_all, expert FFN, combine all_to_all) is
chunked along the capacity axis by :func:`..ops.fused.chunked_map`:
capacity rows are free of reductions and the combine all_to_all undoes
the dispatch one's permutation chunk by chunk, so the chunked output is
the unchunked one's bytes.  Routing (router product, top-k, aux loss)
stays whole.  Expert parallelism rides the data axis by convention; a
dedicated expert axis works alike.  The axis is a
:class:`~..core.topology.MeshAxis`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops import fused as _fused
from . import axis_ops


class MoEOutput(NamedTuple):
    out: torch.Tensor               # [tokens, d_model]
    aux_loss: torch.Tensor          # scalar load-balancing loss, f32
    dropped_fraction: torch.Tensor  # scalar, tokens beyond capacity


def init_moe_params(generator: torch.Generator, num_experts: int,
                    d_model: int, d_hidden: int,
                    dtype: torch.dtype = torch.float32, device=None) -> dict:
    """Full (unsharded) router and expert stack, normal draws from
    ``generator`` on the CPU scaled as the reference's; index the
    leading expert axis with :func:`local_experts` before use."""

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (x.to(dtype) * scale).to(device)

    return {"router": normal((d_model, num_experts), d_model ** -0.5),
            "w_in": normal((num_experts, d_model, d_hidden),
                           d_model ** -0.5),
            "w_out": normal((num_experts, d_hidden, d_model),
                            d_hidden ** -0.5)}


def local_experts(params: dict, *, axis) -> dict:
    """This rank's expert shard of replicated full params (views); the
    router stays whole."""
    n, idx = axis.size, axis.index

    def shard(leaf):
        size = leaf.shape[0] // n
        return leaf if n == 1 else leaf.narrow(0, idx * size, size)

    return {"router": params["router"], "w_in": shard(params["w_in"]),
            "w_out": shard(params["w_out"])}


def _top_k_dispatch(probs, k: int, capacity: int):
    """Greedy top-k routing with per-expert capacity (reference :88):
    dispatch ``[t, E, C]`` (0/1), combine ``[t, E, C]`` (gate-weighted)
    and the dropped-token fraction.  ``argmax`` takes the first maximum
    and the one-hot cumsum is exact in f32, so it is the reference's
    bitwise."""
    tokens, num_experts = probs.shape
    dt = probs.dtype
    remaining = probs
    dispatch = probs.new_zeros((tokens, num_experts, capacity))
    combine = probs.new_zeros((tokens, num_experts, capacity))
    fill = torch.zeros((num_experts,), dtype=torch.int32,
                       device=probs.device)
    routed = probs.new_zeros((tokens,))
    for _ in range(k):
        choice = torch.argmax(remaining, dim=-1)                     # [t]
        gate = torch.gather(remaining, -1, choice[:, None])[:, 0]    # [t]
        onehot = F.one_hot(choice, num_experts).to(dt)               # [t, E]
        # Position within the chosen expert's buffer: earlier tokens
        # first, after the current fill.
        pos = torch.cumsum(onehot, dim=0) - 1.0 + fill[None, :].to(dt)
        pos_tok = torch.sum(pos * onehot, dim=-1)                    # [t]
        keep = pos_tok < capacity
        pos_oh = F.one_hot(pos_tok.clamp(0, capacity - 1).to(torch.int64),
                           capacity).to(dt)                          # [t, C]
        d = (onehot * keep[:, None].to(dt))[:, :, None] * pos_oh[:, None, :]
        dispatch = dispatch + d
        combine = combine + d * gate[:, None, None]
        fill = fill + torch.sum(onehot * keep[:, None].to(dt),
                                dim=0).to(torch.int32)
        routed = routed + keep.to(dt)
        remaining = remaining * (1.0 - onehot)
    dropped = 1.0 - torch.mean(routed) / k
    return dispatch, combine, dropped


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def moe_layer(x, params: dict, *, axis, num_experts: int, top_k: int = 2,
              capacity_factor: float = 1.25, activation=_gelu,
              aux_loss_weight: float = 1e-2, fuse: Optional[bool] = None,
              fuse_chunks: Optional[int] = None) -> MoEOutput:
    """Expert-sharded MoE FFN over ``axis``.

    Args:
      x: ``[tokens_local, d_model]``, this rank's tokens.
      params: ``router [d, E]`` (whole), ``w_in [E_local, d, h]``,
        ``w_out [E_local, h, d]`` (sharded, e.g. by
        :func:`local_experts`).
      num_experts: the global expert count E (must divide by the axis
        size).
      fuse, fuse_chunks: override ``HVD_TPU_FUSE``/``HVD_TPU_FUSE_CHUNKS``
        for the capacity-chunked round trip (the same output either way).
    """
    n = axis.size
    tokens, d_model = x.shape
    e_local = num_experts // n
    if e_local * n != num_experts:
        raise ValueError(f"num_experts ({num_experts}) must divide by the "
                         f"'{axis.name}' axis size ({n})")
    if params["w_in"].shape[0] != e_local:
        raise ValueError(
            f"params carry {params['w_in'].shape[0]} local experts but "
            f"num_experts/axis_size = {e_local}; shard them with "
            f"local_experts() first")
    capacity = max(1, int(tokens * capacity_factor * top_k / num_experts))

    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    dispatch, combine, dropped = _top_k_dispatch(probs, top_k, capacity)

    # Switch Transformer's load-balancing loss: fraction of tokens per
    # expert x mean router probability per expert.
    token_frac = torch.mean(torch.sum(dispatch, dim=-1), dim=0)
    prob_frac = torch.mean(probs, dim=0)
    aux = aux_loss_weight * num_experts * torch.sum(token_frac * prob_frac)

    # [t, d] x [t, E, C] -> [E, C, d]: each expert's buffer.
    expert_in = torch.einsum("td,tec->ecd", x.float(), dispatch)
    w_in = params["w_in"].float()
    w_out = params["w_out"].float()

    def roundtrip(buf):
        # One capacity chunk out and back: [E, c, d] -> [E_local, n*c, d]
        # -> the local experts -> [E, c, d].
        buf = axis_ops.all_to_all(buf, axis, split_axis=0, concat_axis=1)
        h = activation(torch.einsum("ecd,edh->ech", buf, w_in))
        o = torch.einsum("ech,ehd->ecd", h, w_out)
        return axis_ops.all_to_all(o, axis, split_axis=1, concat_axis=0,
                                   async_op=True)

    expert_out = _fused.chunked_map(roundtrip, expert_in, axis=1,
                                    chunks=fuse_chunks, fuse=fuse)
    out = torch.einsum("ecd,tec->td", expert_out, combine)
    return MoEOutput(out.to(x.dtype), aux.float(), dropped.float())
