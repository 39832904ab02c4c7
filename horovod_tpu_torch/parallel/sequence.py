"""Sequence parallelism: ring attention and Ulysses all-to-all attention,
on the port's flash kernels (port of horovod_tpu/parallel/sequence.py).

* **Ring attention** (:func:`ring_attention`): q, k, v arrive sharded
  along the sequence (rank ``i`` of the seq axis holds rows
  ``[i*s, (i+1)*s)``).  K/V chunks travel round the ring while each rank
  attends its q shard to the chunk it holds, merging the partial
  results with the online log-sum-exp rule in f32.  The backward runs
  the flash backward on each chunk with the *global* ``o`` and ``lse``,
  under which each chunk's probabilities are exact, and the dK/dV
  accumulators (f32) travel with their chunks until they are home.
* **Ulysses** (:func:`ulysses_attention`): one all-to-all from sequence-
  to head-sharding, flash attention over the whole sequence for
  ``heads / n`` heads, one all-to-all back.

One hop is a plain function of ``(q, k_c, v_c, src, my, ...)``:
:func:`_forward_hop` and :func:`_backward_hop`; the rotation is a
separate step.  ``src`` (the chunk's home) and ``my`` (this rank) are
Python ints, so the reference's ``lax.switch`` is a branch: the diagonal
chunk runs the causal kernel, a past chunk the non-causal one, and a
future chunk launches nothing and leaves the accumulators as they are
(the reference merges a zeros/-inf partial, which changes no value).  A
causal ring of ``n`` thus launches ``my + 1`` of each flash kernel on
rank ``my``; a non-causal ring ``n`` on every rank.

Each hop's ``batch_isend_irecv`` to the next rank (and from the one
before) is posted before the hop's kernels, so the transfer overlaps
them; the result does not depend on it.  A ring of one posts nothing.
The backward rotates K and V ``n - 1`` times and dK/dV ``n`` times (the
reference also sends K and V the last hop home, which nothing reads).

CUDA tensors launch the kernels or raise; CPU tensors take the plain
versions (:mod:`..ops.flash_attention`).  The axis is a
:class:`~..core.topology.MeshAxis` (``axis=mesh.axis("seq")``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.flash_attention import (flash_attention, flash_attention_with_lse,
                                   flash_backward)
from . import axis_ops


def _merge_partial(o_acc, lse_acc, o_p, lse_p):
    """Online-softmax merge of two partial attentions over the same rows,
    in f32; an ``lse`` of -inf (no visible key) weighs zero, with no NaN
    (``logaddexp(-inf, -inf)`` is -inf)."""
    lse_new = torch.logaddexp(lse_acc, lse_p)
    safe = torch.where(torch.isneginf(lse_new), 0.0, lse_new)
    w_acc = torch.where(torch.isneginf(lse_acc), 0.0,
                        torch.exp(lse_acc - safe))
    w_p = torch.where(torch.isneginf(lse_p), 0.0, torch.exp(lse_p - safe))
    return o_acc * w_acc[..., None] + o_p * w_p[..., None], lse_new


def _visible(src: int, my: int, causal: bool) -> Optional[bool]:
    """The mask a chunk from rank ``src`` needs on rank ``my``: True
    (diagonal, causal), False (all visible) or None (all in the future:
    skip)."""
    if not causal or src < my:
        return False
    return True if src == my else None


def _attend_chunk(q, k_c, v_c, src: int, my: int, causal: bool,
                  sm_scale: float):
    """``(o_p, lse_p)`` of the local q shard against one K/V chunk, or
    None for a chunk wholly in the future."""
    mask = _visible(src, my, causal)
    if mask is None:
        return None
    return flash_attention_with_lse(q, k_c, v_c, causal=mask,
                                    sm_scale=sm_scale)


def _chunk_grads(q, k_c, v_c, o, lse, g, src: int, my: int, causal: bool,
                 sm_scale: float):
    """``(dq_p, dk_c, dv_c)`` for one chunk from the global ``o``/``lse``,
    or None for a chunk wholly in the future."""
    mask = _visible(src, my, causal)
    if mask is None:
        return None
    return flash_backward((q, k_c, v_c, o, lse), g, sm_scale=sm_scale,
                          causal=mask)


def _forward_hop(q, k_c, v_c, src, my, causal, sm_scale, o, lse):
    """One hop of the forward: attend to the chunk and merge it into the
    accumulators ``(o, lse)`` (None before the first hop).  The first
    partial is kept as it came (its f32 value is exact) and the merge is
    in f32, so a ring of one converts nothing."""
    part = _attend_chunk(q, k_c, v_c, src, my, causal, sm_scale)
    if part is None:
        return o, lse
    o_p, lse_p = part
    if o is None:
        return o_p, lse_p
    return _merge_partial(o.float(), lse, o_p.float(), lse_p)


def _add(acc, part):
    """``acc + part`` in f32; the first term kept as it came."""
    return part if acc is None else acc.float() + part.float()


def _backward_hop(q, k_c, v_c, o, lse, g, src, my, causal, sm_scale,
                  dq, dk_c, dv_c):
    """One hop of the backward: the chunk's gradients added to the f32
    accumulators ``dq`` (this rank's) and ``dk_c``/``dv_c`` (the
    chunk's; None before their first term)."""
    part = _chunk_grads(q, k_c, v_c, o, lse, g, src, my, causal, sm_scale)
    if part is None:
        return dq, dk_c, dv_c
    dq_p, dk_p, dv_p = part
    return _add(dq, dq_p), _add(dk_c, dk_p), _add(dv_c, dv_p)


def _rotate(tensors, axis):
    """Post the rotation of ``tensors`` to the next rank of the ring:
    ``(received, works)``."""
    works = []
    return axis_ops._ppermute(tensors, axis, 1, works), works


def _done(works):
    for work in works:
        work.wait()


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, axis, causal, sm_scale):
        n, my = axis.size, axis.index
        o = lse = None
        k_c, v_c = k, v
        for t in range(n):
            nxt = _rotate([k_c, v_c], axis) if t != n - 1 else None
            o, lse = _forward_hop(q, k_c, v_c, (my - t) % n, my, causal,
                                  sm_scale, o, lse)
            if nxt is not None:
                (k_c, v_c), works = nxt
                _done(works)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (axis, causal, sm_scale)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        axis, causal, sm_scale = ctx.args
        n, my = axis.size, axis.index
        g = g.contiguous()
        dq = dk_c = dv_c = None
        k_c, v_c = k, v
        for t in range(n):
            nxt = _rotate([k_c, v_c], axis) if t != n - 1 else None
            dq, dk_c, dv_c = _backward_hop(q, k_c, v_c, o, lse, g,
                                           (my - t) % n, my, causal,
                                           sm_scale, dq, dk_c, dv_c)
            if n > 1:
                # The accumulators travel with their chunk: after the
                # n-th rotation each chunk's dK/dV is home.
                (dk_c, dv_c), works = _rotate([dk_c, dv_c], axis)
                _done(works)
            if nxt is not None:
                (k_c, v_c), works = nxt
                _done(works)
        return (dq.to(q.dtype), dk_c.to(k.dtype), dv_c.to(v.dtype), None,
                None, None)


def play_ring(q, k, v, g, n: int, *, causal: bool,
              sm_scale: Optional[float] = None):
    """A ring of ``n`` played in one process, for holding the hop
    functions on one device: ``q, k, v, g`` are the whole sequence's
    ``[b, h, n*s, d]`` tensors and the output gradient; virtual rank
    ``i`` holds chunk ``i``.  Each virtual rank runs the hops
    :class:`_Ring` runs on rank ``i`` of a real ring, in the same order,
    and the dK/dV accumulators visit the ranks in the ring's order, so
    the results are a real ring's bits.  Returns ``(o, dq, dk, dv)`` over
    the whole sequence."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    qs, ks, vs, gs = ([c.contiguous() for c in x.chunk(n, dim=2)]
                      for x in (q, k, v, g))
    o, lse = [None] * n, [None] * n
    for t in range(n):
        for my in range(n):
            src = (my - t) % n
            o[my], lse[my] = _forward_hop(qs[my], ks[src], vs[src], src, my,
                                          causal, sm_scale, o[my], lse[my])
    o = [x.to(q.dtype) for x in o]
    dq, dk, dv = [None] * n, [None] * n, [None] * n
    for t in range(n):
        for my in range(n):
            src = (my - t) % n
            dq[my], dk[src], dv[src] = _backward_hop(
                qs[my], ks[src], vs[src], o[my], lse[my], gs[my], src, my,
                causal, sm_scale, dq[my], dk[src], dv[src])
    return (torch.cat(o, dim=2), torch.cat(dq, dim=2).to(q.dtype),
            torch.cat(dk, dim=2).to(k.dtype), torch.cat(dv, dim=2).to(v.dtype))


def ring_attention(q, k, v, *, axis, causal: bool = False,
                   sm_scale: Optional[float] = None, block_q: int = 128,
                   block_k: int = 128):
    """Attention over a sequence sharded on ``axis``'s ring.

    ``q, k, v: [batch, heads, seq_local, head_dim]``, rank ``i`` of the
    axis holding rows ``[i*seq_local, (i+1)*seq_local)``.  Differentiable;
    matches dense attention over the whole sequence.  ``block_q`` and
    ``block_k`` are kept for the reference's signature (the kernels
    choose their tiles)."""
    del block_q, block_k
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, axis, bool(causal), float(sm_scale))


def ulysses_attention(q, k, v, *, axis, causal: bool = False,
                      sm_scale: Optional[float] = None, block_q: int = 128,
                      block_k: int = 128):
    """All-to-all sequence parallelism (DeepSpeed-Ulysses): re-shard q, k,
    v from sequence to heads, run flash attention over the whole sequence
    for ``heads / n`` heads, re-shard back.  The head count must divide
    by the axis size."""
    n, h = axis.size, q.shape[1]
    if h % n != 0:
        raise ValueError(f"ulysses_attention needs heads ({h}) divisible "
                         f"by the '{axis.name}' axis size ({n})")

    def to_heads(x):  # [B, H, S/n, D] -> [B, H/n, S, D]
        return axis_ops.all_to_all(x, axis, split_axis=1, concat_axis=2)

    o = flash_attention(to_heads(q), to_heads(k), to_heads(v), causal=causal,
                        sm_scale=sm_scale, block_q=block_q, block_k=block_k)
    # [B, H/n, S, D] -> [B, H, S/n, D]
    return axis_ops.all_to_all(o, axis, split_axis=2, concat_axis=1)
