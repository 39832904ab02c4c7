"""Decoder-only transformer LM, data-parallel path (port of
horovod_tpu/models/transformer.py).

Parameters keep the reference's layout: a nested dict of tensors with the
same keys, ``x @ W`` with ``W`` as ``[in, out]``, and per-layer leaves
stacked on a leading ``n_layers`` axis, so :mod:`..utils.convert` moves a
JAX parameter tree in by copying.  Attention runs the port's flash
kernels (:mod:`..ops.flash_attention`).

Numerics, against the reference:

* products of bf16 tensors take bf16 operands with f32 accumulation and
  round to bf16, which ``torch.matmul`` on bf16 does, as the reference's
  ``jnp.dot(..., preferred_element_type=f32).astype(x.dtype)``;
* the logits are f32 (reference :306-307): the port upcasts the final
  hidden states and the unembedding to f32 and multiplies in f32, which
  gives the reference's values up to summation order; in bf16 training
  this product runs outside the tensor cores (its cost is in PERF.md);
* GELU is the tanh approximation, ``jax.nn.gelu``'s default;
* layer norm takes the population variance, eps 1e-5.

**Parallelism** (reference :1-24, :136-368).  :class:`ParallelAxes`
names the mesh axis of each strategy and ``mesh`` (a
:class:`~..core.topology.Mesh`) carries their groups: tensor
parallelism shards the heads and the MLP's hidden features over
``model`` (:mod:`..parallel.tensor`), sequence parallelism runs ring
attention over ``seq`` (:mod:`..parallel.sequence`), and with
``num_experts > 0`` every FFN is a mixture of experts over ``expert``
(or ``data``; :mod:`..parallel.expert`).  Pipeline parallelism
(``pipe``) runs the layers as :func:`..parallel.pipeline.gpipe` stages
over the pipe axis, ``ax.num_microbatches`` microbatches (dense FFN
layers only).  Parameters are stored whole
and each rank slices its shard in the forward.  :func:`make_loss_fn`
averages the loss over the mesh (:func:`..parallel.axis_ops.pmean_loss`)
for :func:`..parallel.training.make_parallel_train_step`.  Without a
mesh every named axis has one rank, and the default axes run exactly
the data-parallel model.  ``cfg.remat`` recomputes each layer in the
backward pass (``torch.utils.checkpoint``).

**Serving** (reference :444-659): :func:`forward_step`,
:func:`speculative_propose` and :func:`serving_forward` run the
incremental decode against a fixed-capacity KV view with no flash
attention: every product is :func:`..ops.serving.serving_gemm` and the
attention is :func:`..ops.serving.cache_attention`, both summing in an
order that does not depend on the number of rows, so a prefill plus N
one-token decodes gives the non-incremental forward's logits bitwise.

:func:`chained_lm_loss` is the same loss in stages, for the overlapped
step (``parallel/overlap.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core import topology as T
from ..ops.flash_attention import flash_attention
from ..ops.serving import cache_attention, gelu_tanh, serving_gemm
from ..parallel.axis_ops import pmean_loss
from ..parallel.expert import local_experts, moe_layer
from ..parallel.pipeline import gpipe
from ..parallel.sequence import ring_attention
from ..parallel.tensor import (column_parallel, local_shard, row_parallel,
                               tp_mlp)
from ..utils.tree import tree_map


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 512
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.float32
    # Mixture-of-experts FFN on every layer when num_experts > 0.
    num_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 2.0
    # Kept for the reference's signature: the kernels choose their tiles.
    block_q: int = 128
    block_k: int = 128
    # Recompute each layer in the backward pass instead of storing its
    # activations (torch.utils.checkpoint).
    remat: bool = False
    # Chunked cross-entropy over sequence chunks of this many positions,
    # recomputing each chunk's logits in the backward pass; 0 = off.
    loss_chunk: int = 0


@dataclass(frozen=True)
class ParallelAxes:
    """Which mesh axis serves each strategy (None = off)."""
    data: Optional[str] = T.DATA_AXIS
    model: Optional[str] = None
    seq: Optional[str] = None
    pipe: Optional[str] = None
    expert: Optional[str] = None  # conventionally = data
    num_microbatches: int = 2     # pipeline depth-filling factor


@dataclass(frozen=True)
class _Axes:
    """The :class:`~..core.topology.MeshAxis` of each strategy (None =
    off), resolved from a :class:`ParallelAxes` and a mesh."""
    data: Optional[T.MeshAxis] = None
    model: Optional[T.MeshAxis] = None
    seq: Optional[T.MeshAxis] = None
    pipe: Optional[T.MeshAxis] = None
    expert: Optional[T.MeshAxis] = None


def _resolve_axes(ax: ParallelAxes, mesh) -> _Axes:
    def one(name):
        if name is None:
            return None
        return mesh.axis(name) if mesh is not None else T.MeshAxis.local(
            name)

    return _Axes(data=one(ax.data), model=one(ax.model), seq=one(ax.seq),
                 pipe=one(ax.pipe), expert=one(ax.expert))


def _check_config(cfg: TransformerConfig) -> None:
    if cfg.d_model % cfg.n_heads:
        raise ValueError(f"d_model {cfg.d_model} not divisible by n_heads "
                         f"{cfg.n_heads}")


def init_transformer(generator: torch.Generator, cfg: TransformerConfig,
                     device=None) -> dict:
    """Parameter tree with the reference's keys, shapes and distributions
    (normal draws scaled as in horovod_tpu init_transformer).  Draws come
    from ``generator`` on the CPU, so a seed gives the same weights on
    every device; leaves are moved to ``device`` and require grad."""
    _check_config(cfg)
    n, d, f, v = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    dt = cfg.dtype
    s_d = d ** -0.5

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return x.to(dt) * scale

    def ones(*shape):
        return torch.ones(shape, dtype=dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt)

    p = {
        "embed": normal((v, d), 0.02),
        "pos_embed": normal((cfg.max_seq_len, d), 0.02),
        "ln_f": {"scale": ones(d), "bias": zeros(d)},
        "unembed": normal((d, v), s_d),
        "layers": {
            "ln1": {"scale": ones(n, d), "bias": zeros(n, d)},
            "wq": normal((n, d, d), s_d),
            "wk": normal((n, d, d), s_d),
            "wv": normal((n, d, d), s_d),
            "wo": normal((n, d, d), s_d),
            "ln2": {"scale": ones(n, d), "bias": zeros(n, d)},
        },
    }
    if cfg.num_experts > 0:
        e = cfg.num_experts
        p["layers"]["router"] = normal((n, d, e), s_d)
        p["layers"]["moe_w_in"] = normal((n, e, d, f), s_d)
        p["layers"]["moe_w_out"] = normal((n, e, f, d), f ** -0.5)
    else:
        p["layers"]["w_in"] = normal((n, d, f), s_d)
        p["layers"]["b_in"] = zeros(n, f)
        p["layers"]["w_out"] = normal((n, f, d), f ** -0.5)
        p["layers"]["b_out"] = zeros(n, d)
    return tree_map(lambda x: x.to(device).requires_grad_(), p)


def _layernorm(x, scale, bias, eps: float = 1e-5):
    """Population variance, eps 1e-5 (reference :130)."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def _attention_block(x, lp, cfg: TransformerConfig, axes: _Axes = _Axes()):
    """Pre-LN causal self-attention: one fused [d, 3d] QKV product split
    in q, k, v order (its output features, and so the heads, sharded over
    ``model``), the flash kernels or ring attention over ``seq``, the
    output projection (row-parallel over ``model``)."""
    b, s, d = x.shape
    hd = d // cfg.n_heads
    h = _layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
    model = axes.model
    if model is not None:
        mp = model.size
        if cfg.n_heads % mp != 0 or d % mp != 0:
            raise ValueError(
                f"tensor-parallel degree {mp} must divide both "
                f"n_heads ({cfg.n_heads}) and d_model ({d})")
        wq, wk, wv = (local_shard(lp[w], 1, axis=model)
                      for w in ("wq", "wk", "wv"))
        wo = local_shard(lp["wo"], 0, axis=model)
    else:
        wq, wk, wv, wo = lp["wq"], lp["wk"], lp["wv"], lp["wo"]
        mp = 1
    heads = cfg.n_heads // mp
    qkv = column_parallel(h, torch.cat([wq, wk, wv], dim=-1), axis=model)
    q, k, v = (y.reshape(b, s, heads, hd).transpose(1, 2)
               for y in qkv.split(heads * hd, dim=-1))
    if axes.seq is not None:
        attn = ring_attention(q, k, v, axis=axes.seq, causal=True)
    else:
        attn = flash_attention(q, k, v, causal=True)
    attn = attn.transpose(1, 2).reshape(b, s, heads * hd)
    if model is not None:
        return x + row_parallel(attn, wo, axis=model)
    return x + attn @ wo


def _ffn_block(x, lp, cfg: TransformerConfig, axes: _Axes = _Axes()):
    """Pre-LN FFN: the dense MLP with tanh-approximated GELU
    (jax.nn.gelu's default), tensor-parallel over ``model``, or the MoE
    over ``expert`` (else ``data``).  Returns ``(x, aux)``; aux is None
    for the dense MLP."""
    b, s, d = x.shape
    h = _layernorm(x, lp["ln2"]["scale"], lp["ln2"]["bias"])
    if cfg.num_experts > 0:
        ep = axes.expert or axes.data
        if ep is None:
            raise ValueError("MoE needs an expert (or data) mesh axis")
        params = local_experts({"router": lp["router"],
                                "w_in": lp["moe_w_in"],
                                "w_out": lp["moe_w_out"]}, axis=ep)
        out = moe_layer(h.reshape(b * s, d), params, axis=ep,
                        num_experts=cfg.num_experts, top_k=cfg.top_k,
                        capacity_factor=cfg.capacity_factor)
        return x + out.out.reshape(b, s, d), out.aux_loss
    if axes.model is not None:
        m = axes.model
        y = tp_mlp(h, local_shard(lp["w_in"], 1, axis=m),
                   local_shard(lp["b_in"], 0, axis=m),
                   local_shard(lp["w_out"], 0, axis=m), lp["b_out"], axis=m)
        return x + y, None
    hh = F.gelu(h @ lp["w_in"] + lp["b_in"], approximate="tanh")
    return x + (hh @ lp["w_out"] + lp["b_out"]), None


def _layer(x, lp, cfg: TransformerConfig, axes: _Axes):
    return _ffn_block(_attention_block(x, lp, cfg, axes), lp, cfg, axes)


def _layer_remat(x, lp, cfg: TransformerConfig, axes: _Axes):
    """:func:`_layer`, its activations recomputed in the backward pass
    (reference :219-230, ``jax.checkpoint``)."""
    return checkpoint(_layer, x, lp, cfg, axes, use_reentrant=False,
                      preserve_rng_state=False)


def _index_layer(layers: dict, i: int) -> dict:
    return tree_map(lambda leaf: leaf[i], layers)


def _pipeline_layers(x, layers: dict, cfg: TransformerConfig, axes: _Axes,
                     layer, num_microbatches: int):
    """The layers as :func:`~..parallel.pipeline.gpipe` stages over the
    pipe axis, ``n_layers / stages`` consecutive layers a stage
    (reference :270-297)."""
    pipe = axes.pipe
    per_stage = cfg.n_layers // pipe.size
    if per_stage * pipe.size != cfg.n_layers:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"pipeline stages {pipe.size}")
    # The MoE aux loss would have to ride the activations (reference).
    if cfg.num_experts > 0:
        raise ValueError("pipeline parallelism currently supports dense "
                         "FFN layers only (num_experts == 0)")
    start = pipe.index * per_stage
    mine = tree_map(lambda leaf: leaf[start:start + per_stage], layers)

    def stage_fn(stage_params, x_mb):
        for i in range(per_stage):
            x_mb, _ = layer(x_mb, _index_layer(stage_params, i), cfg, axes)
        return x_mb

    return gpipe(stage_fn, mine, x, num_microbatches=num_microbatches,
                 axis=pipe)


def _forward(params: dict, tokens, cfg: TransformerConfig,
             ax: ParallelAxes, mesh, return_hidden: bool):
    """``(logits or hidden, aux)``; aux is None without experts."""
    _check_config(cfg)
    axes = _resolve_axes(ax, mesh)
    b, s = tokens.shape
    seq_off, global_seq = 0, s
    if axes.seq is not None:
        seq_off, global_seq = axes.seq.index * s, s * axes.seq.size
    if global_seq > cfg.max_seq_len:
        raise ValueError(
            f"global sequence length {global_seq} exceeds cfg.max_seq_len "
            f"{cfg.max_seq_len}; positions would clamp silently")
    x = params["embed"][tokens] + params["pos_embed"][seq_off:seq_off + s]
    layer = _layer_remat if cfg.remat else _layer
    aux = None
    if axes.pipe is not None:
        x = _pipeline_layers(x, params["layers"], cfg, axes, layer,
                             ax.num_microbatches)
    else:
        for i in range(cfg.n_layers):
            x, aux_i = layer(x, _index_layer(params["layers"], i), cfg,
                             axes)
            if aux_i is not None:
                aux = aux_i if aux is None else aux + aux_i
    x = _layernorm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    if return_hidden:
        return x, aux
    return _logits(x, params["unembed"]), aux


def forward(params: dict, tokens, cfg: TransformerConfig,
            ax: ParallelAxes = ParallelAxes(), return_hidden: bool = False,
            *, mesh=None):
    """Logits ``[b, s_loc, vocab]`` in f32 for this rank's ``tokens
    [b, s_loc]`` (int64; the batch sharded over ``ax.data``, the sequence
    shard-major over ``ax.seq``), or with ``return_hidden`` the final
    post-LN hidden states ``[b, s_loc, d]``.  (The reference also returns
    the MoE aux loss; :func:`make_loss_fn` adds it to the loss.)"""
    return _forward(params, tokens, cfg, ax, mesh, return_hidden)[0]


def _logits(x, unembed):
    return x.float() @ unembed.float()


def _nll_sum(x, unembed, targets):
    logp = torch.log_softmax(_logits(x, unembed), dim=-1)
    return -torch.gather(logp, -1, targets[..., None]).sum()


def make_loss_fn(cfg: TransformerConfig, ax: ParallelAxes = ParallelAxes(),
                 mesh_axes=None):
    """``loss_fn(params, (tokens, targets))``: mean next-token
    cross-entropy on this rank's shard of the batch, plus the MoE aux
    loss, averaged over every rank of ``mesh_axes``.

    ``mesh_axes`` is the :class:`~..core.topology.Mesh` (the reference
    passes ``mesh.axis_names``; the port's mesh carries those axes and
    their groups).  Without one the loss is this rank's: the data-
    parallel train step averages it over ranks.  ``cfg.loss_chunk > 0``
    computes the cross-entropy over sequence chunks, recomputing each
    chunk's logits in the backward pass, so the full logits never exist
    at once."""
    mesh = mesh_axes
    if mesh is not None and not isinstance(mesh, T.Mesh):
        raise TypeError(f"mesh_axes must be a topology.Mesh (make_mesh), "
                        f"got {type(mesh).__name__}")

    def dense_ce(params, tokens, targets):
        logits, aux = _forward(params, tokens, cfg, ax, mesh, False)
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets[..., None]).mean(), aux

    def chunked_ce(params, tokens, targets):
        x, aux = _forward(params, tokens, cfg, ax, mesh, True)
        b, s, _ = x.shape
        chunk = min(cfg.loss_chunk, s)
        if s % chunk:
            raise ValueError(f"local sequence length {s} not divisible by "
                             f"loss_chunk {chunk}")
        total = x.new_zeros((), dtype=torch.float32)
        for c in range(0, s, chunk):
            total = total + checkpoint(
                _nll_sum, x[:, c:c + chunk], params["unembed"],
                targets[:, c:c + chunk], use_reentrant=False)
        return total / (b * s), aux

    def loss_fn(params, batch):
        tokens, targets = batch
        ce = chunked_ce if cfg.loss_chunk > 0 else dense_ce
        loss, aux = ce(params, tokens, targets)
        if aux is not None:
            loss = loss + aux
        return pmean_loss(loss, mesh)

    return loss_fn


def chained_lm_loss(cfg: TransformerConfig):
    """The LM loss as a :class:`~..parallel.overlap.ChainedLoss`, the form
    the overlapped step streams gradient buckets out of (reference
    :370-433): stage 0 the embedding, one stage a decoder layer (on the
    flash kernels), the last final LN + unembedding + cross-entropy.
    Calling it computes what :func:`make_loss_fn`'s dense loss computes,
    op for op, so the monolithic step differentiates the same math.  The
    cross-entropy is dense whatever ``cfg.loss_chunk`` says, as in the
    reference.  Pair with :func:`chained_lm_params`."""
    from ..parallel.overlap import ChainedLoss

    _check_config(cfg)
    if cfg.num_experts > 0:
        raise ValueError("chained_lm_loss supports dense FFN layers only "
                         "(num_experts == 0)")

    def embed_stage(p, carry, batch):
        tokens, _targets = batch
        s = tokens.shape[1]
        if s > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {s} exceeds cfg.max_seq_len "
                f"{cfg.max_seq_len}; positions would clamp silently")
        return p["embed"][tokens] + p["pos_embed"][:s]

    def layer_stage(p, carry, batch):
        return _ffn_block(_attention_block(carry, p, cfg), p, cfg)[0]

    def head_stage(p, carry, batch):
        _tokens, targets = batch
        x = _layernorm(carry, p["ln_f"]["scale"], p["ln_f"]["bias"])
        logp = torch.log_softmax(_logits(x, p["unembed"]), dim=-1)
        return -torch.gather(logp, -1, targets[..., None]).mean()

    return ChainedLoss([embed_stage] + [layer_stage] * cfg.n_layers
                       + [head_stage])


def chained_lm_params(params: dict, cfg: TransformerConfig) -> list:
    """An :func:`init_transformer` tree as :func:`chained_lm_loss`'s
    per-stage list ``[embed, layer_0, ..., layer_{n-1}, head]``: new leaf
    tensors (copies; the per-layer leaves taken off the stacked
    ``n_layers`` axis), so each layer's gradients are their own overlap
    segment."""

    def leaf(x):
        return x.detach().clone().requires_grad_()

    out = [{"embed": leaf(params["embed"]),
            "pos_embed": leaf(params["pos_embed"])}]
    out += [tree_map(leaf, _index_layer(params["layers"], i))
            for i in range(cfg.n_layers)]
    out.append({"ln_f": tree_map(leaf, params["ln_f"]),
                "unembed": leaf(params["unembed"])})
    return out


def synthetic_lm_batch(generator: torch.Generator, global_batch: int,
                       seq_len: int, vocab_size: int,
                       device: Optional[torch.device] = None):
    """Synthetic next-token data ``(tokens, targets)``, int64, drawn on the
    CPU from ``generator`` and moved to ``device``."""
    tokens = torch.randint(0, vocab_size, (global_batch, seq_len + 1),
                           generator=generator)
    return tokens[:, :-1].to(device), tokens[:, 1:].to(device)


# ---------------------------------------------------------------------------
# Serving path: incremental decode against a fixed-capacity KV view
# (reference :444-659).  The model half of horovod_tpu_torch/serving/: a
# plain masked-softmax attention whose program is the same for a
# multi-token prefill and a one-token decode step, and products whose
# sums do not depend on the number of rows (ops/serving.py), so the
# engine's "prefill + N decode steps == non-incremental forward"
# contract holds bitwise.  No tensor parallelism here (the reference's
# GSPMD head sharding is later work, ROADMAP.md A.4).
# ---------------------------------------------------------------------------

def serving_params(params: dict) -> dict:
    """``params`` with the layers' fused QKV weight built once:
    ``layers["wqkv"] = [wq | wk | wv]``, ``[n_layers, d, 3d]`` (the one
    product of reference :558).  :func:`forward_step` reads it where it is
    present and otherwise concatenates the three on every call; the
    serving engine builds it when it places its parameters."""
    layers = params["layers"]
    return {**params, "layers": {**layers, "wqkv": torch.cat(
        [layers["wq"], layers["wk"], layers["wv"]], dim=-1)}}


def forward_step(params: dict, tokens, start_pos, k_view, v_view,
                 cfg: TransformerConfig):
    """Cache-aware forward over ``tokens`` given already-cached context
    (reference :496-572): the ONE program both serving phases run.

    ``tokens``: ``[b, s]`` int.  ``start_pos``: ``[b]`` int, the global
    position of ``tokens[:, 0]`` and the number of valid entries the
    view already holds for that sequence (ragged across the batch; < 0
    for an inactive slot).  ``k_view``/``v_view``: ``[n_layers, b,
    capacity, heads, head_dim]`` with positions ``< start_pos``
    populated; they are read, never written.

    Returns ``(logits [b, s, vocab] float32, k_new, v_new)``, the new
    tokens' entries ``[n_layers, b, s, heads, head_dim]`` for the caller
    to scatter into its paged store.  Each layer puts its new entries
    into a copy of that layer's view (``capacity + 1`` entries: a row at
    or past the capacity lands in the extra one and is dropped, the
    reference's ``mode="drop"``).

    Positions at or past ``cfg.max_seq_len`` (a decode block's dummy
    column, a verify block's tail at the capacity boundary) read the last
    row of ``pos_embed``: their outputs are finite garbage where the
    reference's ``jnp.take`` gives NaN.  No caller samples, keeps or
    scatters them into a live position."""
    if cfg.num_experts > 0:
        raise ValueError("the serving path currently supports dense FFN "
                         "layers only (num_experts == 0)")
    _check_config(cfg)
    b, s = tokens.shape
    h_n, d = cfg.n_heads, cfg.d_model
    hd = d // h_n
    cap = k_view.shape[2]
    if cap > cfg.max_seq_len:
        raise ValueError(f"KV capacity {cap} exceeds cfg.max_seq_len "
                         f"{cfg.max_seq_len}")
    dev = tokens.device
    start_pos = start_pos.to(dev)
    ar = torch.arange(s, device=dev)
    pos = start_pos[:, None] + ar[None, :]
    x = (params["embed"][tokens]
         + params["pos_embed"][pos.clamp(0, cfg.max_seq_len - 1)])
    # The per-row put (reference :537-550): every row at its true index,
    # rows past the capacity into the dropped extra entry.
    put_b = torch.arange(b, device=dev)[:, None].expand(b, s)
    put_c = (start_pos.clamp(min=0)[:, None] + ar[None, :]).clamp(max=cap)
    layers = params["layers"]
    if "wqkv" not in layers:
        layers = serving_params(params)["layers"]
    k_news, v_news = [], []
    for i in range(cfg.n_layers):
        lp = _index_layer(layers, i)
        h = _layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
        qkv = serving_gemm(h, lp["wqkv"])
        q, k, v = (y.reshape(b, s, h_n, hd) for y in qkv.split(d, dim=-1))
        views = []
        for view, new in ((k_view[i], k), (v_view[i], v)):
            full = view.new_empty((b, cap + 1, h_n, hd))
            full[:, :cap] = view
            full[put_b, put_c] = new
            views.append(full[:, :cap])
        attn = cache_attention(q, views[0], views[1], pos)
        x = x + serving_gemm(attn.reshape(b, s, d), lp["wo"])
        hh = _layernorm(x, lp["ln2"]["scale"], lp["ln2"]["bias"])
        hh = gelu_tanh(serving_gemm(hh, lp["w_in"]) + lp["b_in"])
        x = x + (serving_gemm(hh, lp["w_out"]) + lp["b_out"])
        k_news.append(k)
        v_news.append(v)
    x = _layernorm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    logits = serving_gemm(x, params["unembed"], out_dtype=torch.float32)
    return logits, torch.stack(k_news), torch.stack(v_news)


def _put_view(view, new, pos):
    """A copy of ``view [n_layers, b, capacity, heads, head_dim]`` with
    ``new [n_layers, b, heads, head_dim]`` written at per-sequence
    position ``pos [b]``; rows at or past the capacity drop (reference
    :575-584)."""
    L, b, cap = view.shape[:3]
    out = view.new_empty((L, b, cap + 1) + tuple(view.shape[3:]))
    out[:, :, :cap] = view
    out[:, torch.arange(b, device=view.device),
        pos.clamp(0, cap).to(view.device)] = new
    return out[:, :, :cap]


def speculative_propose(params: dict, prev, pending, start_pos, k_view,
                        v_view, cfg: TransformerConfig, n_propose: int):
    """Greedy draft rollout for speculative decoding (reference :587-641):
    ``n_propose`` cache-aware forward steps over the draft's KV view.

    ``prev``/``pending``: ``[b]`` int, the second-newest context token
    (at ``start_pos``) and the newest, not yet cached one (at
    ``start_pos + 1``).  The first step is a width-2 block of both (an
    exact overwrite of ``prev``'s entry, or the catch-up write after a
    fully accepted iteration); the later steps run ``[token, dummy]``
    blocks feeding each argmax proposal back, the fresh entries put into
    the view between steps.  The caller's views are not written.

    Returns ``(proposals [b, n_propose] int64, k_writes, v_writes)``,
    the writes ``[n_layers, b, n_propose + 1, heads, head_dim]`` for
    positions ``start_pos .. start_pos + n_propose``."""
    if n_propose < 1:
        raise ValueError(f"n_propose must be >= 1, got {n_propose}")
    kv, vv = k_view, v_view
    blk = torch.stack([prev, pending], dim=1)
    logits, kn, vn = forward_step(params, blk, start_pos, kv, vv, cfg)
    cur = torch.argmax(logits[:, 1], dim=-1)
    proposals = [cur]
    k_cols = [kn[:, :, 0], kn[:, :, 1]]
    v_cols = [vn[:, :, 0], vn[:, :, 1]]
    kv = _put_view(kv, k_cols[0], start_pos)
    vv = _put_view(vv, v_cols[0], start_pos)
    for j in range(1, n_propose):
        kv = _put_view(kv, k_cols[-1], start_pos + j)
        vv = _put_view(vv, v_cols[-1], start_pos + j)
        blk = torch.stack([cur, torch.zeros_like(cur)], dim=1)
        logits, kn, vn = forward_step(params, blk, start_pos + 1 + j, kv,
                                      vv, cfg)
        cur = torch.argmax(logits[:, 0], dim=-1)
        proposals.append(cur)
        k_cols.append(kn[:, :, 0])
        v_cols.append(vn[:, :, 0])
    return (torch.stack(proposals, dim=1), torch.stack(k_cols, dim=2),
            torch.stack(v_cols, dim=2))


def serving_forward(params: dict, tokens, cfg: TransformerConfig,
                    capacity: Optional[int] = None):
    """Non-incremental reference for the serving path (reference
    :644-659): the whole sequence through :func:`forward_step` from an
    empty KV view of ``capacity`` (default the sequence length).  Returns
    ``logits [b, s, vocab]`` f32; a prefill of ``tokens[:, :p]`` and
    ``s - p`` one-token decodes reproduce them exactly."""
    b, s = tokens.shape
    cap = capacity if capacity is not None else s
    hd = cfg.d_model // cfg.n_heads
    zeros = torch.zeros((cfg.n_layers, b, cap, cfg.n_heads, hd),
                        dtype=params["embed"].dtype, device=tokens.device)
    logits, _, _ = forward_step(
        params, tokens, torch.zeros((b,), dtype=torch.long,
                                    device=tokens.device), zeros, zeros, cfg)
    return logits
