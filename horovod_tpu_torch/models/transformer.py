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

:func:`chained_lm_loss` is the same loss in stages, for the overlapped
step (``parallel/overlap.py``).  Tensor, sequence, pipeline and expert
parallelism, the serving path and rematerialisation are later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_attention
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
    # Chunked cross-entropy over sequence chunks of this many positions,
    # recomputing each chunk's logits in the backward pass; 0 = off.
    loss_chunk: int = 0


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
            "w_in": normal((n, d, f), s_d),
            "b_in": zeros(n, f),
            "w_out": normal((n, f, d), f ** -0.5),
            "b_out": zeros(n, d),
        },
    }
    return tree_map(lambda x: x.to(device).requires_grad_(), p)


def _layernorm(x, scale, bias, eps: float = 1e-5):
    """Population variance, eps 1e-5 (reference :130)."""
    return F.layer_norm(x, x.shape[-1:], scale, bias, eps)


def _attention_block(x, lp, cfg: TransformerConfig):
    """Pre-LN causal self-attention: one fused [d, 3d] QKV product split
    in q, k, v order, the flash kernels, the output projection."""
    b, s, d = x.shape
    hd = d // cfg.n_heads
    h = _layernorm(x, lp["ln1"]["scale"], lp["ln1"]["bias"])
    qkv = h @ torch.cat([lp["wq"], lp["wk"], lp["wv"]], dim=-1)
    q, k, v = (y.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
               for y in qkv.split(d, dim=-1))
    attn = flash_attention(q, k, v, causal=True)
    attn = attn.transpose(1, 2).reshape(b, s, d)
    return x + attn @ lp["wo"]


def _ffn_block(x, lp):
    """Pre-LN dense MLP with tanh-approximated GELU (jax.nn.gelu's
    default)."""
    h = _layernorm(x, lp["ln2"]["scale"], lp["ln2"]["bias"])
    hh = F.gelu(h @ lp["w_in"] + lp["b_in"], approximate="tanh")
    return x + (hh @ lp["w_out"] + lp["b_out"])


def _index_layer(layers: dict, i: int) -> dict:
    return tree_map(lambda leaf: leaf[i], layers)


def forward(params: dict, tokens, cfg: TransformerConfig,
            return_hidden: bool = False):
    """Logits ``[b, s, vocab]`` in f32 for ``tokens [b, s]`` (int64), or
    with ``return_hidden`` the final post-LN hidden states ``[b, s, d]``.
    (The reference also returns an MoE aux loss, which is 0 here.)"""
    _check_config(cfg)
    b, s = tokens.shape
    if s > cfg.max_seq_len:
        raise ValueError(
            f"global sequence length {s} exceeds cfg.max_seq_len "
            f"{cfg.max_seq_len}; positions would clamp silently")
    x = params["embed"][tokens] + params["pos_embed"][:s]
    for i in range(cfg.n_layers):
        lp = _index_layer(params["layers"], i)
        x = _ffn_block(_attention_block(x, lp, cfg), lp)
    x = _layernorm(x, params["ln_f"]["scale"], params["ln_f"]["bias"])
    if return_hidden:
        return x
    return _logits(x, params["unembed"])


def _logits(x, unembed):
    return x.float() @ unembed.float()


def _nll_sum(x, unembed, targets):
    logp = torch.log_softmax(_logits(x, unembed), dim=-1)
    return -torch.gather(logp, -1, targets[..., None]).sum()


def make_loss_fn(cfg: TransformerConfig):
    """``loss_fn(params, (tokens, targets))``: mean next-token
    cross-entropy on this rank's batch (the reference's pmean over ranks
    is the train step's loss allreduce here).  ``cfg.loss_chunk > 0``
    computes it over sequence chunks, recomputing each chunk's logits in
    the backward pass, so the full logits never exist at once."""

    def dense_ce(params, tokens, targets):
        logits = forward(params, tokens, cfg)
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, targets[..., None]).mean()

    def chunked_ce(params, tokens, targets):
        x = forward(params, tokens, cfg, return_hidden=True)
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
        return total / (b * s)

    def loss_fn(params, batch):
        tokens, targets = batch
        ce = chunked_ce if cfg.loss_chunk > 0 else dense_ce
        return ce(params, tokens, targets)

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

    def embed_stage(p, carry, batch):
        tokens, _targets = batch
        s = tokens.shape[1]
        if s > cfg.max_seq_len:
            raise ValueError(
                f"sequence length {s} exceeds cfg.max_seq_len "
                f"{cfg.max_seq_len}; positions would clamp silently")
        return p["embed"][tokens] + p["pos_embed"][:s]

    def layer_stage(p, carry, batch):
        return _ffn_block(_attention_block(carry, p, cfg), p)

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
