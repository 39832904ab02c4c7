"""The flax layers the reference's image models use, as functions on tensors.

The reference's activations are NHWC.  The port keeps their memory NHWC
too: an NHWC tensor ``x`` enters as ``x.permute(0, 3, 1, 2)``, an NCHW
view in ``channels_last`` memory, which cuDNN convolves, normalizes and
pools without a copy, and every function here returns that layout again.
Convolution kernels stay HWIO in the parameter tree (flax's layout, so
:mod:`..utils.convert` copies a JAX tree in); :func:`oihw` turns one into
the OIHW ``channels_last`` operand of ``F.conv2d`` in the same copy that
casts it to the compute dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def lecun_normal(generator: torch.Generator, shape, fan_in: int):
    """flax's default kernel init (``lecun_normal``): a normal truncated
    to [-2, 2], scaled to variance 1/fan_in (the 0.8796 is the truncated
    unit normal's standard deviation)."""
    x = torch.nn.init.trunc_normal_(torch.empty(shape), 0.0, 1.0, -2.0, 2.0,
                                    generator=generator)
    return x * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)


def conv_kernel(generator: torch.Generator, kh: int, kw: int, cin: int,
                cout: int):
    """An HWIO convolution kernel with flax's init (fan_in kh*kw*cin)."""
    return lecun_normal(generator, (kh, kw, cin, cout), kh * kw * cin)


def oihw(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """HWIO kernel -> OIHW ``channels_last`` operand in ``dtype``, one
    copy (differentiable)."""
    return kernel.permute(3, 2, 0, 1).to(dtype=dtype,
                                         memory_format=torch.channels_last)


def same_pads(size: int, window: int, stride: int):
    """flax/lax ``padding="SAME"`` along one axis: ``(lo, hi)`` with
    ``lo = total // 2``.  The pad is asymmetric whenever ``total`` is
    odd (a 7x7/s2 stem at 224: (2, 3); a 3x3/s2 conv at 56: (0, 1)),
    where torch's symmetric ``padding`` would shift every window by one
    pixel."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pad_same(x, window, stride, value=0.0):
    """Pad (N, C, H, W) as SAME does; returns the padded tensor and the
    symmetric ``padding`` left for the op (0 where the pad was explicit)."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], window[0], stride),
                          same_pads(x.shape[3], window[1], stride))
    if hl == hh and wl == wh:
        return x, (hl, wl)
    # F.pad keeps channels_last memory (constant_pad_nd follows the
    # input's suggested memory format).
    return F.pad(x, (wl, wh, hl, hh), value=value), (0, 0)


def conv_same(x, kernel, stride: int = 1, bias=None):
    """``nn.Conv(..., padding="SAME")`` on an (N, C, H, W) tensor with an
    OIHW kernel (:func:`oihw`); ``bias`` is added by the convolution."""
    x, padding = _pad_same(x, kernel.shape[2:], stride)
    return F.conv2d(x, kernel, bias, stride, padding)


def max_pool_same(x, window: int, stride: int):
    """``nn.max_pool(x, (w, w), (s, s), padding="SAME")``: the pad is
    -inf (lax.reduce_window's init value for max), asymmetric as in
    :func:`same_pads` ((0, 1) for 3x3/s2 on 112)."""
    (hl, hh), (wl, wh) = (same_pads(x.shape[2], window, stride),
                          same_pads(x.shape[3], window, stride))
    if hl or hh or wl or wh:
        x = F.pad(x, (wl, wh, hl, hh), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def batch_norm(x, scale, bias, state, train: bool, momentum: float = 0.9,
               eps: float = 1e-5):
    """``nn.BatchNorm`` over every axis but 1 (the channels of an
    (N, C, H, W) tensor, the features of an (N, F) one).

    Returns ``(y, new_state)``; ``state`` is ``{"mean", "var"}`` (f32),
    ``scale``/``bias`` f32, ``y`` in ``x``'s dtype.  Flax semantics
    (flax/linen/normalization.py ``_compute_stats``, ``_normalize``):

    * ``train``: normalize with the batch mean and the biased batch
      variance, statistics in f32 whatever ``x``'s dtype; gradients flow
      through both, as in flax.  ``F.batch_norm(training=True)`` computes
      exactly that function (cuDNN on the card).
    * the running update is flax's: ``ra = momentum * ra + (1 - momentum)
      * batch`` with the *fast* variance ``E[x^2] - E[x]^2`` clipped at 0,
      *biased*.  ``F.batch_norm``'s own update takes the unbiased
      variance and the opposite momentum convention, so it is not used.
    * not ``train``: normalize with the running statistics; the state is
      returned unchanged.
    """
    if not train:
        y = F.batch_norm(x, state["mean"], state["var"], scale, bias,
                         training=False, eps=eps)
        return y, state
    y = F.batch_norm(x, None, None, scale, bias, training=True, eps=eps)
    dims = [d for d in range(x.ndim) if d != 1]
    with torch.no_grad():
        n = x.numel() // x.shape[1]
        mean = x.mean(dims, dtype=torch.float32)
        # E[x^2] in f32 without an f32 copy of x: the norm reduces a bf16
        # tensor in f32 (squaring in bf16 would round each x^2).
        mean_sq = torch.linalg.vector_norm(
            x, 2, dims, dtype=torch.float32).square() / n
        var = (mean_sq - mean.square()).clamp_min(0.0)
        new_state = {
            "mean": momentum * state["mean"] + (1.0 - momentum) * mean,
            "var": momentum * state["var"] + (1.0 - momentum) * var}
    return y, new_state


def dense(x, kernel, bias=None):
    """``nn.Dense``: ``x @ kernel`` with an ``[in, out]`` kernel, then the
    bias, each rounded to the operands' dtype as flax's dot and add are."""
    y = x @ kernel
    return y if bias is None else y + bias
