"""MNIST models (port of horovod_tpu/models/mnist.py).

Each model is a frozen dataclass with flax's two entry points as
functions on tensor trees: ``init(generator, device)`` and ``apply``.
Parameter trees carry flax's auto-names (``Conv_0``, ``Dense_1``,
``BatchNorm_0``), HWIO convolution kernels and ``[in, out]`` dense
kernels, so :mod:`..utils.convert` moves a JAX tree in by copying.
Kernels take flax's lecun-normal init, biases zeros, BatchNorm scale
ones; draws come from ``generator`` on the CPU.  Images are NHWC
``[B, 28, 28, 1]`` in [0, 1], as the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.tree import tree_map
from .layers import (batch_norm, conv_kernel, conv_same, dense, lecun_normal,
                     oihw)


def _dense_params(generator, fan_in: int, fan_out: int) -> dict:
    return {"kernel": lecun_normal(generator, (fan_in, fan_out), fan_in),
            "bias": torch.zeros(fan_out)}


def _to_device(tree, device, requires_grad: bool):
    return tree_map(lambda x: x.to(device).requires_grad_(requires_grad),
                    tree)


@dataclass(frozen=True)
class MnistCNN:
    """conv(32)-pool-conv(64)-pool-fc(512)-fc(10), reference :20; bf16
    compute by default, f32 parameters and logits."""

    num_classes: int = 10
    compute_dtype: torch.dtype = torch.bfloat16

    def init(self, generator: torch.Generator, device=None) -> dict:
        g = generator
        params = {
            "Conv_0": {"kernel": conv_kernel(g, 5, 5, 1, 32),
                       "bias": torch.zeros(32)},
            "Conv_1": {"kernel": conv_kernel(g, 5, 5, 32, 64),
                       "bias": torch.zeros(64)},
            "Dense_0": _dense_params(g, 7 * 7 * 64, 512),
            "Dense_1": _dense_params(g, 512, self.num_classes)}
        return _to_device(params, device, True)

    def apply(self, params: dict, images: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = images.to(dt).permute(0, 3, 1, 2)
        for name in ("Conv_0", "Conv_1"):
            p = params[name]
            x = conv_same(x, oihw(p["kernel"], dt), 1, p["bias"].to(dt))
            x = F.max_pool2d(F.relu(x), 2, 2)
        # Flatten in NHWC order, as the reference's reshape does, so the
        # [3136, 512] kernel lines up.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        p0, p1 = params["Dense_0"], params["Dense_1"]
        x = F.relu(dense(x, p0["kernel"].to(dt), p0["bias"].to(dt)))
        return dense(x, p1["kernel"].to(dt), p1["bias"].to(dt)).float()


@dataclass(frozen=True)
class MnistMLP:
    """Dense(hidden)-relu-Dense(10) in f32, reference :42."""

    num_classes: int = 10
    hidden: int = 128

    def init(self, generator: torch.Generator, device=None) -> dict:
        params = {"Dense_0": _dense_params(generator, 28 * 28, self.hidden),
                  "Dense_1": _dense_params(generator, self.hidden,
                                           self.num_classes)}
        return _to_device(params, device, True)

    def apply(self, params: dict, images: torch.Tensor) -> torch.Tensor:
        x = images.reshape(images.shape[0], -1)
        x = F.relu(dense(x, params["Dense_0"]["kernel"],
                         params["Dense_0"]["bias"]))
        return dense(x, params["Dense_1"]["kernel"], params["Dense_1"]["bias"])


@dataclass(frozen=True)
class MnistBNMLP:
    """Dense(hidden)-BatchNorm-relu-Dense(10) in f32, reference :57: the
    smallest model with non-trained state."""

    num_classes: int = 10
    hidden: int = 64

    def init(self, generator: torch.Generator, device=None):
        params = {"Dense_0": _dense_params(generator, 28 * 28, self.hidden),
                  "BatchNorm_0": {"scale": torch.ones(self.hidden),
                                  "bias": torch.zeros(self.hidden)},
                  "Dense_1": _dense_params(generator, self.hidden,
                                           self.num_classes)}
        state = {"BatchNorm_0": {"mean": torch.zeros(self.hidden),
                                 "var": torch.ones(self.hidden)}}
        return (_to_device(params, device, True),
                _to_device(state, device, False))

    def apply(self, params: dict, state: dict, images: torch.Tensor,
              train: bool = True):
        """``(logits, new_state)``; with ``train=False`` the running
        statistics normalize and the state comes back unchanged."""
        x = images.reshape(images.shape[0], -1)
        x = dense(x, params["Dense_0"]["kernel"], params["Dense_0"]["bias"])
        bn = params["BatchNorm_0"]
        x, bn_state = batch_norm(x, bn["scale"], bn["bias"],
                                 state["BatchNorm_0"], train)
        x = dense(F.relu(x), params["Dense_1"]["kernel"],
                  params["Dense_1"]["bias"])
        return x, ({"BatchNorm_0": bn_state} if train else state)


def bn_mlp_loss_fn(model: MnistBNMLP):
    """``loss_fn(params, model_state, batch) -> (loss, new_state)`` for
    :func:`~..parallel.training.make_train_step_with_state`."""

    def loss_fn(params, model_state, batch):
        images, labels = batch
        logits, new_state = model.apply(params, model_state, images,
                                        train=True)
        return cross_entropy_loss(logits, labels), new_state

    return loss_fn


def init_bn_mlp(model: MnistBNMLP, seed: int = 0, device=None):
    """``(params, batch_stats)`` drawn from ``seed``."""
    return model.init(torch.Generator().manual_seed(seed), device)


def init_params(model, seed: int = 0, device=None) -> dict:
    """Parameters of a stateless model drawn from ``seed``."""
    return model.init(torch.Generator().manual_seed(seed), device)


def cross_entropy_loss(logits, labels):
    """Mean softmax cross-entropy over the (local) batch."""
    return F.cross_entropy(logits.float(), labels.long())


def accuracy(logits, labels):
    return (logits.argmax(-1) == labels).float().mean()


def synthetic_mnist(num: int, seed: int = 0):
    """The reference's synthetic MNIST, value for value (its numpy
    recipe: images uniform in [0, 1), the label the argmax of the image
    against 10 fixed random masks).  Returns CPU tensors ``(images
    [num, 28, 28, 1] f32, labels [num] int64)``."""
    rng = np.random.RandomState(seed)
    images = rng.rand(num, 28, 28, 1).astype("float32")
    masks = rng.rand(10, 28 * 28).astype("float32")
    labels = np.argmax(images.reshape(num, -1) @ masks.T, axis=1)
    return torch.from_numpy(images), torch.from_numpy(labels.astype(np.int64))
