"""ResNet family (port of horovod_tpu/models/resnet.py): ResNet-v1.5 with
bottleneck blocks, the stride in the 3x3, the last BatchNorm's scale
zero-initialised, and the optional MLPerf space-to-depth stem.

``ResNet`` is a frozen dataclass with flax's entry points as functions
on tensor trees: ``init(generator, device) -> (params, batch_stats)`` and
``apply(params, batch_stats, images, train) -> (logits, new_stats)``.
The trees carry flax's names (``conv_init``, ``bn_init``,
``BottleneckBlock_0``..., ``head``; ``Conv_0``, ``BatchNorm_0``,
``conv_proj``, ``norm_proj`` inside a block) and shapes (HWIO kernels),
so :mod:`..utils.convert` moves a JAX tree in by copying.

Compute dtype bf16 by default, parameters and statistics f32, logits f32.
Images are NHWC; activations run as NCHW views of NHWC memory
(``channels_last``, see :mod:`.layers`).  BatchNorm statistics are this
rank's batch's; :func:`~..parallel.training.make_train_step_with_state`
averages the updated statistics over ranks, as the reference's step does.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.tree import tree_leaves, tree_map
from .layers import (batch_norm, conv_kernel, conv_same, dense, lecun_normal,
                     max_pool_same, oihw)


def _norm_init(c: int, scale: float = 1.0):
    return ({"scale": torch.full((c,), scale), "bias": torch.zeros(c)},
            {"mean": torch.zeros(c), "var": torch.ones(c)})


@dataclass(frozen=True)
class ResNet:
    stage_sizes: Sequence[int]
    num_classes: int = 1000
    num_filters: int = 64
    compute_dtype: torch.dtype = torch.bfloat16
    # MLPerf space-to-depth stem: 2x2 pixel blocks become 12 channels,
    # then a 4x4/s1 conv (reference :57-62).
    space_to_depth: bool = False

    def _blocks(self):
        """(name, filters, stride) of each bottleneck block in order."""
        k = 0
        for i, count in enumerate(self.stage_sizes):
            for j in range(count):
                yield (f"BottleneckBlock_{k}", self.num_filters * 2 ** i,
                       2 if i > 0 and j == 0 else 1)
                k += 1

    def init(self, generator: torch.Generator, device=None):
        """``(params, batch_stats)`` with flax's initializers; draws come
        from ``generator`` on the CPU, leaves go to ``device`` (params
        require grad)."""
        g, f0 = generator, self.num_filters
        stem = (4, 4, 12) if self.space_to_depth else (7, 7, 3)
        params = {"conv_init": {"kernel": conv_kernel(g, *stem, f0)}}
        params["bn_init"], stats = _norm_init(f0)
        stats = {"bn_init": stats}
        cin = f0
        for name, filters, _ in self._blocks():
            bp, bs = {}, {}
            shapes = ((1, cin, filters), (3, filters, filters),
                      (1, filters, 4 * filters))
            for n, (k, a, b) in enumerate(shapes):
                bp[f"Conv_{n}"] = {"kernel": conv_kernel(g, k, k, a, b)}
                bp[f"BatchNorm_{n}"], bs[f"BatchNorm_{n}"] = _norm_init(
                    b, 0.0 if n == 2 else 1.0)
            # Projection where the block changes the shape (reference
            # :45): block 0 of every stage, stage 0's too (64 -> 256
            # channels); every strided block also changes the channels.
            if cin != 4 * filters:
                bp["conv_proj"] = {"kernel": conv_kernel(g, 1, 1, cin,
                                                         4 * filters)}
                bp["norm_proj"], bs["norm_proj"] = _norm_init(4 * filters)
            params[name], stats[name] = bp, bs
            cin = 4 * filters
        params["head"] = {"kernel": lecun_normal(g, (cin, self.num_classes),
                                                 cin),
                          "bias": torch.zeros(self.num_classes)}
        return (tree_map(lambda x: x.to(device).requires_grad_(), params),
                tree_map(lambda x: x.to(device), stats))

    def apply(self, params: dict, batch_stats: dict, images: torch.Tensor,
              train: bool = True):
        """Logits ``[B, num_classes]`` (f32) of NHWC ``images`` and the
        new statistics (``batch_stats`` itself when not ``train``)."""
        dt = self.compute_dtype
        x = images.to(dt)
        if self.space_to_depth:
            b, h, w, c = x.shape
            if h % 2 or w % 2:  # pad odd extents at the end, as :74-78
                x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
                b, h, w, c = x.shape
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        x = conv_same(x, oihw(params["conv_init"]["kernel"], dt),
                      1 if self.space_to_depth else 2)
        new_stats = {}
        x, new_stats["bn_init"] = self._norm(x, params["bn_init"],
                                             batch_stats["bn_init"], train)
        x = max_pool_same(F.relu(x), 3, 2)
        for name, _, stride in self._blocks():
            x, new_stats[name] = self._block(x, params[name],
                                             batch_stats[name], stride, train)
        x = x.mean((2, 3))
        head = params["head"]
        x = dense(x, head["kernel"].to(dt), head["bias"].to(dt))
        return x.float(), (new_stats if train else batch_stats)

    @staticmethod
    def _norm(x, p, stats, train):
        return batch_norm(x, p["scale"], p["bias"], stats, train)

    def _block(self, x, bp, bs, stride, train):
        """BottleneckBlock (reference :27): 1x1, 3x3/stride, 1x1 (x4), the
        projection where the shape changes, relu(residual + y)."""
        dt, new = self.compute_dtype, {}
        y = x
        for n, s in enumerate((1, stride, 1)):
            y = conv_same(y, oihw(bp[f"Conv_{n}"]["kernel"], dt), s)
            y, new[f"BatchNorm_{n}"] = self._norm(
                y, bp[f"BatchNorm_{n}"], bs[f"BatchNorm_{n}"], train)
            if n < 2:
                y = F.relu(y)
        residual = x
        if "conv_proj" in bp:
            residual = conv_same(x, oihw(bp["conv_proj"]["kernel"], dt),
                                 stride)
            residual, new["norm_proj"] = self._norm(
                residual, bp["norm_proj"], bs["norm_proj"], train)
        return F.relu(residual + y), new


ResNet50 = partial(ResNet, stage_sizes=(3, 4, 6, 3))
ResNet101 = partial(ResNet, stage_sizes=(3, 4, 23, 3))
ResNet18Thin = partial(ResNet, stage_sizes=(1, 1, 1, 1), num_filters=16)


def init_resnet(model: ResNet, seed: int = 0, device=None):
    """``(params, batch_stats)`` drawn from ``seed`` (reference :105)."""
    return model.init(torch.Generator().manual_seed(seed), device)


def resnet_loss_fn(model: ResNet, weight_decay: float = 1e-4):
    """``loss_fn(params, batch_stats, (images, labels)) -> (loss,
    new_stats)``: mean softmax cross-entropy plus ``weight_decay * 0.5 *
    sum(w^2)`` over the leaves with ``ndim > 1`` (conv and head kernels,
    not BatchNorm or biases), reference :114."""

    def loss_fn(params, batch_stats, batch):
        images, labels = batch
        logits, new_stats = model.apply(params, batch_stats, images,
                                        train=True)
        ce = F.cross_entropy(logits, labels.long())
        # One flat vector, one dot: a handful of launches forward and
        # backward, where a sum per leaf takes ~5 for each of 54 leaves.
        flat = torch.cat([p.float().reshape(-1)
                          for p in tree_leaves(params) if p.ndim > 1])
        return ce + weight_decay * 0.5 * flat.dot(flat), new_stats

    return loss_fn


def synthetic_imagenet(num: int, image_size: int = 224, seed: int = 0,
                       num_classes: int = 1000):
    """The reference's synthetic ImageNet batch, value for value (its numpy
    recipe).  Returns CPU tensors ``(images [num, size, size, 3] f32,
    labels [num] int64)``."""
    rng = np.random.RandomState(seed)
    images = rng.rand(num, image_size, image_size, 3).astype("float32")
    labels = rng.randint(0, num_classes, size=(num,))
    return torch.from_numpy(images), torch.from_numpy(labels.astype(np.int64))
