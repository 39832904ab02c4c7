"""SyncBatchNorm for the torch frontend (port of
horovod_tpu/frontends/torch_sync_bn.py:30-142; ≙ ``hvd.SyncBatchNorm``):
BatchNorm whose statistics span every rank's batch shard.

Both passes compute the global moments with grouped allreduces on the
port's negotiated collectives -- (sum, sum of squares, count) forward,
the two gradient sums backward -- one fused wire collective each, on the
tensors' own device.

With global mean/var over n = Σ n_r rows,
``dx = (w/σ) (g − mean_n(g) − x̂ · mean_n(g·x̂))`` where both means are
GLOBAL; ``dw = Σ_local(g·x̂)`` and ``db = Σ_local(g)`` stay local: the
DistributedOptimizer averages parameter gradients like every other
layer's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import state as _state
from ..ops import collective as _C


def _global_sums(tensors, name: str):
    """Sum over ranks of same-shape-per-rank vectors, fused."""
    return _C.grouped_allreduce([t.detach() for t in tensors], average=False,
                                name=name)


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var,
                eps, momentum, name):
        dims = [0] + list(range(2, x.dim()))
        n_local = float(x.numel() // x.shape[1])
        # Moments with a float32 floor: an fp16 sum of squares overflows
        # past ~65504 and an fp16 count loses integers above 2048.
        # float64 stays float64.
        acc = torch.float64 if x.dtype == torch.float64 else torch.float32
        xf = x.to(acc)
        local_sum = xf.sum(dim=dims)
        local_sumsq = (xf * xf).sum(dim=dims)
        count = torch.tensor([n_local], dtype=acc, device=x.device)
        g_sum, g_sumsq, g_count = _global_sums(
            [local_sum, local_sumsq, count], name=f"{name}.fwd")
        n = float(g_count[0])
        mean = g_sum / n
        var = torch.clamp(g_sumsq / n - mean * mean, min=0.0)
        std = torch.sqrt(var + eps)
        shape = [1, -1] + [1] * (x.dim() - 2)
        xhat = ((x - mean.to(x.dtype).reshape(shape))
                / std.to(x.dtype).reshape(shape))
        out = xhat * weight.reshape(shape) + bias.reshape(shape)
        if running_mean is not None:
            with torch.no_grad():
                unbiased = var * (n / max(n - 1.0, 1.0))
                running_mean.mul_(1 - momentum).add_(
                    momentum * mean.to(running_mean.dtype))
                running_var.mul_(1 - momentum).add_(
                    momentum * unbiased.to(running_var.dtype))
        ctx.save_for_backward(xhat, weight, std)
        ctx.n_global = n
        ctx.name = name
        return out

    @staticmethod
    def backward(ctx, grad_out):
        xhat, weight, std = ctx.saved_tensors
        dims = [0] + list(range(2, grad_out.dim()))
        shape = [1, -1] + [1] * (grad_out.dim() - 2)
        acc = (torch.float64 if grad_out.dtype == torch.float64
               else torch.float32)
        gf = grad_out.to(acc)
        local_g = gf.sum(dim=dims)
        local_gx = (gf * xhat.to(acc)).sum(dim=dims)
        g_g, g_gx = _global_sums([local_g, local_gx],
                                 name=f"{ctx.name}.bwd")
        n = ctx.n_global
        dx = ((weight.to(acc).reshape(shape) / std.to(acc).reshape(shape)) * (
            gf - (g_g / n).reshape(shape)
            - xhat.to(acc) * (g_gx / n).reshape(shape))
        ).to(grad_out.dtype)
        return (dx, local_gx.to(weight.dtype), local_g.to(weight.dtype),
                None, None, None, None, None)


class SyncBatchNorm(torch.nn.modules.batchnorm._BatchNorm):
    """Drop-in BatchNorm1d/2d/3d whose training-time statistics span all
    ranks.  Eval mode, and a job of one rank, use the stock batch_norm."""

    _instances = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        SyncBatchNorm._instances += 1
        self._hvd_name = f"sync_bn.{SyncBatchNorm._instances}"

    def _check_input_dim(self, input) -> None:
        if input.dim() < 2:
            raise ValueError(
                f"expected at least 2D input (got {input.dim()}D)")

    def forward(self, x):
        self._check_input_dim(x)
        _state._check_initialized()
        if self.training and self.num_batches_tracked is not None:
            with torch.no_grad():
                self.num_batches_tracked += 1
        # momentum=None: a cumulative moving average (stock semantics).
        if self.momentum is not None:
            factor = self.momentum
        elif self.training and self.num_batches_tracked is not None:
            factor = 1.0 / float(self.num_batches_tracked)
        else:
            factor = 0.0
        if not self.training or _state.size() == 1:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, self.training, factor, self.eps)
        return _SyncBatchNormFn.apply(
            x, self.weight, self.bias, self.running_mean,
            self.running_var, self.eps, factor, self._hvd_name)
