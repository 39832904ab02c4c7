"""PyTorch MNIST through the horovod.torch surface: the port's twin of
examples/pytorch_mnist.py (≙ the reference's pytorch_mnist.py):
DistributedOptimizer with named parameters (gradient hooks fire the
negotiated allreduces during backward), broadcast_parameters before
training, the epoch's loss averaged over ranks.

    python -m horovod_tpu_torch.examples.pytorch_mnist            # GPU
    python -m horovod_tpu_torch.examples.pytorch_mnist --device cpu

The averaged loss must fall.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn as nn
import torch.nn.functional as F

import horovod_tpu_torch.frontends.torch as hvd
from horovod_tpu_torch.core import state
from horovod_tpu_torch.models.mnist import synthetic_mnist


class Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(784, 128)
        self.fc2 = nn.Linear(128, 10)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    hvd.init(device=args.device)
    dev = state.device()
    torch.manual_seed(1 + hvd.rank())
    images, labels = synthetic_mnist(2048, seed=hvd.rank())
    x, y = images.reshape(-1, 784).to(dev), labels.to(dev)

    model = Net().to(dev)
    # Scale the learning rate by the rank count (reference :33-35).
    opt = torch.optim.SGD(model.parameters(), lr=0.05 * hvd.size(),
                          momentum=0.5)
    opt = hvd.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())
    # Consistent initialization (reference :41-42).
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    history = []
    for epoch in range(args.epochs):
        losses = []
        for i in range(0, len(x), 128):
            opt.zero_grad()
            loss = F.cross_entropy(model(x[i:i + 128]), y[i:i + 128])
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        # The epoch's metric averaged over ranks (reference :70-74).
        avg = float(hvd.allreduce(torch.stack(losses).mean(), average=True,
                                  name=f"epoch.loss.{epoch}"))
        history.append(avg)
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss={avg:.4f}")
    if len(history) > 1 and not history[-1] < history[0]:
        raise SystemExit(f"pytorch_mnist: loss did not fall: {history}")
    hvd.shutdown()
    print("pytorch_mnist: OK")


if __name__ == "__main__":
    main()
