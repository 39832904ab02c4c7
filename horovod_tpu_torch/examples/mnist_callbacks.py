"""MNIST with the callback suite, data parallel: the port's twin of
examples/mnist_callbacks.py (≙ the reference's keras_mnist_advanced.py):
broadcast at start, metric averaging, gradual LR warmup, LR schedule.

    python -m horovod_tpu_torch.examples.mnist_callbacks            # GPU
    python -m horovod_tpu_torch.examples.mnist_callbacks --device cpu

The loss must fall.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks
from horovod_tpu_torch.frontends.loop import Trainer
from horovod_tpu_torch.models.mnist import (MnistMLP, cross_entropy_loss,
                                            init_params, synthetic_mnist)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    hvd.init(device=args.device)
    model = MnistMLP(hidden=128)
    params = init_params(model, device=hvd.device())

    def loss_fn(params, batch):
        images, labels = batch
        return cross_entropy_loss(model.apply(params, images), labels)

    steps_per_epoch = 16
    trainer = Trainer(
        loss_fn, params, lr=0.1 * hvd.size(),
        optimizer_kwargs={"momentum": 0.9},
        callbacks=[
            callbacks.BroadcastGlobalVariablesCallback(0),
            callbacks.MetricAverageCallback(),
            callbacks.LearningRateWarmupCallback(
                warmup_epochs=2, steps_per_epoch=steps_per_epoch,
                verbose=int(hvd.rank() == 0)),
            callbacks.LearningRateScheduleCallback(multiplier=0.1,
                                                   start_epoch=4),
        ])

    images, labels = synthetic_mnist(4096)
    global_batch = 32 * hvd.size()

    def batches(epoch, step):
        rng = np.random.RandomState(epoch * 1000 + step)
        idx = torch.from_numpy(rng.randint(0, len(images), size=global_batch))
        return images[idx], labels[idx]

    history = trainer.fit(batches, epochs=args.epochs,
                          steps_per_epoch=steps_per_epoch)
    if hvd.rank() == 0:
        for e, logs in enumerate(history):
            print(f"epoch {e}: {logs}")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise SystemExit("mnist_callbacks: loss did not improve")
    print("mnist_callbacks: OK")
    hvd.shutdown()


if __name__ == "__main__":
    main()
