"""Keras MNIST through the port's Keras frontend, Keras 3 on its torch
backend: the port's twin of examples/keras_mnist.py (≙ the reference's
keras_mnist.py): the learning rate scaled by the rank count,
DistributedOptimizer, the broadcast, metric-average and warmup callbacks,
a checkpoint on rank 0.

    python -m horovod_tpu_torch.examples.keras_mnist            # GPU
    python -m horovod_tpu_torch.examples.keras_mnist --device cpu
    torchrun --nproc-per-node 2 -m horovod_tpu_torch.examples.keras_mnist \\
        --device cpu

The model is built and fitted under ``keras.device(...)`` for the port's
device, so nothing lands on a card Keras would pick by itself.  With more
than one epoch the loss must fall.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import horovod_tpu_torch.frontends.keras as hvd
from horovod_tpu_torch.core import state
from horovod_tpu_torch.models.mnist import synthetic_mnist


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--save", default=os.path.join(
        tempfile.gettempdir(), "keras_mnist_hvd.keras"),
        help="where rank 0 saves the model")
    args = ap.parse_args()

    hvd.init(device=args.device)
    import keras  # after the frontend set KERAS_BACKEND=torch

    images, labels = synthetic_mnist(4096, seed=hvd.rank())
    x = images.reshape(-1, 28 * 28).numpy()
    y = labels.numpy().astype("int32")

    with keras.device(str(state.device())):
        model = keras.Sequential([
            keras.layers.Input(shape=(784,)),
            keras.layers.Dense(128, activation="relu"),
            keras.layers.Dropout(0.2),
            keras.layers.Dense(10),
        ])
        # Scale the learning rate by the rank count (reference
        # examples/keras_mnist.py:26-28).
        opt = hvd.DistributedOptimizer(
            keras.optimizers.Adam(learning_rate=1e-3 * hvd.size()))
        model.compile(
            optimizer=opt,
            loss=keras.losses.SparseCategoricalCrossentropy(from_logits=True),
            metrics=["accuracy"])
        callbacks = [
            hvd.callbacks.BroadcastGlobalVariablesCallback(0),
            hvd.callbacks.MetricAverageCallback(),
            hvd.callbacks.LearningRateWarmupCallback(warmup_epochs=2),
        ]
        hist = model.fit(x, y, batch_size=128, epochs=args.epochs,
                         verbose=0, callbacks=callbacks)
    losses = hist.history["loss"]
    if hvd.rank() == 0:
        for e, (loss, acc) in enumerate(zip(losses,
                                            hist.history["accuracy"])):
            print(f"epoch {e}: loss={loss:.4f} acc={acc:.4f}")
        # Rank-0 checkpoint (reference keras_mnist.py:42-44).
        model.save(args.save)
        print(f"saved {args.save}")
    if len(losses) > 1 and not losses[-1] < losses[0]:
        raise SystemExit(f"keras_mnist: loss did not fall: {losses}")
    hvd.shutdown()
    print("keras_mnist: OK")


if __name__ == "__main__":
    main()
