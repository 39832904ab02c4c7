"""ResNet training on synthetic ImageNet, data parallel: the port's twin of
examples/resnet50_synthetic.py (without its checkpoint resume).

    # tiny (ResNet18Thin, 32 px, 16 classes), on the GPU or --device cpu;
    # the loss must fall:
    python -m horovod_tpu_torch.examples.resnet50_synthetic

    # ResNet-50, 224 px, 1000 classes, batch 32 per GPU, through
    # Trainer.fit with the four Horovod callbacks:
    python -m horovod_tpu_torch.examples.resnet50_synthetic --full

    # bench.py's recipe (ResNet-50 with the space-to-depth stem, 224 px,
    # batch 128 per GPU, SGD(0.1, momentum 0.9), one fixed batch, warm-up
    # then timed steps), one images/sec JSON line:
    python -m horovod_tpu_torch.examples.resnet50_synthetic --bench

    # several GPUs: one process per GPU under a launcher that sets RANK,
    # WORLD_SIZE, MASTER_ADDR, MASTER_PORT (torchrun does).

The flow is the reference's (≙ examples/keras_imagenet_resnet50.py):
init -> Trainer(SGD, momentum 0.9, linear LR scaling) with
BroadcastGlobalVariables, MetricAverage, LR warmup and a staircase
schedule -> fit on synthetic data.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import callbacks
from horovod_tpu_torch.frontends.loop import Trainer
from horovod_tpu_torch.models import resnet as R

# bench.py:82: ResNet-50 forward at 224 px is 4.09 GFLOP an image (2
# FLOPs a multiply-add), forward and backward about 3x that.
RESNET50_TRAIN_FLOPS_PER_IMAGE = 3 * 4.09e9

STEPS_PER_EPOCH = 8


def fit(full: bool = False, epochs: int = 3, device=None, seed: int = 0,
        prefetch: int = 2, extra_callbacks=()) -> dict:
    """The example's flow.  ``full``: ResNet-50, 224 px, 1000 classes,
    32 images per rank; else ResNet18Thin, 32 px, 16 classes, 8 per rank.
    Warm-up over epoch 0, LR x0.1 from epoch 2 (the reference example's
    30/60/80-style staircase, scaled to a few epochs).  Returns the
    trainer, its history and the base learning rate."""
    hvd.init(device=device)
    verbose = hvd.rank() == 0
    if full:
        model = R.ResNet50(num_classes=1000)
        image_size, num_classes, per_rank = 224, 1000, 32
    else:
        model = R.ResNet18Thin(num_classes=16)
        image_size, num_classes, per_rank = 32, 16, 8
    params, stats = R.init_resnet(model, seed=seed, device=hvd.device())
    base_lr = 0.0125 * hvd.size()  # linear LR scaling
    trainer = Trainer(
        R.resnet_loss_fn(model), params, lr=base_lr,
        optimizer_kwargs={"momentum": 0.9}, model_state=stats,
        callbacks=[
            callbacks.BroadcastGlobalVariablesCallback(0),
            callbacks.MetricAverageCallback(),
            callbacks.LearningRateWarmupCallback(
                warmup_epochs=1, steps_per_epoch=STEPS_PER_EPOCH,
                verbose=int(verbose)),
            callbacks.LearningRateScheduleCallback(multiplier=0.1,
                                                   start_epoch=2),
            *extra_callbacks])
    global_batch = per_rank * hvd.size()
    images, labels = R.synthetic_imagenet(
        4 * global_batch, image_size=image_size, num_classes=num_classes,
        seed=seed)

    def batches(epoch, step):
        rng = np.random.RandomState(epoch * 131 + step)
        idx = torch.from_numpy(rng.randint(0, len(images), size=global_batch))
        return images[idx], labels[idx]

    history = trainer.fit(batches, epochs=epochs,
                          steps_per_epoch=STEPS_PER_EPOCH, prefetch=prefetch)
    return {"trainer": trainer, "history": history, "base_lr": base_lr,
            "batches": batches}


def bench(batch: int = 128, image_size: int = 224, warmup: int = 3,
          iters: int = 20, space_to_depth: bool = True, device=None,
          seed: int = 0, num_classes: int = 1000) -> dict:
    """bench.py's recipe (bench.py:121-190): ResNet-50, ``batch`` images
    per rank, SGD(0.1, momentum 0.9), one fixed synthetic batch,
    ``warmup`` steps, then ``iters`` timed steps ended by a device
    synchronise.  cuDNN picks its convolution algorithms by timing them
    on the first step (fixed shapes), as XLA's autotuner does for the
    reference."""
    hvd.init(device=device)
    dev = hvd.device()
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    model = R.ResNet50(num_classes=num_classes, space_to_depth=space_to_depth)
    params, stats = R.init_resnet(model, seed=seed, device=dev)
    hvd.broadcast_parameters(params, root_rank=0)
    leaves = hvd.tree_leaves(params)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(leaves, lr=0.1,
                                                   momentum=0.9))
    step = hvd.make_train_step_with_state(R.resnet_loss_fn(model), opt)
    images, labels = R.synthetic_imagenet(batch * hvd.size(),
                                          image_size=image_size,
                                          num_classes=num_classes)
    data = hvd.shard_batch((images, labels))
    run = {"params": params, "stats": stats, "data": data}

    def one_step():
        run["stats"], loss = step(run["params"], run["stats"], run["data"])
        return loss

    losses = [one_step() for _ in range(warmup)]
    hvd.barrier_fence()
    t0 = time.perf_counter()
    losses += [one_step() for _ in range(iters)]
    hvd.barrier_fence()
    elapsed = time.perf_counter() - t0
    run.update(losses=[float(x) for x in losses], timed_seconds=elapsed,
               images_per_sec=batch * iters / elapsed,
               step_ms=elapsed / iters * 1e3,
               n_params=sum(p.numel() for p in leaves), one_step=one_step)
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--full", action="store_true",
                      help="ResNet-50 at 224 px through Trainer.fit")
    mode.add_argument("--bench", action="store_true",
                      help="bench.py's recipe; print one JSON line")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128,
                    help="--bench: images per rank")
    ap.add_argument("--image-size", type=int, default=224,
                    help="--bench: image height and width")
    ap.add_argument("--steps", type=int, default=20,
                    help="--bench: timed steps")
    ap.add_argument("--no-space-to-depth", dest="space_to_depth",
                    action="store_false",
                    help="--bench: the 7x7/s2 stem instead")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    if args.bench:
        run = bench(batch=args.batch, image_size=args.image_size,
                    iters=args.steps, space_to_depth=args.space_to_depth,
                    device=args.device)
        dev = hvd.device()
        out = {"metric": "resnet50_images_per_sec_per_chip",
               "value": run["images_per_sec"], "unit": "images/sec",
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "ranks": hvd.size(), "params": run["n_params"],
               "batch": args.batch, "image_size": args.image_size,
               "space_to_depth": args.space_to_depth,
               "step_ms": run["step_ms"], "losses": run["losses"]}
        if args.image_size == 224:
            out["tflops_per_chip"] = (RESNET50_TRAIN_FLOPS_PER_IMAGE
                                      * run["images_per_sec"] / 1e12)
            out["flops_source"] = "analytic"
        print(json.dumps(out))
    else:
        run = fit(full=args.full, epochs=args.epochs, device=args.device)
        if hvd.rank() == 0:
            for e, logs in enumerate(run["history"]):
                print(f"epoch {e}: {logs}")
        first, last = (run["history"][0]["loss"],
                       run["history"][-1]["loss"])
        if not args.full and not last < first:
            raise SystemExit("resnet50_synthetic: loss did not improve")
        print("resnet50_synthetic: OK")
    hvd.shutdown()


if __name__ == "__main__":
    main()
