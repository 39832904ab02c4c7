"""Uneven-workload training with ``join()``: the port's twin of
examples/uneven_join.py.  Rank r has 2r more batches than rank 0; a rank
out of data calls ``join()`` and contributes zeros to the others'
remaining gradient allreduces (which still divide by the full size:
Horovod's Join semantics).  ``join()`` returns the rank that joined
last, which saw every one of its batches; its weights are broadcast as
the final model.

    python -m horovod_tpu_torch.examples.uneven_join --device cpu
    torchrun --nproc-per-node 2 -m horovod_tpu_torch.examples.uneven_join --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import horovod_tpu_torch as hvd


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4,
                    help="rank r runs steps + 2r steps")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    hvd.init(device=args.device)
    rank, size, dev = hvd.rank(), hvd.size(), hvd.device()
    steps = args.steps + 2 * rank
    w_true = torch.tensor([2.0, -1.0], device=dev)
    rng = np.random.RandomState(rank)
    X = torch.from_numpy(rng.normal(size=(steps, 16, 2)).astype("float32"))
    X = X.to(dev)
    y = X @ w_true

    w = hvd.broadcast(torch.zeros(2, device=dev), root_rank=0, name="w.init")
    for i in range(steps):
        grad = 2.0 * X[i].T @ (X[i] @ w - y[i]) / X.shape[1]
        # Ranks that already joined contribute zeros here.
        grad = hvd.allreduce(grad, average=True, name=f"grad.{i}")
        w = w - 0.1 * grad

    last = hvd.join()
    w = hvd.broadcast(w, root_rank=last, name="w.final")
    err = float((w - w_true).abs().sum())
    print(f"uneven_join: OK rank={rank} size={size} steps={steps} "
          f"last_joined={last} w={[round(v, 3) for v in w.tolist()]} "
          f"err={err:.3f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
