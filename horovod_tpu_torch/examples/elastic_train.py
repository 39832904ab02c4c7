"""Elastic training: commit and roll back state, relaunch automatically
(the port's twin of examples/elastic_train.py).

The training function is wrapped in ``@elastic.run`` and commits its
state every two steps.  If a worker dies, the survivors diagnose the
failure and exit EX_TEMPFAIL, and the elastic launcher relaunches the
job, which resumes from the last commit instead of from scratch.

Run (2 processes on the CPU, with a simulated failure)::

    HVD_TPU_EXAMPLE_DIE_AT=5 \\
    python -m horovod_tpu_torch.run --elastic -np 2 \\
        -m horovod_tpu_torch.examples.elastic_train --device cpu

Environment: ``HVD_TPU_EXAMPLE_STEPS`` (default 8),
``HVD_TPU_EXAMPLE_DIE_AT`` (the step at which rank 1 dies, once, in the
first incarnation; unset, no failure).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

import horovod_tpu_torch as hvd
from horovod_tpu_torch import elastic


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    hvd.init(device=args.device)
    rank, size, dev = hvd.rank(), hvd.size(), hvd.device()
    total = int(os.environ.get("HVD_TPU_EXAMPLE_STEPS", "8"))
    die_at = os.environ.get("HVD_TPU_EXAMPLE_DIE_AT")
    edir = os.environ.get("HVD_TPU_ELASTIC_DIR")
    if die_at is not None and edir is None:
        # Without the elastic launcher there is no relaunch (and no
        # place for the die-once marker): the death would end the job.
        if rank == 0:
            print("elastic_train: HVD_TPU_EXAMPLE_DIE_AT ignored — "
                  "run under `python -m horovod_tpu_torch.run --elastic`")
        die_at = None
    marker = os.path.join(edir, "example_victim_died") if edir else None

    # The same data in every incarnation, so that a recovered run ends
    # where an uninterrupted one does.
    w_true = np.array([1.5, -0.5], dtype="float32")
    rng = np.random.RandomState(100 + rank)
    X = rng.normal(size=(total, 16, 2)).astype("float32")
    y = X @ w_true
    X, y = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)

    state = elastic.State(w=torch.zeros(2, device=dev), step=0)

    @elastic.run
    def train(state):
        if state.step > 0:
            print(f"elastic_train: resumed rank={rank} "
                  f"from committed step {state.step}")
        while state.step < total:
            i = state.step
            if (die_at is not None and rank == 1 and i == int(die_at)
                    and not os.path.exists(marker)):
                open(marker, "w").close()
                print(f"elastic_train: rank 1 dying at step {i}",
                      flush=True)
                os._exit(1)  # a hard failure: no handshake
            xb, yb = X[i], y[i]
            grad = 2.0 * xb.T @ (xb @ state.w - yb) / xb.shape[0]
            grad = hvd.allreduce(grad, average=True, name=f"el.grad.{i}")
            state.w = state.w - 0.1 * grad
            state.step += 1
            if state.step % 2 == 0:
                state.commit()
        state.commit()
        return state.w.cpu().numpy()

    w = train(state)
    err = float(np.abs(w - w_true).sum())
    print(f"elastic_train: OK rank={rank} size={size} steps={total} "
          f"w={w.round(4).tolist()} err={err:.4f}")
    hvd.shutdown()


if __name__ == "__main__":
    main()
