"""Workers of tests/test_torch_elastic_launch.py, run under ``python -m
horovod_tpu_torch.run``: the port's twins of tests/mp_worker.py's
``scenario_elastic`` and ``scenario_elastic2``, and a worker that hangs.

    python tests/torch_elastic_worker.py elastic|elastic2|hang
"""

import os
import sys
import time

import numpy as np


def _train(rank, total, data, deaths, tag):
    """The reference scenarios' linear regression under ``@elastic.run``:
    rank 1 dies hard at each step of ``deaths`` (once each, a marker file
    in the elastic directory), a commit every two steps."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import elastic

    edir = os.environ["HVD_TPU_ELASTIC_DIR"]
    X, y = (torch.from_numpy(a) for a in data[rank])
    state = elastic.State(w=torch.zeros(2), step=0)

    @elastic.run
    def train(state):
        if state.step > 0:
            print(f"{tag}_RESUMED rank={rank} step={state.step}", flush=True)
        while state.step < total:
            i = state.step
            marker = deaths.get(i)
            if rank == 1 and marker:
                marker = os.path.join(edir, marker)
                if not os.path.exists(marker):
                    open(marker, "w").close()
                    os._exit(1)  # a hard failure: no handshake
            xb, yb = X[i], y[i]
            grad = 2.0 * xb.T @ (xb @ state.w - yb) / xb.shape[0]
            grad = hvd.allreduce(grad, average=True, name=f"el.grad.{i}")
            state.w = state.w - 0.1 * grad
            state.step += 1
            if state.step % 2 == 0:
                state.commit()
        return state.w.numpy()

    try:
        return train(state)
    except SystemExit as e:
        # The survivor's own exit (EX_TEMPFAIL after the dead peer), not
        # the launcher's termination at the end of --grace.
        print(f"{tag}_EXIT rank={rank} code={e.code}", flush=True)
        raise


def _data(seed, total):
    w_true = np.array([1.0, -2.0], dtype="float32")
    out = []
    for r in range(2):
        rng = np.random.RandomState(seed + r)
        X = rng.normal(size=(total, 16, 2)).astype("float32")
        out.append((X, X @ w_true))
    return out


def replay(seed, total):
    """The uninterrupted run's arithmetic in numpy, f32 as the training
    loop (the reference test's replay)."""
    data = _data(seed, total)
    w = np.zeros(2, dtype="float32")
    for i in range(total):
        grads = [2.0 * X[i].T @ (X[i] @ w - y[i]) / X[i].shape[0]
                 for X, y in data]
        w = w - 0.1 * (grads[0] + grads[1]) / 2.0
    return w


def main():
    scenario = sys.argv[1]
    if scenario == "hang":
        # Rank 1 fails at once; rank 0 never notices (it joins no group)
        # and would run for ten minutes: the launcher's --grace ends it.
        if os.environ["RANK"] == "1":
            sys.exit(3)
        print("HANG rank=0 sleeping", flush=True)
        time.sleep(600)
        return
    import torch

    import horovod_tpu_torch as hvd

    torch.set_num_threads(1)
    hvd.init(device="cpu")
    rank = hvd.rank()
    if scenario == "elastic":
        w = _train(rank, 8, _data(17, 8), {5: "victim_died"}, "ELASTIC")
        print(f"ELASTIC_OK rank={rank} w={w.round(6).tolist()}", flush=True)
    elif scenario == "elastic2":
        w = _train(rank, 10, _data(23, 10),
                   {3: "victim_died_1", 7: "victim_died_2"}, "ELASTIC2")
        np.testing.assert_allclose(w, replay(23, 10), atol=1e-4)
        print(f"ELASTIC2_OK rank={rank}", flush=True)
    hvd.shutdown()


if __name__ == "__main__":
    main()
