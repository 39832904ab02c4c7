"""horovod_tpu_torch's device prefetch (parallel/input.py) and batch
placement, held to the reference's contract (tests/test_input.py): order,
bounded depth, depth validation, a loader exception re-raised with its
traceback, mid-epoch close, a blocked consumer woken by close, and
prefetched training equal to synchronous training.  On the CPU the stager
copies synchronously; the CUDA stream path runs in chip_smoke.py.
"""

import threading
import time
import traceback

import numpy as np
import pytest
import torch

import horovod_tpu_torch as thvd
from horovod_tpu_torch.parallel.input import device_put_batch


@pytest.fixture()
def port_cpu():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def _batches(n, rows=16, cols=4):
    for i in range(n):
        rng = np.random.RandomState(i)
        yield {"x": rng.normal(size=(rows, cols)).astype("float32"),
               "i": np.full((rows,), i, dtype="int64")}


def test_prefetch_preserves_order_and_values(port_cpu):
    got = list(thvd.prefetch_to_device(_batches(6)))
    assert len(got) == 6
    for i, (ref, dev) in enumerate(zip(_batches(6), got)):
        assert int(dev["i"][0]) == i
        assert isinstance(dev["x"], torch.Tensor)
        assert dev["x"].device == torch.device("cpu")
        np.testing.assert_array_equal(dev["x"].numpy(), ref["x"])


def test_prefetch_bounded_depth(port_cpu):
    """The stager runs at most ``depth`` batches ahead of the consumer
    (plus the one it is staging)."""
    produced = []

    def loader():
        for i in range(20):
            produced.append(i)
            yield np.full((8,), i, dtype="float32")

    it = thvd.prefetch_to_device(loader(), depth=2)
    time.sleep(0.5)  # let the stager run as far ahead as it ever will
    assert len(produced) <= 2 + 1, produced
    consumed = 0
    for _ in it:
        consumed += 1
        if consumed == 10:
            time.sleep(0.2)
            assert len(produced) <= consumed + 2 + 1, (len(produced),
                                                       consumed)
    assert consumed == 20
    it.close()


@pytest.mark.parametrize("depth", [0, -1])
def test_prefetch_depth_validation(port_cpu, depth):
    with pytest.raises(ValueError, match="depth"):
        thvd.prefetch_to_device(_batches(1), depth=depth)


def test_prefetch_loader_exception_propagates_with_traceback(port_cpu):
    def exploding():
        yield np.zeros((8,), "float32")
        raise ValueError("corrupt shard 7")

    it = thvd.prefetch_to_device(exploding(), depth=2)
    next(it)
    with pytest.raises(ValueError, match="corrupt shard 7") as exc_info:
        next(it)
    tb = "".join(traceback.format_exception(
        exc_info.type, exc_info.value, exc_info.tb))
    assert "exploding" in tb  # the loader's frame survived the thread hop
    with pytest.raises(StopIteration):  # dead, not wedged
        next(it)


def test_prefetch_clean_shutdown_mid_epoch(port_cpu):
    closed = threading.Event()

    def loader():
        try:
            for i in range(1000):
                yield np.full((8,), i, dtype="float32")
        finally:
            closed.set()

    it = thvd.prefetch_to_device(loader(), depth=2)
    assert int(next(it)[0]) == 0
    time.sleep(0.2)  # the queue fills up
    it.close()
    assert closed.wait(5.0), "the loader generator was never closed"
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
    it.close()  # idempotent


def test_prefetch_close_wakes_blocked_consumer(port_cpu):
    def never_yields():
        time.sleep(30.0)
        yield np.zeros((8,), "float32")

    it = thvd.prefetch_to_device(never_yields(), depth=1)
    threading.Timer(0.2, it.close).start()
    t0 = time.time()
    with pytest.raises(StopIteration):
        next(it)
    assert time.time() - t0 < 5.0, "consumer stayed blocked after close()"


def test_prefetch_context_manager_and_break(port_cpu):
    with thvd.prefetch_to_device(_batches(100), depth=2) as it:
        for k, _ in enumerate(it):
            if k == 3:
                break
    assert not it._thread.is_alive()


def test_prefetched_training_equals_synchronous(port_cpu):
    def loss_fn(p, batch):
        return ((batch["x"] @ p["w"] - batch["y"]) ** 2).mean()

    def data(n=8):
        for i in range(n):
            rng = np.random.RandomState(i)
            yield {"x": rng.normal(size=(16, 4)).astype("float32"),
                   "y": rng.normal(size=(16, 1)).astype("float32")}

    def train(batches):
        p = {"w": torch.zeros(4, 1, requires_grad=True)}
        step = thvd.make_train_step(
            loss_fn, torch.optim.SGD(thvd.tree_leaves(p), lr=0.05))
        for b in batches:
            step(p, b)
        thvd.barrier_fence(p)
        return p["w"].detach()

    sync = train(thvd.shard_batch(b) for b in data())
    with thvd.prefetch_to_device(data(), depth=2) as staged:
        prefetched = train(staged)
    assert torch.equal(sync, prefetched)


def test_shard_batch_takes_this_rank_s_rows(port_cpu):
    tree = {"a": np.arange(32, dtype="float32").reshape(8, 4),
            "b": (torch.ones(8, 2, dtype=torch.int32), np.zeros((8,)))}
    out = thvd.shard_batch(tree)
    assert torch.equal(out["a"], torch.arange(32.0).reshape(8, 4))
    assert out["b"][0].dtype == torch.int32 and out["b"][1].shape == (8,)
    with pytest.raises(ValueError, match="does not split"):
        device_put_batch(torch.tensor(1.0))
    thvd.barrier_fence()  # nothing to wait for on the CPU
    thvd.barrier_fence(out)
