"""horovod_tpu_torch's Keras frontend (frontends/keras.py, Keras 3 on its
torch backend) and examples/keras_mnist.py against horovod_tpu's.

Keras binds its backend once per process, and here it is bound to JAX
(tests/conftest.py, tests/test_keras_frontend.py), so the port's Keras
code runs in children started with ``KERAS_BACKEND=torch`` and jax
blocked, all started together in one module fixture:

* one rank: the port's counterpart of each of tests/test_keras_frontend.py's
  10 cases, one result per case;
* two gloo ranks: the reference's ``_model`` MLP (4 -> 8 -> 1) fitted from
  the same weights and data as the reference under ``hvd2`` (4 epochs,
  ``shuffle=False``, SGD with momentum 0.9, the staircase schedule): the
  losses of each epoch and the final weights within rtol 1e-5, atol 1e-6,
  the ranks bitwise equal; the warmup callback's logged ``lr`` equal to
  the reference's ``multiplier`` at the port's per-batch progress; the
  momentum correction (staircase and warmup) against plain SGD with
  momentum in numpy; shards that differ by rank, eagerly and under
  ``jit_compile=True``, with the ranks bitwise equal and each equal to the
  reference's fit of all the data at twice the batch; the eager ``apply``
  of per-rank gradients;
* ``python -m horovod_tpu_torch.examples.keras_mnist --device cpu``
  (≙ tests/test_examples.py::test_keras_mnist_example).

In this process (Keras on JAX) the port's ``DistributedOptimizer`` raises
its torch diagnosis and the ``callbacks`` namespace resolves lazily.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")

import horovod_tpu_torch as thvd  # noqa: E402
import horovod_tpu_torch.frontends.keras as tk  # noqa: E402
from gloo_job import REPO, GlooJob  # noqa: E402

BLOCK_JAX = "import sys\nsys.modules['jax'] = None\n"
TORCH_ENV = {"KERAS_BACKEND": "torch"}

CASES = """
import json
import traceback

import keras
import torch

import horovod_tpu_torch.frontends.keras as hk

assert keras.backend.backend() == "torch"


def _model(lr=0.1, opt=None):
    model = keras.Sequential([
        keras.layers.Input(shape=(4,)),
        keras.layers.Dense(8, activation="relu"),
        keras.layers.Dense(1),
    ])
    model.compile(optimizer=hk.DistributedOptimizer(
        opt or keras.optimizers.SGD(learning_rate=lr)), loss="mse")
    return model


def test_distributed_optimizer_keeps_wrapped_class_name():
    opt = hk.DistributedOptimizer(keras.optimizers.Adam(1e-3))
    assert opt.__class__.__name__ == "Adam"
    assert isinstance(opt, keras.optimizers.Adam)


def test_model_fit_trains_under_jit():
    # Keras on torch resolves jit_compile="auto" to eager.
    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype("float32")
    y = (x @ rng.randn(4, 1)).astype("float32")
    model = _model(lr=0.05)
    hist = model.fit(x, y, epochs=5, batch_size=16, verbose=0)
    assert model.jit_compile is False
    losses = hist.history["loss"]
    assert losses[-1] < losses[0] * 0.7, losses


def test_eager_apply_reduces_gradients():
    var = keras.Variable(np.zeros((2,), "float32"))
    opt = hk.DistributedOptimizer(keras.optimizers.SGD(learning_rate=1.0),
                                  average=True)
    opt.build([var])
    opt.apply([torch.tensor([1.0, 2.0])], [var])
    np.testing.assert_allclose(var.numpy(), [-1.0, -2.0], rtol=1e-6)


def test_broadcast_global_variables():
    model = _model()
    before = [v.numpy().copy() for v in model.variables]
    hk.broadcast_global_variables(model, root_rank=0)
    for b, v in zip(before, model.variables):
        np.testing.assert_array_equal(b, v.numpy())
        assert v.value.device == torch.device("cpu")


def test_broadcast_callback_runs_once():
    rng = np.random.RandomState(1)
    x = rng.randn(32, 4).astype("float32")
    y = rng.randn(32, 1).astype("float32")
    model = _model()
    cb = hk.callbacks.BroadcastGlobalVariablesCallback(0)
    model.fit(x, y, epochs=1, batch_size=16, verbose=0, callbacks=[cb])
    assert cb.broadcast_done


def test_metric_average_callback():
    cb = hk.callbacks.MetricAverageCallback()
    logs = {"loss": 4.0, "acc": 0.5, "name": "not-a-number",
            "t": torch.tensor(2.0)}
    cb.on_epoch_end(0, logs)
    assert logs["loss"] == 4.0 and logs["acc"] == 0.5
    assert logs["name"] == "not-a-number"
    assert logs["t"] == 2.0 and isinstance(logs["t"], float)


def test_lr_warmup_callback_ramps_to_initial():
    # At one rank the warmup starts at initial / size = initial: the ramp
    # itself is held at two ranks (test_warmup_lr_follows_the_reference).
    rng = np.random.RandomState(2)
    x = rng.randn(64, 4).astype("float32")
    y = rng.randn(64, 1).astype("float32")
    model = _model(lr=0.8)
    warm = hk.callbacks.LearningRateWarmupCallback(warmup_epochs=3)
    assert warm.staircase is False  # the per-batch ramp runs on torch
    hist = model.fit(x, y, epochs=4, batch_size=16, verbose=0,
                     callbacks=[warm])
    lrs = hist.history["lr"]
    assert lrs == [float(np.float32(0.8))] * 4, lrs
    assert warm.multiplier(0.25) == 1.0


def test_lr_schedule_callback_staircase():
    rng = np.random.RandomState(3)
    x = rng.randn(32, 4).astype("float32")
    y = rng.randn(32, 1).astype("float32")
    model = _model(lr=0.4)
    sched = hk.callbacks.LearningRateScheduleCallback(
        multiplier=lambda epoch: 0.1 if epoch >= 2 else 1.0,
        start_epoch=0)
    hist = model.fit(x, y, epochs=4, batch_size=16, verbose=0,
                     callbacks=[sched])
    lrs = hist.history["lr"]
    np.testing.assert_allclose(lrs[0], 0.4, rtol=1e-5)
    np.testing.assert_allclose(lrs[3], 0.04, rtol=1e-5)


def test_momentum_correction_restores_true_momentum():
    rng = np.random.RandomState(4)
    x = rng.randn(32, 4).astype("float32")
    y = rng.randn(32, 1).astype("float32")
    model = _model(opt=keras.optimizers.SGD(learning_rate=0.4,
                                            momentum=0.9))
    warm = hk.callbacks.LearningRateWarmupCallback(warmup_epochs=2)
    model.fit(x, y, epochs=3, batch_size=16, verbose=0, callbacks=[warm])
    assert float(model.optimizer.momentum) == 0.9


def test_distributed_optimizer_config_roundtrip():
    opt = hk.DistributedOptimizer(
        keras.optimizers.SGD(learning_rate=0.3, momentum=0.7))
    cfg = opt.get_config()
    clone = keras.optimizers.SGD.from_config(cfg)  # restores without hvd
    np.testing.assert_allclose(float(clone.learning_rate), 0.3, rtol=1e-6)
    assert clone.momentum == 0.7


results = {}
with keras.device("cpu"):
    for name, fn in sorted(globals().copy().items()):
        if name.startswith("test_"):
            try:
                fn()
                results[name] = "ok"
            except Exception:
                results[name] = traceback.format_exc()
out = {"results": np.frombuffer(json.dumps(results).encode(), np.uint8),
       "jax": np.asarray(sys.modules.get("jax") is not None)}
finish(out)
"""

PARITY = """
import functools

import keras
import torch

import horovod_tpu_torch.frontends.keras as hk
from horovod_tpu_torch.ops import collective as C

out = {}


def model(prefix, opt, jit_compile="auto"):
    m = keras.Sequential([
        keras.layers.Input(shape=(4,)),
        keras.layers.Dense(8, activation="relu"),
        keras.layers.Dense(1),
    ])
    m.set_weights([D[f"{prefix}.{i}"] for i in range(4)])
    m.compile(optimizer=hk.DistributedOptimizer(opt), loss="mse",
              jit_compile=jit_compile)
    return m


def fit(m, x, y, epochs, callbacks=()):
    return m.fit(x, y, epochs=epochs, batch_size=16, shuffle=False,
                 verbose=0, callbacks=list(callbacks)).history


def keep(tag, m, hist):
    for i, w in enumerate(m.get_weights()):
        out[f"{tag}.w{i}"] = w
    for k, v in hist.items():
        out[f"{tag}.{k}"] = np.asarray(v)


class Record(keras.callbacks.Callback):
    # The lr and momentum each step runs with (read after the schedule
    # set them) and the momentum each step leaves behind.

    def __init__(self, tag):
        super().__init__()
        self.tag, self.lr, self.mom, self.after = tag, [], [], []

    def on_train_batch_begin(self, batch, logs=None):
        opt = self.model.optimizer
        self.lr.append(float(keras.ops.convert_to_numpy(opt.learning_rate)))
        self.mom.append(float(opt.momentum))

    def on_train_batch_end(self, batch, logs=None):
        self.after.append(float(self.model.optimizer.momentum))

    def on_train_end(self, logs=None):
        for k in ("lr", "mom", "after"):
            out[f"{self.tag}.step_{k}"] = np.asarray(getattr(self, k))


with keras.device("cpu"):
    # The same data on both ranks: the reference's fit under hvd2.
    m = model("w", keras.optimizers.SGD(0.02, momentum=0.9))
    sched = hk.callbacks.LearningRateScheduleCallback(
        lambda e: 1.0 if e < 2 else 0.5, momentum_correction=False)
    keep("mc0", m, fit(m, D["x"], D["y"], 4, [sched]))
    assert {v.value.device.type for v in m.variables} == {"cpu"}

    # Momentum correction, staircase and per-batch warmup: each step's
    # lr and momentum recorded for the numpy oracle.
    m = model("w", keras.optimizers.SGD(0.02, momentum=0.9))
    sched = hk.callbacks.LearningRateScheduleCallback(
        lambda e: 1.0 if e < 2 else 0.5)
    keep("mc1", m, fit(m, D["x"], D["y"], 4, [sched, Record("mc1")]))
    m = model("w", keras.optimizers.SGD(0.05, momentum=0.9))
    warm = hk.callbacks.LearningRateWarmupCallback(warmup_epochs=3)
    keep("mwarm", m, fit(m, D["x"], D["y"], 4, [warm, Record("mwarm")]))

    m = model("w", keras.optimizers.SGD(0.4))
    warm = hk.callbacks.LearningRateWarmupCallback(warmup_epochs=3)
    keep("warm", m, fit(m, D["x"], D["y"], 4, [warm]))

    # Shards that differ by rank, rank 1 starting from other weights.
    x, y = D["x"][RANK::2], D["y"][RANK::2]
    start = "w" if RANK == 0 else "v"
    for jit in (False, True):
        before = C.stats()["tensors"]
        m = model(start, keras.optimizers.SGD(0.02, momentum=0.9),
                  jit_compile=jit)
        if jit:
            # Dynamo without the inductor's code generation (minutes on
            # the CPU): the graph breaks are Dynamo's either way.
            compile_, torch.compile = torch.compile, functools.partial(
                torch.compile, backend="eager")
        try:
            hist = fit(m, x, y, 2, [
                hk.callbacks.BroadcastGlobalVariablesCallback(0),
                hk.callbacks.MetricAverageCallback()])
        finally:
            if jit:
                torch.compile = compile_
        assert m.jit_compile is jit
        keep(f"shard{int(jit)}", m, hist)
        out[f"shard{int(jit)}.tensors"] = np.asarray(
            C.stats()["tensors"] - before)

    # The eager apply of per-rank gradients; a None gradient stays None.
    var = keras.Variable(np.zeros((2,), "float32"))
    var2 = keras.Variable(np.ones((1,), "float32"))
    opt = hk.DistributedOptimizer(keras.optimizers.SGD(learning_rate=1.0))
    opt.build([var, var2])
    grads = [torch.tensor([1.0, 2.0]) * (RANK + 1), None]
    red = hk._reduce_grads(list(grads), True)
    assert red[1] is None
    opt.apply([torch.tensor([1.0, 2.0]) * (RANK + 1)], [var])
    out["apply"] = var.numpy()
    out["apply.red"] = red[0].numpy()
out["jax"] = np.asarray(sys.modules.get("jax") is not None)
finish(out)
"""


def _data():
    rng = np.random.RandomState(11)
    x = rng.randn(64, 4).astype("float32")
    y = (x @ rng.randn(4, 1) + 0.1 * rng.randn(64, 1)).astype("float32")
    shapes = [(4, 8), (8,), (8, 1), (1,)]
    d = {"x": x, "y": y}
    for i, s in enumerate(shapes):
        d[f"w.{i}"] = (0.5 * rng.randn(*s)).astype("float32")
        d[f"v.{i}"] = (0.5 * rng.randn(*s)).astype("float32")
    return d


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The cases child, the 2-rank parity job and the example, started
    together."""
    d = _data()
    cases = GlooJob(tmp_path_factory.mktemp("keras_cases"), CASES, 1, {},
                    timeout=200, env=TORCH_ENV, head=BLOCK_JAX)
    parity = GlooJob(tmp_path_factory.mktemp("keras_parity"), PARITY, 2, d,
                     timeout=200, env=TORCH_ENV, head=BLOCK_JAX)
    save = tmp_path_factory.mktemp("keras_mnist") / "model.keras"
    env = {**os.environ, **TORCH_ENV, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    for k in ("RANK", "WORLD_SIZE"):
        env.pop(k, None)
    example = subprocess.Popen(
        [sys.executable, "-c",
         BLOCK_JAX + "import runpy\nrunpy.run_module("
         "'horovod_tpu_torch.examples.keras_mnist', run_name='__main__')",
         "--device", "cpu", "--epochs", "2", "--save", str(save)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    got = {}

    def get(name):
        if name not in got:
            if name == "cases":
                got[name] = cases.results()[0]
            elif name == "parity":
                got[name] = parity.results()
            else:
                try:
                    log = example.communicate(timeout=200)[0]
                finally:
                    if example.poll() is None:
                        example.kill()
                        example.wait()
                got[name] = (example.returncode, log, save)
        return got[name]

    try:
        yield get
    finally:
        cases.kill()
        parity.kill()
        if example.poll() is None:
            example.kill()
            example.wait()


# ---------------------------------------------------------------------------
# In this process: Keras is bound to JAX here
# ---------------------------------------------------------------------------

def test_the_backend_variable_is_never_overwritten():
    assert os.environ["KERAS_BACKEND"] == "jax"
    assert keras.backend.backend() == "jax"


def test_distributed_optimizer_raises_the_torch_diagnosis():
    with pytest.raises(RuntimeError, match="needs Keras on the torch "
                       "backend.*'jax'.*KERAS_BACKEND=torch"):
        tk.DistributedOptimizer(keras.optimizers.SGD(0.1))


def test_callbacks_resolve_lazily():
    assert isinstance(tk.callbacks, tk._CallbacksModule)
    for name in ("BroadcastGlobalVariablesCallback", "MetricAverageCallback",
                 "LearningRateScheduleCallback",
                 "LearningRateWarmupCallback"):
        assert issubclass(getattr(tk.callbacks, name),
                          keras.callbacks.Callback)
    with pytest.raises(AttributeError):
        tk.callbacks.NoSuchCallback


def test_reduce_grads_needs_init_and_passes_one_rank_through():
    """The reference's rules (frontends/keras.py:97-103): no init raises,
    one rank passes the gradients through as they are."""
    thvd.shutdown()
    with pytest.raises(thvd.NotInitializedError):
        tk._reduce_grads([torch.ones(2)], True)
    thvd.init(device="cpu")
    try:
        grads = [torch.ones(2), None]
        assert tk._reduce_grads(grads, True) is grads
    finally:
        thvd.shutdown()


# ---------------------------------------------------------------------------
# The children
# ---------------------------------------------------------------------------

REFERENCE_CASES = [
    "test_broadcast_callback_runs_once",
    "test_broadcast_global_variables",
    "test_distributed_optimizer_config_roundtrip",
    "test_distributed_optimizer_keeps_wrapped_class_name",
    "test_eager_apply_reduces_gradients",
    "test_lr_schedule_callback_staircase",
    "test_lr_warmup_callback_ramps_to_initial",
    "test_metric_average_callback",
    "test_model_fit_trains_under_jit",
    "test_momentum_correction_restores_true_momentum",
]


def test_the_cases_are_the_reference_files():
    import test_keras_frontend as R

    assert sorted(n for n in dir(R) if n.startswith("test_")) == \
        REFERENCE_CASES


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_reference_case_on_the_torch_backend(children, name):
    out = children("cases")
    results = json.loads(bytes(out["results"]).decode())
    assert not out["jax"]
    assert results[name] == "ok", results[name]


def _reference_fit(hvd2, d, momentum_correction):
    import test_keras_frontend as R

    model = R._model(opt=R.keras.optimizers.SGD(0.02, momentum=0.9))
    model.set_weights([d[f"w.{i}"] for i in range(4)])
    sched = R.hvdk.callbacks.LearningRateScheduleCallback(
        lambda e: 1.0 if e < 2 else 0.5,
        momentum_correction=momentum_correction)
    hist = model.fit(d["x"], d["y"], epochs=4, batch_size=16, shuffle=False,
                     verbose=0, callbacks=[sched])
    return hist.history, model.get_weights()


def test_fit_at_two_ranks_matches_the_reference(hvd2, children):
    d = _data()
    hist, weights = _reference_fit(hvd2, d, momentum_correction=False)
    outs = children("parity")
    for out in outs:
        assert not out["jax"]
        np.testing.assert_allclose(out["mc0.loss"], hist["loss"],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(out["mc0.lr"],
                                      np.asarray(hist["lr"]))
        for i, w in enumerate(weights):
            np.testing.assert_allclose(out[f"mc0.w{i}"], w, rtol=1e-5,
                                       atol=1e-6)
    for key in outs[0]:
        np.testing.assert_array_equal(outs[1][key], outs[0][key],
                                      err_msg=key)


def _sgd_oracle(weights, x, y, lrs, moms, batch=16):
    """Keras's SGD with momentum (m = mom * m - lr * g; w += m) on the
    4 -> 8 -> 1 relu MLP under mean squared error, in float64 numpy, one
    step per batch of ``x`` in order with the given lr and momentum.
    Returns the final weights and each epoch's mean batch loss."""
    w = [np.asarray(a, np.float64) for a in weights]
    vel = [np.zeros_like(a) for a in w]
    steps = len(x) // batch
    losses, epoch = [], []
    for k, (lr, mom) in enumerate(zip(lrs, moms)):
        b = k % steps
        xb = x[b * batch:(b + 1) * batch].astype(np.float64)
        yb = y[b * batch:(b + 1) * batch].astype(np.float64)
        pre = xb @ w[0] + w[1]
        h = np.maximum(pre, 0.0)
        err = h @ w[2] + w[3] - yb
        epoch.append(np.mean(err ** 2))
        dout = 2.0 * err / err.size
        dh = (dout @ w[2].T) * (pre > 0)
        grads = [xb.T @ dh, dh.sum(0), h.T @ dout, dout.sum(0)]
        for i, g in enumerate(grads):
            vel[i] = mom * vel[i] - lr * g
            w[i] = w[i] + vel[i]
        if b == steps - 1:
            losses.append(np.mean(epoch))
            epoch = []
    return w, losses


@pytest.mark.parametrize("tag", ["mc1", "mwarm"])
def test_momentum_correction_follows_horovods_rule(children, tag):
    """The correction of horovod/keras/callbacks.py:104-116: each adjusted
    step runs with the true momentum times new_lr / old_lr and the next
    step starts from the true momentum again, so it never compounds.  The
    fit (eager torch reads the corrected momentum, where the reference's
    jitted JAX step never does) matches plain SGD with momentum in numpy
    driven by the same lr and momentum per step."""
    d = _data()
    initial = {"mc1": 0.02, "mwarm": 0.05}[tag]
    for out in children("parity"):
        lrs, moms = out[f"{tag}.step_lr"], out[f"{tag}.step_mom"]
        assert len(lrs) == len(moms) == 16
        np.testing.assert_array_equal(out[f"{tag}.step_after"], 0.9)
        prev = np.concatenate([[np.float32(initial)], lrs[:-1]])
        ratio = lrs / prev
        changed = lrs != prev
        # An unchanged lr gives 0.9 * lr / lr: 0.9 up to rounding.
        np.testing.assert_allclose(moms, 0.9 * ratio, rtol=1e-6)
        assert moms.max() <= 0.9 * ratio.max() * (1 + 1e-6)
        if tag == "mc1":
            # The staircase halves the lr at epoch 2: its first step
            # alone runs at half the momentum.
            np.testing.assert_array_equal(changed, np.arange(16) == 8)
            np.testing.assert_allclose(moms[8], 0.45, rtol=1e-6)
        else:
            # The per-batch warmup: from initial / 2 at the first step to
            # initial over 3 epochs, then left alone.
            # The ramp reaches initial at epoch 2's first step.
            assert changed[:9].all() and not changed[9:].any()
            assert moms[0] < 0.9 < moms[1:9].min() and moms.max() < 1.0
        want, losses = _sgd_oracle([d[f"w.{i}"] for i in range(4)],
                                   d["x"], d["y"], lrs, moms)
        for i, w in enumerate(want):
            np.testing.assert_allclose(out[f"{tag}.w{i}"], w, rtol=1e-5,
                                       atol=1e-6)
        np.testing.assert_allclose(out[f"{tag}.loss"], losses, rtol=1e-5,
                                   atol=1e-6)
    # The corrected staircase step moved the weights.
    assert out["mc1.loss"][3] != out["mc0.loss"][3]


def test_warmup_lr_follows_the_reference(hvd2, children):
    """The logged lr of each epoch is the one its last batch set: the
    reference's multiplier (at size 2) at progress e + 3/4."""
    import test_keras_frontend as R

    ref = R.hvdk.callbacks.LearningRateWarmupCallback(warmup_epochs=3)
    assert ref.staircase  # epoch steps on the JAX backend
    steps, initial = 4, float(np.float32(0.4))
    want = [np.float32(initial * ref.multiplier(min(e, 2) + (steps - 1)
                                                / steps))
            for e in range(4)]
    for out in children("parity"):
        np.testing.assert_array_equal(out["warm.lr"],
                                      np.asarray(want, np.float64))
    assert want[0] < want[1] < want[2] == np.float32(0.4)


def test_shards_that_differ_keep_the_ranks_equal(children):
    outs = children("parity")
    for tag in ("shard0", "shard1"):
        for i in range(4):
            np.testing.assert_array_equal(outs[1][f"{tag}.w{i}"],
                                          outs[0][f"{tag}.w{i}"])
        # The metric averaged over the ranks.
        np.testing.assert_array_equal(outs[1][f"{tag}.loss"],
                                      outs[0][f"{tag}.loss"])
    # Under jit_compile=True (torch.compile) the gradients are reduced as
    # they are eagerly: the same tensors cross the wire, the same weights.
    for out in outs:
        assert out["shard1.tensors"] == out["shard0.tensors"] > 0
        for i in range(4):
            np.testing.assert_array_equal(out[f"shard1.w{i}"],
                                          out[f"shard0.w{i}"])
        np.testing.assert_array_equal(out["apply.red"], [1.5, 3.0])
        np.testing.assert_array_equal(out["apply"], [-1.5, -3.0])


@pytest.mark.parametrize("tag", ["shard0", "shard1"])
def test_shard_fit_at_two_ranks_matches_the_full_batch_reference(
        hvd2, children, tag):
    """Rank r fits x[r::2] at batch 16, so each averaged step is the
    gradient of the whole batch of 32 rows x[32k:32k+32]: the reference's
    fit of all the data at batch 32 from rank 0's weights, eagerly
    (shard0) and under jit_compile=True (shard1)."""
    import test_keras_frontend as R

    d = _data()
    model = R._model(opt=R.keras.optimizers.SGD(0.02, momentum=0.9))
    model.set_weights([d[f"w.{i}"] for i in range(4)])
    hist = model.fit(d["x"], d["y"], epochs=2, batch_size=32, shuffle=False,
                     verbose=0).history
    for out in children("parity"):
        np.testing.assert_allclose(out[f"{tag}.loss"], hist["loss"],
                                   rtol=1e-5, atol=1e-6)
        for i, w in enumerate(model.get_weights()):
            np.testing.assert_allclose(out[f"{tag}.w{i}"], w, rtol=1e-5,
                                       atol=1e-6)


def test_keras_mnist_example(children):
    rc, log, save = children("example")
    assert rc == 0 and "keras_mnist: OK" in log, log
    assert save.exists()
