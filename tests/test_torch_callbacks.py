"""horovod_tpu_torch's callbacks and Trainer against horovod_tpu's.

* The per-batch (lr, momentum) sequence of LR warm-up, a staircase and a
  smooth schedule with momentum correction, from the port's Trainer on two
  gloo ranks (so the warm-up multiplier is not 1) against the reference's
  Trainer on two devices; warmup_then_decay_schedule against the
  reference's optax schedule; MetricAverageCallback and
  BroadcastGlobalVariablesCallback across the two ranks.
* MetricAverageCallback's dtype contract against the reference's.
* ResNet18Thin (f32) through the reference's Trainer and the port's for
  one epoch of 4 steps, SGD with momentum, on one device: epoch losses
  within 1e-4.
* The Trainer's surface: lr/momentum properties, log_every, prefetch=0
  equal to prefetched training, zero/fsdp built (their lr and momentum
  reach the shard's optimizer) and refused together.
* The two example twins run on the CPU when asked to, their loss falls,
  and they refuse to start without a GPU otherwise.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu
import horovod_tpu.callbacks as jcb
import horovod_tpu_torch as thvd
from horovod_tpu.frontends.loop import Trainer as JaxTrainer
from horovod_tpu.models import mnist as jm
from horovod_tpu.models import resnet as jr
from horovod_tpu_torch import callbacks as tcb
from horovod_tpu_torch.frontends.loop import Trainer
from horovod_tpu_torch.models import mnist as tm
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.utils.convert import params_from_jax, params_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Shared by the test and the port's worker processes (which import
# neither jax nor this file).
LR_CALLBACKS = textwrap.dedent("""
    EPOCHS, STEPS = 6, 3
    DECAYS = [(5, 0.1), (8, 0.01)]


    def _lr_callbacks(cb):
        # Warm-up over 2 epochs, x0.5 in epoch 3 (staircase, constant),
        # x0.1 in epoch 4 (staircase, callable) and a smooth 0.5^epoch
        # from epoch 5 (fractional epochs), all correcting momentum.
        return [cb.LearningRateWarmupCallback(warmup_epochs=2,
                                              steps_per_epoch=STEPS),
                cb.LearningRateScheduleCallback(multiplier=0.5,
                                                start_epoch=3, end_epoch=4),
                cb.LearningRateScheduleCallback(multiplier=lambda e: 0.1,
                                                start_epoch=4, end_epoch=5),
                cb.LearningRateScheduleCallback(
                    multiplier=lambda e: 0.5 ** e, start_epoch=5,
                    staircase=False)]
""")
exec(LR_CALLBACKS)


WORKER = LR_CALLBACKS + textwrap.dedent("""
    import json
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks as cb
    from horovod_tpu_torch.frontends.loop import Trainer
    from horovod_tpu_torch.models import mnist as M

    rank, store_path = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    hvd.init(device="cpu")
    images, labels = M.synthetic_mnist(32)

    def batches(epoch, step):
        return images[:8], labels[:8]

    # The LR/momentum sequence, recorded after the LR callbacks.
    seq = []

    class Spy(cb.Callback):
        def on_batch_begin(self, batch, logs=None):
            seq.append((self.trainer.lr, self.trainer.momentum))

    model = M.MnistMLP(hidden=16)
    params = M.init_params(model)
    trainer = Trainer(
        lambda p, b: M.cross_entropy_loss(model.apply(p, b[0]), b[1]),
        params, lr=0.2, optimizer_kwargs={"momentum": 0.9},
        callbacks=[*_lr_callbacks(cb), Spy()])
    trainer.fit(batches, epochs=EPOCHS, steps_per_epoch=STEPS)
    schedule = cb.warmup_then_decay_schedule(1.0, 2, 4, DECAYS)

    # MetricAverageCallback across ranks: numbers average (ints as
    # floats, float64 arrays keep their dtype), strings pass through.
    logs = {"loss": float(rank), "arr": np.array([rank, 2.0 * rank]),
            "count": rank, "tag": "x"}
    cb.MetricAverageCallback().on_epoch_end(0, logs)
    assert logs["loss"] == 0.5 and isinstance(logs["loss"], float)
    assert logs["arr"].dtype == np.float64
    assert np.array_equal(logs["arr"], [0.5, 1.0])
    assert logs["count"] == 0.5 and logs["tag"] == "x"

    # BroadcastGlobalVariablesCallback: rank-dependent parameters and
    # statistics start equal, so the ranks stay equal.
    bn = M.MnistBNMLP(hidden=8)
    p, s = M.init_bn_mlp(bn, seed=rank)
    s = {"BatchNorm_0": {"mean": s["BatchNorm_0"]["mean"] + rank,
                         "var": s["BatchNorm_0"]["var"]}}
    seen = []

    class Peek(cb.Callback):
        def on_batch_begin(self, batch, logs=None):
            if not seen:
                seen.append(float(self.trainer.model_state["BatchNorm_0"]
                                  ["mean"].sum()))

    t2 = Trainer(M.bn_mlp_loss_fn(bn), p, lr=0.1, model_state=s,
                 callbacks=[cb.BroadcastGlobalVariablesCallback(0), Peek()])
    t2.fit(batches, epochs=1, steps_per_epoch=2)
    sums = hvd.allgather_object(
        [float(v.detach().sum()) for v in hvd.tree_leaves([p, s])])
    assert sums[0] == sums[1], sums
    assert seen == [0.0], seen  # rank 0's zero means, on both ranks

    if rank == 0:
        print("SEQ " + json.dumps(
            {"seq": seq, "schedule": [schedule(i) for i in range(40)]}))
    hvd.barrier()
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank)
""")


def test_callbacks_on_two_ranks_match_the_reference_trainer(tmp_path, hvd2):
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), store],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in out, out
    got = json.loads(next(line[4:] for line in outs[0].splitlines()
                          if line.startswith("SEQ ")))

    # Reference: the same callbacks on two devices.
    seq = []

    class Spy(jcb.Callback):
        def on_batch_begin(self, batch, logs=None):
            seq.append((self.trainer.lr, self.trainer.momentum))

    model = jm.MnistMLP(hidden=16)
    images, labels = jm.synthetic_mnist(32)

    def loss_fn(params, batch):
        return jm.cross_entropy_loss(model.apply({"params": params},
                                                 batch[0]), batch[1])

    trainer = JaxTrainer(loss_fn, jm.init_params(model), lr=0.2,
                         optimizer_kwargs={"momentum": 0.9},
                         callbacks=[*_lr_callbacks(jcb), Spy()])
    trainer.fit(lambda e, s: (images[:8], labels[:8]), epochs=EPOCHS,
                steps_per_epoch=STEPS)
    assert len(seq) == EPOCHS * STEPS
    # The reference keeps lr and momentum as f32 scalars (optax
    # inject_hyperparams), the port as Python floats.
    np.testing.assert_allclose(got["seq"], seq, rtol=1e-6)
    assert len({lr for lr, _ in seq}) > 5  # the schedule really moved
    sched = jcb.warmup_then_decay_schedule(1.0, 2, 4, DECAYS)
    np.testing.assert_allclose(got["schedule"],
                               [float(sched(i)) for i in range(40)],
                               rtol=1e-6)


@pytest.fixture()
def port_cpu():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


def test_metric_average_dtype_contract_matches_reference(hvd, port_cpu):
    from horovod_tpu.callbacks import _average_metric as javerage
    from horovod_tpu.ops import collective as JC
    from horovod_tpu_torch.callbacks import _average_metric as taverage
    from horovod_tpu_torch.ops import collective as TC

    cases = {"f64": np.linspace(0.0, 1.0, 5), "f32": np.array(
        [1.5, 2.5], np.float32), "i64": np.array([1, 2, 3], np.int64),
        "bool": np.array([True, False]), "int": 7, "float": 2.5,
        "np_f64": np.float64(2.5), "list": [1.0, 2.0, 4.0], "str": "tag"}
    for name, value in cases.items():
        want = javerage(JC.allreduce, name, value)
        got = taverage(TC.allreduce, name, value)
        if want is None:
            assert got is None, name
            continue
        assert type(got) is type(want), name
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


@pytest.fixture()
def hvd1():
    horovod_tpu.init(devices=jax.devices()[:1])
    yield horovod_tpu
    horovod_tpu.shutdown()


def test_resnet_epoch_through_both_trainers(hvd1, port_cpu):
    """ResNet18Thin at 33 px (see test_torch_resnet.py: its last stage is
    then 2x2), batch 4, SGD(0.05, momentum 0.9), one epoch of 4 steps
    with the staircase schedule callback, prefetch on both sides."""
    model = jr.ResNet18Thin(num_classes=10, compute_dtype=jnp.float32)
    tmodel = tr.ResNet18Thin(num_classes=10, compute_dtype=torch.float32)
    p, s = tr.init_resnet(tmodel)
    p, s = params_to_numpy(p), params_to_numpy(s)
    images, labels = jr.synthetic_imagenet(16, image_size=33,
                                           num_classes=10)

    def batches(epoch, step):
        return images[4 * step:4 * step + 4], labels[4 * step:4 * step + 4]

    ref = JaxTrainer(jr.resnet_loss_fn(model), p, lr=0.05,
                     optimizer_kwargs={"momentum": 0.9}, model_state=s,
                     callbacks=[jcb.LearningRateScheduleCallback(0.5)])
    want = ref.fit(batches, epochs=1, steps_per_epoch=4)
    mine = Trainer(tr.resnet_loss_fn(tmodel), params_from_jax(p), lr=0.05,
                   optimizer_kwargs={"momentum": 0.9},
                   model_state=params_from_jax(s, requires_grad=False),
                   callbacks=[tcb.LearningRateScheduleCallback(0.5)])
    got = mine.fit(batches, epochs=1, steps_per_epoch=4)
    assert abs(got[0]["loss"] - want[0]["loss"]) < 1e-4
    assert got[0]["lr"] == pytest.approx(want[0]["lr"], rel=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(mine.params)),
                    jax.tree_util.tree_leaves(ref.params)):
        assert float(np.max(np.abs(a - np.asarray(b)))) < 1e-4


def _mlp_trainer(callbacks=(), momentum=True):
    model = tm.MnistMLP(hidden=16)

    def loss_fn(p, b):
        return tm.cross_entropy_loss(model.apply(p, b[0]), b[1])

    kwargs = {"momentum": 0.9} if momentum else {}
    return Trainer(loss_fn, tm.init_params(model), lr=0.05,
                   optimizer_kwargs=kwargs, callbacks=list(callbacks))


def _mnist_batches(epoch, step):
    images, labels = tm.synthetic_mnist(16, seed=epoch * 100 + step)
    return images, labels


def test_trainer_prefetch_and_log_every(port_cpu):
    fetched = []

    class Spy(tcb.Callback):
        def on_batch_end(self, step, logs=None):
            if logs is not None:
                fetched.append((step, logs["loss"]))

    t1 = _mlp_trainer([Spy()])
    h1 = t1.fit(_mnist_batches, epochs=2, steps_per_epoch=6, log_every=3)
    assert [s for s, _ in fetched] == [2, 5, 2, 5]
    assert all(np.isfinite(v) for _, v in fetched)
    t2 = _mlp_trainer()
    h2 = t2.fit(_mnist_batches, epochs=2, steps_per_epoch=6, prefetch=0)
    assert h1 == h2  # prefetch reorders host work, never arithmetic
    for a, b in zip(thvd.tree_leaves(t1.params), thvd.tree_leaves(t2.params)):
        assert torch.equal(a, b)


def test_trainer_hyperparameters_and_refusals(port_cpu):
    t = _mlp_trainer()
    assert (t.lr, t.momentum, t.size) == (0.05, 0.9, 1)
    t.lr, t.momentum = 0.5, 0.8
    group = t.optimizer.param_groups[0]
    assert (group["lr"], group["momentum"]) == (0.5, 0.8)
    plain = _mlp_trainer(momentum=False)
    assert plain.momentum is None
    with pytest.raises(AttributeError, match="momentum"):
        plain.momentum = 0.9
    params = tm.init_params(tm.MnistMLP(hidden=4))
    for kw in ({"zero": True}, {"fsdp": True}):
        sharded = Trainer(lambda p, b: 0, params, lr=0.05,
                          optimizer_kwargs={"momentum": 0.9}, **kw)
        sharded.lr, sharded.momentum = 0.5, 0.8
        group = sharded.opt_state.optimizer.param_groups[0]
        assert (group["lr"], group["momentum"]) == (0.5, 0.8)
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(lambda p, b: 0, params, zero=True, fsdp=True)


@pytest.mark.parametrize("module", ["resnet50_synthetic", "mnist_callbacks"])
def test_example_runs_on_the_cpu_when_asked_and_loss_falls(module, tmp_path):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    # The ResNet example resumes from its checkpoint: a fresh one each
    # run, so that it trains both epochs.
    ckpt = (["--ckpt", str(tmp_path / "ckpt.msgpack")]
            if module == "resnet50_synthetic" else [])
    out = subprocess.run(
        [sys.executable, "-m", f"horovod_tpu_torch.examples.{module}",
         "--device", "cpu", "--epochs", "2", *ckpt], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and f"{module}: OK" in out.stdout, (
        out.stdout + out.stderr)
    if ckpt:
        assert "checkpoint saved" in out.stdout
        assert (tmp_path / "ckpt.msgpack.step").read_text() == "2"


def test_examples_refuse_to_start_without_a_gpu(monkeypatch):
    from horovod_tpu_torch.examples import mnist_callbacks
    from horovod_tpu_torch.examples import resnet50_synthetic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    thvd.shutdown()
    for call in (resnet50_synthetic.fit, resnet50_synthetic.bench):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    monkeypatch.setattr(sys, "argv", ["mnist_callbacks"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mnist_callbacks.main()
    assert not thvd.is_initialized()
