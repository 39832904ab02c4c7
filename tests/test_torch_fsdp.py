"""horovod_tpu_torch's FSDP (parallel/fsdp.py) against horovod_tpu's:
every case of tests/test_fsdp.py on 4 ranks, and the Trainer's sharded
modes.

One spawned job of 4 gloo ranks runs the port's cases; then ranks 0 and
1 join a job of 2 and check that BroadcastGlobalVariablesCallback under
``Trainer(fsdp=True)`` reaches the shard from different initial weights.
The parent runs the reference's builders on 4 of the conftest's CPU
devices.  Weights are the reference's ``init_params``, carried across
with ``utils/convert.py``; each rank takes its quarter of
``synthetic_mnist``.  MnistMLP with hidden 32 (25,450 parameters) and
24 (19,090) are 2 more than a multiple of 4, so the flat vector is
padded.  Tolerances are the reference's own.  Port-only: no gathered
copy outlives a step, the broadcast reaches the shard, and
``Trainer(zero=True)``/``Trainer(fsdp=True)`` track ``Trainer()``.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as hvd_api
import horovod_tpu_torch as thvd
from gloo_job import OPTIMIZERS, GlooJob, flat, to_tree, unflat
from horovod_tpu.models import mnist as jm
from horovod_tpu.parallel.fsdp import (make_fsdp_train_step,
                                       make_fsdp_train_step_with_state)
from horovod_tpu.parallel.training import shard_batch
from horovod_tpu_torch.frontends.loop import Trainer
from horovod_tpu_torch.models import mnist as tm
from horovod_tpu_torch.parallel import fsdp as tf

N = 4
LOSS_RTOL, P_RTOL, P_ATOL = 1e-5, 1e-4, 1e-5
EPOCHS, STEPS = 3, 4

exec(OPTIMIZERS)

WORKER = f"EPOCHS, STEPS = {EPOCHS}, {STEPS}\n" + """
import horovod_tpu_torch.callbacks as cb
from horovod_tpu_torch.frontends.loop import Trainer
from horovod_tpu_torch.models import mnist as tm
from horovod_tpu_torch.ops.compression import Compression
from horovod_tpu_torch.parallel.data import DistributedOptimizer
from horovod_tpu_torch.parallel.fsdp import (make_fsdp_train_step,
                                             make_fsdp_train_step_with_state)
from horovod_tpu_torch.parallel.zero import _pad_flat

OPTS = {"sgdm": lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
        "adam": lambda ps: torch.optim.Adam(ps, lr=1e-2)}


def loss_of(model):
    def loss_fn(p, b):
        return tm.cross_entropy_loss(model.apply(p, b[0]), b[1])
    return loss_fn


def batch(k):
    return (rows(torch.from_numpy(D[f"images{k}"])),
            rows(torch.from_numpy(D[f"labels{k}"])))


def fsdp_run(prefix, opt, steps, b, hidden=32):
    f = make_fsdp_train_step(loss_of(tm.MnistMLP(hidden=hidden)), opt)
    ps, s = f.init(tree(prefix))
    losses = []
    for _ in range(steps):
        ps, s, loss = f.step(ps, s, b)
        losses.append(float(loss))
    return losses, f, ps, s


out = {}
b64 = batch(64)
for name, opt in OPTS.items():
    p = tree("p32")
    plain = hvd.make_train_step(loss_of(tm.MnistMLP(hidden=32)),
                                opt(hvd.tree_leaves(p)))
    out[f"plain.{name}.losses"] = [float(plain(p, b64)) for _ in range(5)]
    out.update(flat(f"plain.{name}", p))
    losses, f, ps, _ = fsdp_run("p32", opt, 5, b64)
    out[f"fsdp.{name}.losses"] = losses
    out.update(flat(f"fsdp.{name}", f.full_params(ps)))

_, _, ps, s = fsdp_run("p32", lambda ps: torch.optim.Adam(ps, lr=1e-3), 1,
                       b64)
st = s.optimizer.state[ps]
out["sharded.p_shard"] = tuple(ps.shape)
out["sharded.exp_avg"] = tuple(st["exp_avg"].shape)
out["sharded.exp_avg_sq"] = tuple(st["exp_avg_sq"].shape)
out["sharded.owned"] = s.shard is ps and \\
    s.optimizer.param_groups[0]["params"][0] is ps

f = make_fsdp_train_step(loss_of(tm.MnistMLP(hidden=24)),
                         lambda ps: torch.optim.SGD(ps, lr=0.1))
p_init, _ = f.init(tree("p24"))
out.update(flat("round", f.full_params(p_init)))
out["round.reshard_bitwise"] = torch.equal(
    f.shard_params(f.full_params(p_init)), p_init.detach())

out["converge.losses"], _, _, _ = fsdp_run(
    "p64", lambda ps: torch.optim.Adam(ps, lr=1e-3), 30, batch(256),
    hidden=64)

bn = tm.MnistBNMLP(hidden=32)
lf = tm.bn_mlp_loss_fn(bn)
b16 = batch(16)
p1, s1 = tree("bnp"), tree("bns", requires_grad=False)
plain = hvd.make_train_step_with_state(
    lf, torch.optim.SGD(hvd.tree_leaves(p1), lr=0.1, momentum=0.9))
f = make_fsdp_train_step_with_state(
    lf, lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9))
p2, o2 = f.init(tree("bnp"))
s2 = tree("bns", requires_grad=False)
ls1, ls2 = [], []
for _ in range(3):
    s1, l1 = plain(p1, s1, b16)
    p2, s2, o2, l2 = f.step(p2, s2, o2, b16)
    ls1.append(float(l1))
    ls2.append(float(l2))
out["state.plain.losses"], out["state.fsdp.losses"] = ls1, ls2
for tag, t in (("state.plain.p", p1), ("state.plain.s", s1),
               ("state.fsdp.p", f.full_params(p2)), ("state.fsdp.s", s2)):
    out.update(flat(tag, t))

_, f, ps, _ = fsdp_run("p32", lambda ps: torch.optim.SGD(ps, lr=0.1), 1, b64)
out.update(flat("exact", f.full_params(ps)))
dopt = DistributedOptimizer(torch.optim.SGD([torch.zeros(1)], lr=0.1),
                            compression=Compression.bf16)
_, f, ps, _ = fsdp_run("p32", dopt, 1, b64)
out.update(flat("comp", f.full_params(ps)))


def trainer_run(**kw):
    t = Trainer(loss_of(tm.MnistMLP(hidden=32)), tree("p32"), lr=0.1,
                callbacks=[cb.BroadcastGlobalVariablesCallback(0),
                           cb.LearningRateWarmupCallback(
                               warmup_epochs=1, steps_per_epoch=STEPS)],
                **kw)
    images = torch.from_numpy(D["images128"])
    labels = torch.from_numpy(D["labels128"])
    history = t.fit(lambda e, s: (images, labels), epochs=EPOCHS,
                    steps_per_epoch=STEPS)
    return t, [h["loss"] for h in history]


for mode in ("plain", "zero", "fsdp"):
    t, out[f"trainer.{mode}.losses"] = trainer_run(
        **({} if mode == "plain" else {mode: True}))
    out.update(flat(f"trainer.{mode}", t.params))
    out[f"trainer.{mode}.lr"] = t.lr
hvd.shutdown()
dist.destroy_process_group()

# Ranks 0 and 1 as a job of 2, each from other weights (seed = rank):
# the broadcast at train begin must reach the shard.
if RANK < 2:
    dist.init_process_group("gloo", store=dist.FileStore(STORE + ".2", 2),
                            rank=RANK, world_size=2)
    hvd.init(device="cpu")
    seen = {}

    class Spy(cb.Callback):
        def on_train_begin(self, logs=None):
            seen["params"] = self.trainer.params
            seen["shard"] = self.trainer._p_shard.detach().clone()

    model = tm.MnistMLP(hidden=16)
    root = tm.init_params(model, seed=0)
    t = Trainer(loss_of(model), tm.init_params(model, seed=RANK), lr=0.0,
                fsdp=True, callbacks=[cb.BroadcastGlobalVariablesCallback(0),
                                      Spy()])
    b32 = (torch.from_numpy(D["images32"]), torch.from_numpy(D["labels32"]))
    t.fit(lambda e, s: b32, epochs=1, steps_per_epoch=1)
    want, _, _ = _pad_flat(root, 2)
    chunk = want.numel() // 2
    out["bcast.shard_is_root"] = torch.equal(
        seen["shard"], want[RANK * chunk:(RANK + 1) * chunk])
    out["bcast.params_are_root"] = all(
        torch.equal(x, y.detach()) for x, y in
        zip(hvd.tree_leaves(seen["params"]), hvd.tree_leaves(root)))
    out["bcast.trained_from_root"] = all(
        torch.equal(x, y.detach()) for x, y in
        zip(hvd.tree_leaves(t.params), hvd.tree_leaves(root)))
    out.update(flat("bcast", t.params))
    finish(out)
else:
    save(out)
"""


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tree(data, prefix):
    return to_tree(unflat(data, prefix), jnp.asarray)


def _loss_fn(model):
    def loss_fn(params, batch):
        images, labels = batch
        return jm.cross_entropy_loss(model.apply({"params": params}, images),
                                     labels)
    return loss_fn


def _inputs():
    data = {}
    for hidden in (24, 32, 64):
        data.update(flat(_np(jm.init_params(jm.MnistMLP(hidden=hidden))),
                         f"p{hidden}"))
    bnp, bns = jm.init_bn_mlp(jm.MnistBNMLP(hidden=32))
    data.update(flat(_np(bnp), "bnp"))
    data.update(flat(_np(bns), "bns"))
    for k in (16, 32, 64, 128, 256):
        data[f"images{k}"], data[f"labels{k}"] = jm.synthetic_mnist(k)
    return data


def _batch(data, k):
    return shard_batch((jnp.asarray(data[f"images{k}"]),
                        jnp.asarray(data[f"labels{k}"])))


def _reference(data):
    """The reference's builders on 4 devices."""
    ref = {}
    b64 = _batch(data, 64)
    loss32 = _loss_fn(jm.MnistMLP(hidden=32))
    for name, ctor in (("sgdm", lambda: optax.sgd(0.1, momentum=0.9)),
                       ("adam", lambda: optax.adam(1e-2))):
        fstep = make_fsdp_train_step(loss32, ctor(), donate=False)
        ps, st = fstep.init(_tree(data, "p32"))
        losses = []
        for _ in range(5):
            ps, st, loss = fstep.step(ps, st, b64)
            losses.append(float(loss))
        ref[f"fsdp.{name}"] = (losses, flat(_np(fstep.full_params(ps)), ""))
    fstep = make_fsdp_train_step(loss32, optax.adam(1e-3))
    ps, st = fstep.init(_tree(data, "p32"))
    ref["sharded"] = [(tuple(leaf.shape), {s.data.shape[0] for s in
                                           leaf.addressable_shards})
                      for leaf in [ps] + jax.tree_util.tree_leaves(st)
                      if leaf.ndim >= 1]

    bn = jm.MnistBNMLP(hidden=32)
    fstep = make_fsdp_train_step_with_state(
        jm.bn_mlp_loss_fn(bn), optax.sgd(0.1, momentum=0.9), donate=False)
    p2, o2 = fstep.init(_tree(data, "bnp"))
    s2 = _tree(data, "bns")
    b16 = _batch(data, 16)
    losses = []
    for _ in range(3):
        p2, s2, o2, loss = fstep.step(p2, s2, o2, b16)
        losses.append(float(loss))
    ref["with_state"] = (losses, flat(_np(fstep.full_params(p2)), ""),
                         flat(_np(s2), ""))

    from horovod_tpu.ops.compression import Compression

    comp = make_fsdp_train_step(
        loss32, hvd_api.DistributedOptimizer(optax.sgd(0.1),
                                             compression=Compression.bf16),
        donate=False)
    pc, sc = comp.init(_tree(data, "p32"))
    pc, _, _ = comp.step(pc, sc, b64)
    ref["comp"] = flat(_np(comp.full_params(pc)), "")

    import horovod_tpu.callbacks as jcb
    from horovod_tpu.frontends.loop import Trainer as JaxTrainer

    trainer = JaxTrainer(
        loss32, _tree(data, "p32"), optimizer_fn=optax.sgd, lr=0.1,
        fsdp=True,
        callbacks=[jcb.BroadcastGlobalVariablesCallback(0),
                   jcb.LearningRateWarmupCallback(warmup_epochs=1,
                                                  steps_per_epoch=STEPS)])
    images, labels = (jnp.asarray(data["images128"]),
                      jnp.asarray(data["labels128"]))
    history = trainer.fit(lambda e, s: (images, labels), epochs=EPOCHS,
                          steps_per_epoch=STEPS)
    ref["trainer"] = ([h["loss"] for h in history],
                      flat(_np(trainer.params), ""), trainer.lr)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data = _inputs()
    job = GlooJob(tmp_path_factory.mktemp("fsdp"), WORKER, N, data)
    try:
        hvd_api.init(devices=jax.devices()[:N])
        try:
            ref = _reference(data)
        finally:
            hvd_api.shutdown()
    except BaseException:
        job.kill()
        raise
    return ref, job.results()


def _close_tree(got, want, rtol, atol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("opt", ["sgdm", "adam"])
def test_fsdp_matches_plain_dp(runs, opt):
    """The port's FSDP step against the reference's and against the
    port's own monolithic step, 5 steps on 4 ranks."""
    ref, outs = runs
    ref_losses, ref_params = ref[f"fsdp.{opt}"]
    for out in outs:
        got = unflat(out, f"fsdp.{opt}")
        np.testing.assert_allclose(out[f"fsdp.{opt}.losses"][-1],
                                   ref_losses[-1], rtol=LOSS_RTOL)
        _close_tree(got, unflat(ref_params, ""), P_RTOL, P_ATOL, "vs ref")
        np.testing.assert_allclose(out[f"fsdp.{opt}.losses"],
                                   out[f"plain.{opt}.losses"],
                                   rtol=LOSS_RTOL)
        _close_tree(got, unflat(out, f"plain.{opt}"), P_RTOL, P_ATOL,
                    "vs plain")


def test_fsdp_params_and_state_are_sharded(runs):
    """The parameters and Adam's moments are (padded / 4,)-slices on each
    rank, as the reference's are sharded; the shard is the tensor the
    optimizer owns."""
    ref, outs = runs
    padded = -(-25450 // N) * N
    assert ref["sharded"] == [((padded,), {padded // N})] * 3
    for out in outs:
        for key in ("sharded.p_shard", "sharded.exp_avg",
                    "sharded.exp_avg_sq"):
            assert tuple(out[key]) == (padded // N,)
        assert bool(out["sharded.owned"])


def test_fsdp_full_params_round_trips(runs):
    """init -> full_params gives the original tree back bitwise."""
    _, outs = runs
    want = flat(_np(jm.init_params(jm.MnistMLP(hidden=24))), "")
    for out in outs:
        got = unflat(out, "round")
        assert set(got) == set(unflat(want, ""))
        for k, v in unflat(want, "").items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            assert got[k].tobytes() == v.tobytes()


def test_fsdp_training_converges(runs):
    _, outs = runs
    for out in outs:
        losses = out["converge.losses"]
        assert losses[-1] < losses[0] * 0.7, losses[::10]


def test_fsdp_with_state_matches_plain_dp(runs):
    ref, outs = runs
    ref_losses, ref_p, ref_s = ref["with_state"]
    for out in outs:
        for want_l, want_p, want_s in (
                (ref_losses, unflat(ref_p, ""), unflat(ref_s, "")),
                (out["state.plain.losses"], unflat(out, "state.plain.p"),
                 unflat(out, "state.plain.s"))):
            np.testing.assert_allclose(out["state.fsdp.losses"], want_l,
                                       rtol=1e-4)
            _close_tree(unflat(out, "state.fsdp.p"), want_p, 1e-3, 1e-5,
                        "params")
            _close_tree(unflat(out, "state.fsdp.s"), want_s, 1e-3, 1e-5,
                        "stats")


def test_fsdp_composes_with_compression(runs):
    ref, outs = runs
    for out in outs:
        comp, exact = unflat(out, "comp"), unflat(out, "exact")
        for k in exact:
            assert comp[k].dtype == exact[k].dtype == np.float32
            np.testing.assert_allclose(comp[k], exact[k], atol=5e-3)
            np.testing.assert_allclose(comp[k], unflat(ref["comp"], "")[k],
                                       atol=5e-3)


def test_fsdp_rejects_global_norm_clipping(port_cpu):
    with pytest.raises(ValueError, match="ELEMENTWISE"):
        tf.make_fsdp_train_step(
            lambda p, b: 0,
            lambda ps: GlobalNormClipSGD(ps, lr=0.1, max_norm=1.0))  # noqa: F821


def test_fsdp_shard_params_round_trips(runs):
    _, outs = runs
    for out in outs:
        assert bool(out["round.reshard_bitwise"])


def test_fsdp_trainer_integration(runs):
    """Trainer(fsdp=True) with the broadcast and warm-up callbacks: the
    loss falls, params is the whole tree, the LR reaches its base, and
    the history and weights track the reference's Trainer(fsdp=True)."""
    ref, outs = runs
    ref_losses, ref_params, ref_lr = ref["trainer"]
    for out in outs:
        losses = out["trainer.fsdp.losses"]
        assert losses[-1] < losses[0]
        got = unflat(out, "trainer.fsdp")
        assert set(got) == set(unflat(ref_params, ""))
        np.testing.assert_allclose(float(out["trainer.fsdp.lr"]), 0.1,
                                   rtol=1e-5)
        np.testing.assert_allclose(float(out["trainer.fsdp.lr"]), ref_lr,
                                   rtol=1e-6)
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
        _close_tree(got, unflat(ref_params, ""), P_RTOL, P_ATOL, "vs ref")


def test_trainer_zero_and_fsdp_track_the_plain_trainer(runs):
    _, outs = runs
    for out in outs:
        for mode in ("zero", "fsdp"):
            np.testing.assert_allclose(out[f"trainer.{mode}.losses"],
                                       out["trainer.plain.losses"],
                                       rtol=LOSS_RTOL)
            _close_tree(unflat(out, f"trainer.{mode}"),
                        unflat(out, "trainer.plain"), P_RTOL, P_ATOL, mode)


def test_fsdp_broadcast_callback_reaches_the_shard(runs):
    """Two ranks from other weights: after the broadcast at train begin,
    each rank's shard is its slice of rank 0's weights, and reading
    params gathers rank 0's tree."""
    _, outs = runs
    for out in outs[:2]:
        assert bool(out["bcast.shard_is_root"])
        assert bool(out["bcast.params_are_root"])
        assert bool(out["bcast.trained_from_root"])  # SGD at lr 0
    a, b = unflat(outs[0], "bcast"), unflat(outs[1], "bcast")
    assert set(a) == set(b)
    for k in a:
        assert a[k].tobytes() == b[k].tobytes()


def test_fsdp_shard_params_rejects_new_structure(port_cpu):
    params = tm.init_params(tm.MnistMLP(hidden=24))
    fstep = tf.make_fsdp_train_step(lambda p, b: 0,
                                    lambda ps: torch.optim.SGD(ps, lr=0.1))
    fstep.init(params)
    reordered = {"zzz_extra": torch.zeros(3), **params}
    with pytest.raises(ValueError, match="structure"):
        fstep.shard_params(reordered)


def test_fsdp_trainer_rejects_zero_and_fsdp(port_cpu):
    params = tm.init_params(tm.MnistMLP(hidden=16))
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(lambda p, b: 0, params, zero=True, fsdp=True)


def test_fsdp_step_before_init_raises(port_cpu):
    fstep = tf.make_fsdp_train_step(lambda p, b: 0,
                                    lambda ps: torch.optim.SGD(ps, lr=0.1))
    with pytest.raises(RuntimeError, match="init"):
        fstep.step(torch.zeros(8), None, None)
    with pytest.raises(RuntimeError, match="init"):
        fstep.full_params(torch.zeros(8))


def test_fsdp_keeps_no_gathered_copy(port_cpu):
    """The gathered flat parameters (the base every leaf of the step's
    tree views) are freed when step returns, by reference counting: with
    the garbage collector off, so that no reference cycle hides them."""
    model = tm.MnistMLP(hidden=16)
    bases = []

    def loss_fn(p, b):
        bases.append(weakref.ref(p["Dense_0"]["kernel"]._base))
        return tm.cross_entropy_loss(model.apply(p, b[0]), b[1])

    fstep = tf.make_fsdp_train_step(loss_fn,
                                    lambda ps: torch.optim.SGD(ps, lr=0.1))
    ps, st = fstep.init(tm.init_params(model))
    batch = tm.synthetic_mnist(8)
    gc.disable()
    try:
        for _ in range(2):
            ps, st, _ = fstep.step(ps, st, batch)
        assert len(bases) == 2 and all(ref() is None for ref in bases)
    finally:
        gc.enable()
    assert ps is st.shard and ps.grad is None


def test_trainer_warns_fusion_threshold_when_sharded(port_cpu):
    params = tm.init_params(tm.MnistMLP(hidden=16))
    for mode in ("zero", "fsdp"):
        with pytest.warns(UserWarning, match="fusion_threshold"):
            Trainer(lambda p, b: 0, params, fusion_threshold=1024,
                    **{mode: True})


@pytest.fixture()
def port_cpu():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()
