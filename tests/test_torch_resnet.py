"""horovod_tpu_torch's image models and stateful step against horovod_tpu's.

The reference runs on a one-device mesh: BatchNorm statistics are those
of each shard, so a one-rank port run equals a one-device reference run,
not a multi-device one.  Inputs come from numpy seeds; JAX parameter trees
are copied into the port (utils/convert.py).

* ResNet18Thin (classic and space-to-depth stems, at 32 and 33 px so that
  even and odd extents both hit the asymmetric SAME pads) and MnistBNMLP,
  f32 compute: logits, eval logits and the train loss within 1e-4 of
  max |value|, new batch statistics within 1e-5; MnistCNN and MnistMLP
  logits within 1e-4.
* bf16 compute within twice the reference's own bf16 error (argued in
  test_resnet18thin_bf16_forward_matches_flax).
* Two make_train_step_with_state SGD(0.1, momentum 0.9) steps: loss
  1e-5, parameters and statistics 1e-4.  make_eval_step likewise.
* ResNet-50: the tree's keys and shapes, 161 parameter and 106 statistic
  leaves, 25,557,032 parameters and the fusion-bucket plans equal the
  reference's (jax.eval_shape, no forward).
* Two gloo ranks in subprocesses against the reference on two devices
  with the same global batch: averaged statistics and parameters after
  one stateful step; allgather with ragged dim 0 and its mismatch errors,
  allgather_object, broadcast_object, shard_local_batch's row check.
* chip_smoke.py runs a resnet phase after the trainer phase.
"""

import functools
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import horovod_tpu
import horovod_tpu_torch as thvd
from horovod_tpu.models import mnist as jm
from horovod_tpu.models import resnet as jr
from horovod_tpu.parallel import data as jdata
from horovod_tpu.parallel import training as jtrain
from horovod_tpu_torch.models import layers
from horovod_tpu_torch.models import mnist as tm
from horovod_tpu_torch.models import resnet as tr
from horovod_tpu_torch.utils.convert import params_from_jax, params_to_numpy
from horovod_tpu_torch.utils.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}



def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want))) / max(float(np.max(np.abs(
        want))), 1e-30)


def _max_abs(got_tree, want_tree) -> float:
    got = jax.tree_util.tree_leaves(params_to_numpy(got_tree))
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    return max(float(np.max(np.abs(a - np.asarray(b, a.dtype))))
               for a, b in zip(got, want))


def _redraw_norms(tree, rng):
    """Every BatchNorm leaf redrawn: scales in [0.5, 1.5), biases and
    running means ~ N(0, 0.1), running variances in [0.5, 1.5)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _redraw_norms(v, rng)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(v.dtype)
        elif k == "mean" or (k == "bias" and "scale" in tree):
            out[k] = rng.normal(0.0, 0.1, v.shape).astype(v.dtype)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def _resnet_trees(space_to_depth: bool, redraw: bool):
    """ResNet18Thin's parameters and statistics as numpy trees, from the
    port's init (flax's tree: asserted for ResNet-50 below, and flax's
    apply checks every shape).  ``redraw``: every BatchNorm redrawn, so
    that no residual branch starts at zero (the last scale of a block is
    zero-initialised) and eval mode reads real running statistics.

    The f32 forward comparisons redraw.  The training steps and the bf16
    forward keep the init: once every branch is live, a batch norm over
    the few values of a 2x2 or 1x1 stage turns a float difference in an
    input into a kink of the next relu or a tie of a max-pool window
    that rounds the other way, and a gradient (or, in bf16, a logit)
    then differs by far more than the rounding.  That is a property of
    the inputs, not of either implementation."""
    p, s = tr.init_resnet(tr.ResNet18Thin(num_classes=10,
                                          space_to_depth=space_to_depth))
    p, s = params_to_numpy(p), params_to_numpy(s)
    if redraw:
        rng = np.random.RandomState(1)
        p, s = _redraw_norms(p, rng), _redraw_norms(s, rng)
    return p, s


def _reference_resnet(space_to_depth: bool, dtype: str, redraw=False):
    """(flax model, params, batch_stats)."""
    model = jr.ResNet18Thin(num_classes=10, compute_dtype=DTYPES[dtype][0],
                            space_to_depth=space_to_depth)
    return (model, *_resnet_trees(space_to_depth, redraw))


def _port_resnet(space_to_depth, dtype, params, stats):
    model = tr.ResNet18Thin(num_classes=10,
                            compute_dtype=DTYPES[dtype][1],
                            space_to_depth=space_to_depth)
    return (model, params_from_jax(params),
            params_from_jax(stats, requires_grad=False))


def _imagenet(n, px, num_classes=10, seed=0):
    images, labels = jr.synthetic_imagenet(n, image_size=px, seed=seed,
                                           num_classes=num_classes)
    timages, tlabels = tr.synthetic_imagenet(n, image_size=px, seed=seed,
                                             num_classes=num_classes)
    # The port's synthetic data is the reference's, value for value.
    assert np.array_equal(timages.numpy(), images)
    assert np.array_equal(tlabels.numpy(), labels)
    return images, labels, timages, tlabels


@pytest.fixture()
def hvd1():
    """The reference on a one-device mesh (BatchNorm statistics of the
    whole batch, as a one-rank port run)."""
    horovod_tpu.init(devices=jax.devices()[:1])
    yield horovod_tpu
    horovod_tpu.shutdown()


@pytest.fixture()
def port_cpu():
    thvd.init(device="cpu")
    yield thvd
    thvd.shutdown()


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size,window,stride,pads", [
    (224, 7, 2, (2, 3)),    # the 7x7/s2 stem
    (56, 3, 2, (0, 1)),     # the bottleneck's 3x3/s2, the stem's pool
    (112, 4, 1, (1, 2)),    # the space-to-depth 4x4/s1 stem
    (33, 3, 2, (1, 1)),     # odd extents pad symmetrically here
])
def test_same_pads_are_flax_s_and_keep_channels_last(size, window, stride,
                                                     pads):
    assert layers.same_pads(size, window, stride) == pads
    assert jax.lax.padtype_to_pads((size,), (window,), (stride,),
                                   "SAME") == [pads]
    x = torch.randn(2, size, size, 3).permute(0, 3, 1, 2)
    out = -(-size // stride)
    for y in (layers.conv_same(x, layers.oihw(torch.randn(window, window, 3,
                                                          4), torch.float32),
                               stride),
              layers.max_pool_same(x, window, stride)):
        assert y.shape[2:] == (out, out)
        assert y.is_contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# Forward passes against flax
# ---------------------------------------------------------------------------

def _reference_forward(model, loss_fn, p, s, x, y):
    """(train logits, new statistics, loss, eval logits) as numpy, from
    one jitted call (XLA compiles the model once, where op-by-op
    dispatch would compile each operation)."""

    @jax.jit
    def run(p, s, x, y):
        variables = {"params": p, "batch_stats": s}
        logits, mutated = model.apply(variables, x, train=True,
                                      mutable=["batch_stats"])
        loss, _ = loss_fn(p, s, (x, y))
        return (logits, mutated["batch_stats"], loss,
                model.apply(variables, x, train=False))

    logits, stats, loss, eval_logits = run(p, s, x, y)
    return (np.asarray(logits, np.float32), _np(stats),
            np.asarray(loss, np.float32), np.asarray(eval_logits, np.float32))


def _port_forward(tmodel, tloss_fn, tp, ts, tx, ty):
    """The same four from the port: apply, the loss function's own apply,
    and eval, which must leave the state alone."""
    tlogits, tstats = tmodel.apply(tp, ts, tx, train=True)
    tloss, tstats2 = tloss_fn(tp, ts, (tx, ty))
    teval, same = tmodel.apply(tp, ts, tx, train=False)
    assert same is ts
    assert tlogits.dtype == torch.float32 and teval.dtype == torch.float32
    for a, b in zip(tree_leaves(tstats), tree_leaves(tstats2)):
        assert torch.equal(a, b)
    return (tlogits.detach().numpy(), params_to_numpy(tstats),
            tloss.detach().numpy(), teval.detach().numpy())


def _pairs(got, want):
    """(name, got, want) over logits, each statistic leaf, loss, eval."""
    names = ["logits"] + [f"stats[{i}]" for i in range(
        len(jax.tree_util.tree_leaves(want[1])))] + ["loss", "eval"]
    gs = [got[0], *jax.tree_util.tree_leaves(got[1]), got[2], got[3]]
    ws = [want[0], *jax.tree_util.tree_leaves(want[1]), want[2], want[3]]
    assert len(gs) == len(ws)
    return zip(names, gs, ws)


def _check_f32(got, want):
    """Logits, loss and eval logits within 1e-4 of max |value|; each new
    statistic within 1e-5 (absolute)."""
    for name, g, w in _pairs(got, want):
        if name.startswith("stats"):
            assert float(np.max(np.abs(g - w))) < 1e-5, name
        else:
            assert _rel_err(g, w) < 1e-4, name


@pytest.mark.parametrize("space_to_depth", [False, True],
                         ids=["classic", "space_to_depth"])
@pytest.mark.parametrize("px", [32, 33])
def test_resnet18thin_f32_forward_matches_flax(space_to_depth, px):
    model, p, s = _reference_resnet(space_to_depth, "f32", redraw=True)
    tmodel, tp, ts = _port_resnet(space_to_depth, "f32", p, s)
    x, y, tx, ty = _imagenet(4, px)
    _check_f32(_port_forward(tmodel, tr.resnet_loss_fn(tmodel), tp, ts, tx,
                             ty),
               _reference_forward(model, jr.resnet_loss_fn(model), p, s, x,
                                  y))


@pytest.mark.parametrize("space_to_depth,px", [(False, 33), (True, 32)],
                         ids=["classic-33", "space_to_depth-32"])
def test_resnet18thin_bf16_forward_matches_flax(space_to_depth, px):
    """bf16 compute rounds every activation to 8 significant bits, and
    the port's sums run in other orders than XLA's, so a value can round
    to the neighbouring bf16 number and carry that into every later
    layer.  The scale of that is the reference's own bf16 error: how far
    its bf16 result lies from its f32 result on the same inputs.  Two
    bf16 implementations that differ only in rounding each lie about
    that far from the f32 result, so they may be up to about twice that
    apart: each value (relative to its largest magnitude) is held to
    twice the reference's bf16 error on it, and to no less than 2 *
    2^-8, one bf16 rounding, where that error happens to be smaller."""
    x, y, tx, ty = _imagenet(4, px)
    model16, p, s = _reference_resnet(space_to_depth, "bf16")
    model32, _, _ = _reference_resnet(space_to_depth, "f32")
    tmodel, tp, ts = _port_resnet(space_to_depth, "bf16", p, s)
    ref16 = _reference_forward(model16, jr.resnet_loss_fn(model16), p, s, x,
                               y)
    ref32 = _reference_forward(model32, jr.resnet_loss_fn(model32), p, s, x,
                               y)
    got = _port_forward(tmodel, tr.resnet_loss_fn(tmodel), tp, ts, tx, ty)
    for (name, g, w), (_, _, w32) in zip(_pairs(got, ref16),
                                         _pairs(ref16, ref32)):
        bound = 2 * max(_rel_err(w, w32), 2.0 ** -8)
        assert _rel_err(g, w) <= bound, (name, _rel_err(g, w), bound)


def test_mnist_bn_mlp_forward_matches_flax():
    model, tmodel = jm.MnistBNMLP(), tm.MnistBNMLP()
    p, s = _np(jm.init_bn_mlp(model))
    p, s = _redraw_norms(p, np.random.RandomState(2)), _redraw_norms(
        s, np.random.RandomState(3))
    x, y = jm.synthetic_mnist(16)
    tx, ty = tm.synthetic_mnist(16)
    assert np.array_equal(tx.numpy(), x) and np.array_equal(ty.numpy(), y)
    tp, ts = params_from_jax(p), params_from_jax(s, requires_grad=False)
    _check_f32(_port_forward(tmodel, tm.bn_mlp_loss_fn(tmodel), tp, ts, tx,
                             ty),
               _reference_forward(model, jm.bn_mlp_loss_fn(model), p, s, x,
                                  y))


@pytest.mark.parametrize("name", ["MnistCNN", "MnistMLP"])
def test_mnist_logits_match_flax(name):
    if name == "MnistCNN":
        model = jm.MnistCNN(compute_dtype=jnp.float32)
        tmodel = tm.MnistCNN(compute_dtype=torch.float32)
    else:
        model, tmodel = jm.MnistMLP(), tm.MnistMLP()
    p = _np(jax.jit(lambda: jm.init_params(model))())
    x, _ = jm.synthetic_mnist(8)
    got = tmodel.apply(params_from_jax(p), torch.from_numpy(x))
    assert _rel_err(got.detach(), model.apply({"params": p}, x)) < 1e-4
    # The port's own init: the reference's keys and shapes.
    mine = tree_leaves(tm.init_params(tmodel))
    assert [tuple(t.shape) for t in mine] == [
        w.shape for w in jax.tree_util.tree_leaves(p)]


def test_resnet50_tree_and_bucket_plan_match_reference():
    model = jr.ResNet50(num_classes=1000)
    p, s = jax.eval_shape(lambda: jr.init_resnet(model, image_size=32,
                                                 batch_size=2))
    tp, ts = tr.init_resnet(tr.ResNet50(num_classes=1000))
    want_p, want_s = (jax.tree_util.tree_leaves(p),
                      jax.tree_util.tree_leaves(s))
    assert (len(want_p), len(want_s)) == (161, 106)
    assert [tuple(t.shape) for t in tree_leaves(tp)] == [w.shape
                                                         for w in want_p]
    assert [tuple(t.shape) for t in tree_leaves(ts)] == [w.shape
                                                         for w in want_s]
    assert sorted(tp) == sorted(p) and sorted(ts) == sorted(s)
    assert sorted(tp["BottleneckBlock_0"]) == sorted(p["BottleneckBlock_0"])
    assert sum(t.numel() for t in tree_leaves(tp)) == 25_557_032
    for threshold in (0, 1 << 20, 16 << 20, 64 << 20):
        assert thvd.partition_fusion_buckets(tree_leaves(tp), threshold) \
            == jdata.partition_fusion_buckets(want_p, threshold)
    s2d = tr.init_resnet(tr.ResNet50(num_classes=1000, space_to_depth=True))
    assert tuple(s2d[0]["conv_init"]["kernel"].shape) == (4, 4, 12, 64)


# ---------------------------------------------------------------------------
# The stateful train step and the eval step
# ---------------------------------------------------------------------------

def _two_steps(hvd1, port_cpu, model, tmodel, p, s, x, y, tx, ty, loss_fn,
               tloss_fn):
    opt = optax.sgd(0.1, momentum=0.9)
    step = jtrain.make_train_step_with_state(loss_fn, opt, donate=False)
    params, stats = jax.tree_util.tree_map(jnp.asarray, (p, s))
    opt_state = opt.init(params)
    batch = jtrain.shard_batch((x, y))
    want = []
    for _ in range(2):
        params, stats, opt_state, loss = step(params, stats, opt_state,
                                              batch)
        want.append(float(loss))

    tp = params_from_jax(p)
    ts = params_from_jax(s, requires_grad=False)
    tstep = port_cpu.make_train_step_with_state(
        tloss_fn, torch.optim.SGD(tree_leaves(tp), lr=0.1, momentum=0.9))
    got = []
    for _ in range(2):
        ts, loss = tstep(tp, ts, (tx, ty))
        got.append(float(loss))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert _max_abs(tp, _np(params)) < 1e-4
    assert _max_abs(ts, _np(stats)) < 1e-4


@pytest.mark.parametrize("space_to_depth", [False, True],
                         ids=["classic", "space_to_depth"])
def test_two_stateful_sgd_steps_match_reference_resnet(hvd1, port_cpu,
                                                       space_to_depth):
    """At 33 px, where the last stage is 2x2: at 32 px it is 1x1, and its
    batch norms average over the 4 images alone, which stretches a float
    difference past 1e-5 by the second step."""
    px = 33
    model, p, s = _reference_resnet(space_to_depth, "f32")
    tmodel, _, _ = _port_resnet(space_to_depth, "f32", p, s)
    x, y, tx, ty = _imagenet(4, px)
    _two_steps(hvd1, port_cpu, model, tmodel, p, s, x, y, tx, ty,
               jr.resnet_loss_fn(model), tr.resnet_loss_fn(tmodel))


def test_two_stateful_sgd_steps_match_reference_bn_mlp(hvd1, port_cpu):
    model, tmodel = jm.MnistBNMLP(), tm.MnistBNMLP()
    p, s = _np(jm.init_bn_mlp(model))
    s = _redraw_norms(s, np.random.RandomState(3))
    x, y = jm.synthetic_mnist(16)
    tx, ty = tm.synthetic_mnist(16)
    _two_steps(hvd1, port_cpu, model, tmodel, p, s, x, y, tx, ty,
               jm.bn_mlp_loss_fn(model), tm.bn_mlp_loss_fn(tmodel))


def test_eval_step_matches_reference(hvd1, port_cpu):
    model, p, s = _reference_resnet(False, "f32")
    tmodel, tp, ts = _port_resnet(False, "f32", p, s)
    x, y, tx, ty = _imagenet(4, 32)

    def metric_fn(params, batch):
        logits = model.apply({"params": params, "batch_stats": s}, batch[0],
                             train=False)
        return {"loss": jm.cross_entropy_loss(logits, batch[1]),
                "accuracy": jm.accuracy(logits, batch[1])}

    def tmetric_fn(params, batch):
        logits, _ = tmodel.apply(params, ts, batch[0], train=False)
        return {"loss": tm.cross_entropy_loss(logits, batch[1]),
                "accuracy": tm.accuracy(logits, batch[1])}

    want = jtrain.make_eval_step(metric_fn)(p, jtrain.shard_batch((x, y)))
    got = port_cpu.make_eval_step(tmetric_fn)(tp, (tx, ty))
    assert sorted(got) == sorted(want)
    for k in want:
        assert not got[k].requires_grad
        assert abs(float(got[k]) - float(want[k])) < 1e-5, k


# ---------------------------------------------------------------------------
# Two gloo ranks against the reference on two devices
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import pytest
    import torch
    import torch.distributed as dist
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import resnet as R
    from horovod_tpu_torch.utils.tree import tree_leaves

    rank, store_path, data_path, out_path = (int(sys.argv[1]), *sys.argv[2:])
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    hvd.init(device="cpu")

    def unflatten(arrays):
        tree = {}
        for key, value in arrays.items():
            *path, leaf = key.split("/")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = torch.from_numpy(value)
        return tree

    data = np.load(data_path)
    params = unflatten({k[2:]: data[k] for k in data.files
                        if k.startswith("p/")})
    stats = unflatten({k[2:]: data[k] for k in data.files
                       if k.startswith("s/")})
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    model = R.ResNet18Thin(num_classes=10, compute_dtype=torch.float32)
    step = hvd.make_train_step_with_state(
        R.resnet_loss_fn(model),
        torch.optim.SGD(tree_leaves(params), lr=0.1, momentum=0.9))
    batch = hvd.shard_batch((torch.from_numpy(data["x"]),
                             torch.from_numpy(data["y"])))
    assert batch[0].shape[0] == 4
    stats, loss = step(params, stats, batch)

    def flatten(tree, prefix):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flatten(v, prefix + k + "/"))
            else:
                out[prefix + k] = v.detach().numpy()
        return out

    if rank == 0:
        np.savez(out_path, loss=np.float32(float(loss)),
                 **flatten(params, "p/"), **flatten(stats, "s/"))

    # allgather: ragged dim 0, rank order; the reference's mismatch errors.
    got = hvd.allgather(torch.full((rank + 1, 3), float(rank)))
    assert torch.equal(got, torch.tensor([[0.0] * 3, [1.0] * 3, [1.0] * 3]))
    h = hvd.allgather_async(torch.arange(2 * rank, dtype=torch.int32))
    assert torch.equal(hvd.synchronize(h),
                       torch.tensor([0, 1], dtype=torch.int32))
    with pytest.raises(ValueError, match="dimension 1 equal to 3"):
        hvd.allgather(torch.zeros(1, 3 + rank))
    with pytest.raises(ValueError, match="Mismatched data types"):
        hvd.allgather(torch.zeros(1, dtype=(torch.float32, torch.int64)[rank]))
    with pytest.raises(ValueError, match="rank-zero tensor"):
        hvd.allgather(torch.tensor(1.0))
    # Objects.
    objs = hvd.allgather_object({"rank": rank, "pad": "x" * (100 * rank)})
    assert [o["rank"] for o in objs] == [0, 1] and len(objs[1]["pad"]) == 100
    assert hvd.broadcast_object({"from": rank} if rank == 1 else None,
                                root_rank=1) == {"from": 1}
    # shard_local_batch: each rank's own rows; unequal counts raise on both.
    local = hvd.shard_local_batch((np.full((2, 3), rank, "float32"),))
    assert torch.equal(local[0], torch.full((2, 3), float(rank)))
    with pytest.raises(ValueError, match="different row counts"):
        hvd.shard_local_batch(np.zeros((2 + rank, 3), "float32"))
    hvd.barrier()
    hvd.shutdown()
    dist.destroy_process_group()
    print("WORKER_OK", rank)
""")


def _run_two_ranks(tmp_path, script_text, *args):
    script = tmp_path / "worker.py"
    script.write_text(script_text)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    env.pop("RANK", None)
    env.pop("WORLD_SIZE", None)
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), store,
                               *args], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
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
    return outs


def _flatten(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_two_gloo_ranks_match_reference_on_two_devices(tmp_path, hvd2):
    model, p, s = _reference_resnet(False, "f32")
    x, y = jr.synthetic_imagenet(8, image_size=33, num_classes=10, seed=3)
    data, out = tmp_path / "data.npz", tmp_path / "out.npz"
    np.savez(data, x=x, y=y, **_flatten(p, "p/"), **_flatten(s, "s/"))
    _run_two_ranks(tmp_path, WORKER, str(data), str(out))

    # Reference: two devices, four rows each, the same global batch.
    opt = optax.sgd(0.1, momentum=0.9)
    step = jtrain.make_train_step_with_state(jr.resnet_loss_fn(model), opt,
                                             donate=False)
    params, stats = jax.tree_util.tree_map(jnp.asarray, (p, s))
    params, stats, _, loss = step(params, stats, opt.init(params),
                                  jtrain.shard_batch((x, y)))
    got = np.load(out)
    assert abs(float(got["loss"]) - float(loss)) < 1e-5
    for prefix, tree in (("p/", params), ("s/", stats)):
        want = _flatten(_np(tree), prefix)
        assert sorted(k for k in got.files if k.startswith(prefix)) \
            == sorted(want)
        for k, v in want.items():
            assert float(np.max(np.abs(got[k] - v))) < 1e-4, k


def test_chip_smoke_runs_a_resnet_phase_after_the_trainer():
    sys.path.insert(0, REPO)
    import chip_smoke

    assert "resnet" in chip_smoke.PHASES
    assert chip_smoke.PHASES.index("resnet") > chip_smoke.PHASES.index(
        "trainer")
    assert "resnet" in chip_smoke.__doc__
    # The LR sequence the phase checks, against the callbacks' formula at
    # size 2: the warm-up's first batch is (1/2)(1/8 + 1) of the base.
    seq = chip_smoke.expected_lr_sequence(0.1, 2, epochs=3, steps=8)
    assert seq[0][0] == pytest.approx(0.1 / 2 * (1 / 8 + 1))
    assert seq[16] == pytest.approx((0.01, 0.9 * 0.1))
